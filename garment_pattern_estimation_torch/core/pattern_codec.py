"""NN tensor codec for sewing patterns (numpy, host-side).

Behavioral counterpart of the reference's ``NNSewingPattern``
(nn/data/pattern_converter.py:35-611), framework-free: tensors are numpy
arrays and the stitch classifier is passed as a plain callable, so the codec
works identically under JAX, tests, and CLI tools.

Tensor conventions (all sizes are padded maxima):
  * outlines:      (num_panels, num_edges, 4)  — additive 2D edge vector + 2 curvature coords
  * rotations:     (num_panels, 4)             — quaternion (x, y, z, w)
  * translations:  (num_panels, 3)             — 'universal' top-mid-bbox world point
  * stitches:      (2, num_stitches) int       — pattern-level edge ids `panel_id * max_edges + edge_id`;
                                                  padded entries are (0, 0)
  * stitch tags:   (num_panels, num_edges, 3)  — per-edge approximate 3D stitch location, zeros on free edges

The port's copy of garment_pattern_estimation_tpu/core/pattern_codec.py:1-466.
"""
from __future__ import annotations

import copy

import numpy as np

from . import rotations as rot_tools
from .pattern_spec import PatternSpec, panel_spec_template


class EmptyPanelError(Exception):
    pass


class InvalidPatternDefError(Exception):
    """The given pattern definition (e.g. numeric representation) is not
    self-consistent — e.g. stitches referring to non-existing edges."""

    def __init__(self, pattern_name='', message=''):
        self.message = f'Pattern {pattern_name} is invalid'
        if message:
            self.message += ': ' + message
        super().__init__(self.message)


class NNSewingPattern(PatternSpec):
    """Sewing pattern with NN-friendly tensor encode/decode."""

    def __init__(self, pattern_file=None, view_ids=False, panel_classifier=None, template_name=None):
        self.panel_classifier = panel_classifier
        self.template_name = template_name
        super().__init__(pattern_file=pattern_file, view_ids=view_ids)

    # ------------------- panel ordering -------------------
    def panel_order(self, force_update=False, pad_to_len=None):
        """Panel order for tensor encoding.

        With a panel classifier + template name, panels sit at their class
        index and missing classes are `None` placeholders (empty panels);
        otherwise the spec's stored order is used. Optionally right-pads
        with `None` to `pad_to_len` (reference: pattern_converter.py:575-611).
        """
        if self.panel_classifier is None or self.template_name is None:
            slots = super().panel_order(force_update=force_update)
        else:
            slots = [None] * len(self.panel_classifier)
            for name in self.pattern['panels']:
                slots[self.panel_classifier.class_idx(
                    self.template_name, name)] = name

        if pad_to_len is not None:
            if pad_to_len < len(slots):
                raise ValueError(
                    f'{self.__class__.__name__}::{self.name}::Error::requested max num of panels '
                    f'{pad_to_len} is smaller than evaluated number of panels {len(slots)}')
            slots = slots + [None] * (pad_to_len - len(slots))

        self.pattern['panel_order'] = slots
        return slots

    # ------------------- pattern -> tensors -------------------
    def pattern_as_tensors(self, pad_panels_to_len=None, pad_panels_num=None, pad_stitches_num=None,
                           with_placement=False, with_stitches=False, with_stitch_tags=False):
        """Encode the pattern as padded numpy tensors (see module docstring).

        Returns (outlines, num_edges_per_panel, num_panels[, rotations,
        translations][, stitches, num_stitches][, stitch_tags]).
        """
        slots = self.panel_order(pad_to_len=pad_panels_num)
        edge_counts = np.array([
            0 if name is None else len(self.pattern['panels'][name]['edges'])
            for name in slots])
        row_len = pad_panels_to_len if pad_panels_to_len is not None \
            else int(edge_counts.max())

        encoded = [self.panel_as_numeric(name, pad_to_len=row_len)
                   if name is not None else self._empty_panel(row_len)
                   for name in slots]
        outlines, quats, transls = (np.stack(part) for part in zip(*encoded))

        stitch_specs = self.pattern['stitches']
        capacity = len(stitch_specs) if pad_stitches_num is None else pad_stitches_num
        if capacity < len(stitch_specs):
            raise ValueError(
                f'{self.__class__.__name__}::Error::requested number of stitches {capacity} '
                f'is less than the number of stitches {len(stitch_specs)} in pattern {self.name}')

        # flat pattern-level edge id per stitch side: slot * row_len + edge.
        # Zero-padded so the array can be used directly for indexing (callers
        # must mask the padded tail themselves)
        stitch_ids = np.zeros((2, capacity), dtype=np.int64)
        slot_of = {name: s for s, name in enumerate(slots) if name is not None}
        sides = np.array([[slot_of[side['panel']], side['edge']]
                          for stitch in stitch_specs for side in stitch],
                         dtype=np.int64).reshape(-1, 2, 2)  # (S, side, [slot, edge])
        if len(sides):
            stitch_ids[:, :len(sides)] = \
                (sides[..., 0] * row_len + sides[..., 1]).T
        if with_stitch_tags:
            tags_per_edge = np.zeros((len(slots), row_len, 3))
            if len(sides):
                tags = self.stitches_as_tags()
                flat_sides = sides.reshape(-1, 2)
                tags_per_edge[flat_sides[:, 0], flat_sides[:, 1]] = \
                    np.repeat(tags, 2, axis=0)

        result = [outlines, edge_counts, len(self.pattern['panels'])]
        if with_placement:
            result += [quats, transls]
        if with_stitches:
            result += [stitch_ids, len(stitch_specs)]
        if with_stitch_tags:
            result.append(tags_per_edge)
        return tuple(result) if len(result) > 1 else result[0]

    def panel_as_numeric(self, panel_name, pad_to_len=None):
        """One panel as (edge sequence, quaternion, universal translation).

        Edges are additive vectors (each is the step from the previous vertex),
        so the sequence is origin-free; rotation is the panel euler rotation as
        an (x, y, z, w) quaternion; translation is the world position of the
        top-mid bounding-box point (reference: pattern_converter.py:189-226).
        """
        panel = self.pattern['panels'][panel_name]
        corners = np.asarray(panel['vertices'], dtype=float)
        rows = np.stack([self._edge_as_vector(corners, edge)
                         for edge in panel['edges']])

        if pad_to_len is not None:
            if len(rows) > pad_to_len:
                raise ValueError(
                    f'{self.__class__.__name__}::{self.name}::panel {panel_name} cannot fit into '
                    f'requested length: {len(rows)} edges to fit into {pad_to_len}')
            rows = np.pad(rows, ((0, pad_to_len - len(rows)), (0, 0)))

        top_mid_point, _ = self._panel_universal_transtation(panel_name)
        return rows, rot_tools.euler_xyz_to_quat(panel['rotation']), top_mid_point

    @staticmethod
    def _empty_panel(max_edge_num):
        """Placeholders for an absent panel class slot."""
        return np.zeros((max_edge_num, 4)), np.zeros(4), np.zeros(3)

    # ------------------- tensors -> pattern -------------------
    def pattern_from_tensors(self, pattern_representation, panel_rotations=None,
                             panel_translations=None, stitches=None, padded=False):
        """Rebuild the spec from (possibly padded) tensors. Units are cm.

        Mirrors the decode conventions of pattern_converter.py:118-187:
        panels with <3 non-padding edges are dropped; stitch entries (0, 0)
        are padding; stitches referring to dropped panels raise
        InvalidPatternDefError.
        """
        self._invalidate_all_values()
        self.properties.update(
            curvature_coords='relative',
            normalize_panel_translation=False,
            normalized_edge_loops=True,
            units_in_meter=100,  # cm
        )

        n_slots = len(pattern_representation)
        self.pattern['panels'] = {}
        kept_names = []
        name_of_slot = [None] * n_slots  # slot -> surviving panel name
        for slot in range(n_slots):
            name = f'panel_{slot}' if self.panel_classifier is None \
                else self.panel_classifier.class_name(slot)
            try:
                self.panel_from_numeric(
                    name, pattern_representation[slot],
                    rotation=None if panel_rotations is None else panel_rotations[slot],
                    translation=None if panel_translations is None
                    else panel_translations[slot],
                    padded=padded)
            except EmptyPanelError:
                continue  # empty slot in a padded pattern — move on
            kept_names.append(name)
            name_of_slot[slot] = name

        self.pattern['panel_order'] = kept_names

        self.pattern['stitches'] = []
        if stitches is None or len(stitches) == 0:
            print(f'{self.__class__.__name__}::Warning::{self.name}::panels updated but new stitches '
                  'info was not provided. Stitches are removed.')
            return
        if not padded:
            raise NotImplementedError(
                f'{self.__class__.__name__}::recovering stitches for unpadded pattern is not supported')

        row_len = pattern_representation.shape[1]
        for s, (a, b) in enumerate(np.asarray(stitches).T):
            if a == 0 and b == 0:
                continue  # padding
            entry = []
            for flat_id in (int(a), int(b)):
                slot = flat_id // row_len
                if slot >= n_slots or name_of_slot[slot] is None:
                    raise InvalidPatternDefError(
                        self.name, f'stitch {s} refers to non-existing panel {slot}')
                entry.append({'panel': name_of_slot[slot],
                              'edge': int(flat_id % row_len)})
            self.pattern['stitches'].append(entry)

    def panel_from_numeric(self, panel_name, edge_sequence, rotation=None, translation=None, padded=False):
        """Rebuild one panel from its (possibly padded) edge sequence.

        First vertex at origin; the loop is closed onto the origin when the
        final vertex lands within 3 cm per coordinate, otherwise an extra
        vertex is created (reference: pattern_converter.py:228-288).
        """
        steps = np.asarray(edge_sequence, dtype=float)
        if padded:
            steps = steps[~np.all(np.isclose(steps, 0, atol=1.5), axis=1)]
            if len(steps) < 3:
                raise EmptyPanelError(
                    f'{self.__class__.__name__}::EmptyPanelError::supplied <{panel_name}> is empty')

        self.pattern['panels'].setdefault(
            panel_name, copy.deepcopy(panel_spec_template))

        # walk the additive edge vectors from the origin; the running sums
        # ARE the vertex positions (vertex i+1 = vertex i + step i)
        corners = np.vstack([np.zeros((1, 2)), np.cumsum(steps[:, :2], axis=0)])
        n = len(steps)
        loop = [self._edge_dict(i, i + 1, steps[i, 2:4]) for i in range(n - 1)]

        # closing edge: snap onto the origin when within 3 cm per coordinate
        if np.all(np.isclose(corners[-1], 0, atol=3)):
            corners = corners[:-1]
            loop.append(self._edge_dict(n - 1, 0, steps[-1, 2:4]))
        else:
            print(f'{self.__class__.__name__}::Warning::{self.name} panel {panel_name}::edge sequence '
                  'does not return to origin. Creating extra vertex')
            loop.append(self._edge_dict(n - 1, n, steps[-1, 2:4]))

        panel = self.pattern['panels'][panel_name]
        panel['vertices'] = corners.tolist()
        panel['edges'] = loop

        if rotation is not None:
            panel['rotation'] = rot_tools.quat_to_euler_xyz(rotation).tolist()

        if translation is not None:
            # incoming translation is of the 3D top-mid point ('universal');
            # convert back to the panel-origin translation
            _, origin_2d = self._panel_universal_transtation(panel_name)
            offset = rot_tools.euler_xyz_to_matrix(panel['rotation']) \
                @ np.append(origin_2d, 0)
            panel['translation'] = (
                np.asarray(translation, dtype=float) - offset).tolist()

    @staticmethod
    def _edge_dict(vstart, vend, curvature):
        """Edge spec entry; curvature key only present when non-negligible."""
        edge_dict = {'endpoints': [int(vstart), int(vend)]}
        curvature = np.asarray(curvature, dtype=float)
        if not np.all(np.isclose(curvature, 0, atol=0.01)):
            edge_dict['curvature'] = curvature.tolist()
        return edge_dict

    # ------------------- stitch tags -------------------
    def stitches_as_tags(self):
        """Per-stitch 3D tag: the mean of the two participating edges' 3D
        midpoints — an approximate world location of the stitch
        (reference: pattern_converter.py:290-319)."""
        def side_midpoint_3d(side):
            panel = self.pattern['panels'][side['panel']]
            a, b = panel['edges'][side['edge']]['endpoints']
            mid = (np.asarray(panel['vertices'][a], dtype=float)
                   + np.asarray(panel['vertices'][b], dtype=float)) / 2
            return self._point_in_3D(mid, panel['rotation'], panel['translation'])

        return np.array([
            (side_midpoint_3d(stitch[0]) + side_midpoint_3d(stitch[1])) / 2
            for stitch in self.pattern['stitches']])

    # ------------------- 3D edge pairs (stitch model IO) -------------------
    def _3D_edges_per_panel(self, randomize_direction=False, rng=None):
        """All edges as 8-float features (two 3D endpoints + 2 curvature),
        grouped per panel; optionally flips edge directions at random
        (with matching curvature flip cx -> 1-cx, cy -> -cy)."""
        if randomize_direction and rng is None:
            rng = np.random.default_rng()

        def featurize(ends_3d, spec):
            curve = np.array(spec['curvature'], dtype=float) \
                if 'curvature' in spec else np.zeros(2)
            if randomize_direction and rng.integers(2):
                ends_3d = ends_3d[::-1]
                # flipping an edge mirrors its control point: cx -> 1-cx
                # (unless zero), cy -> -cy
                curve = np.array([1 - curve[0] if curve[0] else 0, -curve[1]])
            return np.concatenate([np.ravel(ends_3d), curve])

        features = {}
        for name in self.panel_order():
            if name is None:
                continue
            placed = self.panel_vertices_3d(name)
            features[name] = [
                featurize(placed[spec['endpoints']], spec)
                for spec in self.pattern['panels'][name]['edges']]
        return features

    def stitches_as_3D_pairs(self, stitch_pairs_num=None, non_stitch_pairs_num=None,
                             randomize_edges=False, randomize_list_order=False, rng=None):
        """Training pairs for the stitch classifier: all stitched pairs (with
        duplication up to `stitch_pairs_num`) + random non-stitched pairs.
        Each pair is a 16-float vector; returns (pairs, bool mask)."""
        if stitch_pairs_num is not None and stitch_pairs_num < len(self.pattern['stitches']):
            raise ValueError(
                f'{self.__class__.__name__}::{self.name}::Error::requested fewer edge pairs '
                f'({stitch_pairs_num}) than there are stitches ({len(self.pattern["stitches"])})')
        if rng is None:
            rng = np.random.default_rng()

        features = self._3D_edges_per_panel(randomize_edges, rng=rng)

        rows, labels = [], []
        known_stitched = set()
        for stitch in self.pattern['stitches']:
            key = tuple((side['panel'], side['edge']) for side in stitch)
            try:
                halves = [features[p][e] for p, e in key]
            except IndexError:
                # can happen on (incorrectly) predicted panels
                print(f'Warning::{self.name}::missing edge while constructing stitch pairs')
                continue
            if randomize_edges and rng.integers(2):
                halves.reverse()
            rows.append(np.concatenate(halves))
            labels.append(True)
            known_stitched.add(key)

        # duplication needs at least one constructed pair: if every stitch hit
        # the missing-edge path above (badly predicted panels), fall through —
        # the non-stitched top-up below compensates for the shortfall
        n_real = len(known_stitched)
        if stitch_pairs_num is not None and 0 < n_real < stitch_pairs_num:
            rows += [rows[rng.integers(n_real)]
                     for _ in range(stitch_pairs_num - n_real)]
            labels += [True] * (stitch_pairs_num - n_real)

        if non_stitch_pairs_num is not None:
            candidates = [p for p in self.panel_order() if p is not None]
            if stitch_pairs_num is not None and len(rows) < stitch_pairs_num:
                non_stitch_pairs_num += stitch_pairs_num - len(rows)

            def draw_side():
                panel = candidates[rng.integers(len(candidates))]
                edge = int(rng.integers(
                    len(self.pattern['panels'][panel]['edges'])))
                return panel, edge

            for _ in range(non_stitch_pairs_num):
                while True:  # rejection-sample a genuinely unstitched pair
                    key = (draw_side(), draw_side())
                    if key[0] == key[1] or key in known_stitched \
                            or key[::-1] in known_stitched:
                        continue
                    rows.append(np.concatenate(
                        [features[p][e] for p, e in key]))
                    labels.append(False)
                    break

        rows = np.stack(rows)
        labels = np.array(labels, dtype=bool)
        if randomize_list_order:
            order = rng.permutation(len(rows))
            return rows[order], labels[order]
        return rows, labels

    def all_edge_pairs(self):
        """Exhaustive cross-panel edge pairs (upper triangle of the panel
        grid; panels never stitch to themselves). Returns
        (pairs [M, 16], pair id mapping, GT stitched mask)."""
        import itertools

        features = {name: np.array(rows) for name, rows
                    in self._3D_edges_per_panel().items()}
        present = [p for p in self.panel_order() if p is not None]
        stitched = self._stitches_as_set()

        blocks, pair_keys = [], []
        for left, right in itertools.combinations(present, 2):
            a, b = features[left], features[right]
            grid_a, grid_b = np.indices((len(a), len(b)))
            blocks.append(np.concatenate(
                [a[grid_a], b[grid_b]], axis=-1).reshape(len(a) * len(b), -1))
            pair_keys += [((left, ia), (right, ib))
                          for ia in range(len(a)) for ib in range(len(b))]

        if not blocks:
            raise InvalidPatternDefError(self.name, 'No edges to construct')
        is_stitched = [key in stitched or key[::-1] in stitched
                       for key in pair_keys]
        return np.concatenate(blocks).astype(np.float32), pair_keys, is_stitched

    def _stitches_as_set(self):
        return {
            ((s[0]['panel'], s[0]['edge']), (s[1]['panel'], s[1]['edge']))
            for s in self.pattern['stitches']
        }

    # ------------------- stitches from a classifier -------------------
    def stitches_from_pair_classifier(self, predict_logits, data_stats):
        """Set this pattern's stitches from a pair-classifier.

        `predict_logits`: callable mapping standardized pairs (M, 16) numpy ->
        logits (M,) numpy. Edges participating in multiple predicted stitches
        keep only the highest-scoring one (reference:
        pattern_converter.py:411-456)."""
        self.pattern['stitches'] = []  # cleared even if no pairs exist below
        pairs, pair_keys, _ = self.all_edge_pairs()
        standardized = (pairs - np.asarray(data_stats['f_shift'], np.float32)) \
            / np.asarray(data_stats['f_scale'], np.float32)
        logits = np.asarray(predict_logits(standardized)).reshape(-1)

        positives = np.flatnonzero(
            np.round(1.0 / (1.0 + np.exp(-logits))) > 0)
        accepted = [
            self._stitch_entry(*pair_keys[i][0], *pair_keys[i][1],
                               score=float(logits[i]))
            for i in positives]

        # deduplicate: an edge may participate in at most one stitch.
        # NOTE: already-marked stitches keep participating in later
        # comparisons (a removed stitch can still knock out its weaker
        # conflicts) — this mirrors the reference's loop exactly
        # (pattern_converter.py:440-456), quirk included, for parity
        losers = set()
        for i, candidate in enumerate(accepted):
            for mine in candidate:
                for j in range(i + 1, len(accepted)):
                    other = accepted[j]
                    if any(mine['panel'] == o['panel']
                           and mine['edge'] == o['edge'] for o in other):
                        losers.add(
                            i if candidate[0]['score'] < other[0]['score']
                            else j)
        self.pattern['stitches'] = [
            s for i, s in enumerate(accepted) if i not in losers]

    @staticmethod
    def _stitch_entry(panel_1, edge_1, panel_2, edge_2, score=None):
        return [
            {'panel': panel_1, 'edge': int(edge_1), 'score': score},
            {'panel': panel_2, 'edge': int(edge_2), 'score': score},
        ]
