"""Sewing-pattern specification library (host-side, pure numpy).

The port's copy of garment_pattern_estimation_tpu/core/pattern_spec.py:1-227;
`serialize` writes the spec without the rendered images (the JAX package's
`core/render.py` needs matplotlib).

Owns the ``specification.json`` format and the geometric helpers that the
reference imports from the external Garment-Pattern-Generator package
(``pattern.core``, ``pattern.wrappers.VisPattern`` — used at
nn/data/pattern_converter.py:13-15). A pattern is a set of *panels* (closed
loops of edges in a local 2D frame, with optional quadratic-Bezier curvature
per edge and a 3D placement: euler rotation in degrees + translation) plus a
list of *stitches* (pairs of (panel, edge) references).

Spec layout::

    {
      "pattern": {
        "panels": {
          "<name>": {
            "vertices": [[x, y], ...],
            "edges": [{"endpoints": [i, j], "curvature": [cx, cy]?}, ...],
            "rotation": [rx, ry, rz],          # degrees, Maya xyz convention
            "translation": [tx, ty, tz]
          }, ...
        },
        "stitches": [[{"panel": p, "edge": e}, {"panel": q, "edge": f}], ...],
        "panel_order": ["<name>", ...]
      },
      "parameters": {...},      # design-parameter values (pass-through)
      "parameter_order": [...],
      "properties": {...}       # units, normalization flags
    }

Curvature is "relative": the Bezier control point of an edge from vertex A to
vertex B with curvature (cx, cy) sits at ``A + cx * (B - A) + cy * perp(B - A)``
(same convention the reference metrics use — nn/metrics/metrics.py:259-281).

Units are centimeters throughout (reference: pattern_converter.py:131-136).
"""
from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np

from . import rotations as rot_tools

# Template for a fresh empty panel (reference counterpart: pattern.core.panel_spec_template)
panel_spec_template = {
    'translation': [0.0, 0.0, 0.0],
    'rotation': [0.0, 0.0, 0.0],
    'vertices': [],
    'edges': [],
}

# Template for a fresh empty pattern spec
pattern_spec_template = {
    'pattern': {
        'panels': {},
        'stitches': [],
        'panel_order': [],
    },
    'parameters': {},
    'parameter_order': [],
    'properties': {
        'curvature_coords': 'relative',
        'normalize_panel_translation': False,
        'normalized_edge_loops': True,
        'units_in_meter': 100,  # cm
    },
}


class PatternSpec:
    """Load/manipulate/serialize a sewing-pattern specification."""

    def __init__(self, pattern_file=None, view_ids=False):
        self.view_ids = view_ids
        self.spec_file = Path(pattern_file) if pattern_file is not None else None

        if pattern_file is not None:
            with open(pattern_file, 'r') as f:
                self.spec = json.load(f)
            self.name = self.name_from_path(pattern_file)
        else:
            self.spec = copy.deepcopy(pattern_spec_template)
            self.name = 'pattern'

        # convenience references into the spec
        self.pattern = self.spec['pattern']
        self.parameters = self.spec.setdefault('parameters', {})
        self.properties = self.spec.setdefault('properties', {})
        self.pattern.setdefault('stitches', [])
        self.pattern.setdefault('panels', {})

    # ------------- naming -------------
    @staticmethod
    def name_from_path(pattern_file):
        """Datapoint name for a spec file: the containing folder when the file
        is a '*specification*' file inside a datapoint folder, else the stem."""
        path = Path(pattern_file)
        if 'specification' in path.stem:
            return path.parent.name
        return path.stem

    # ------------- panel order -------------
    def panel_order(self, force_update=False):
        """Panel traversal order: as stored in the spec, or a deterministic
        location-based order when none is stored (or an update is forced)."""
        if force_update or not self.pattern.get('panel_order'):
            self.pattern['panel_order'] = self.define_panel_order()
        return self.pattern['panel_order']

    def define_panel_order(self):
        """Deterministic fallback ordering: sort panels by the universal
        translation of their top-mid point (x, then z, then y), then name."""
        def sort_key(panel_name):
            location, _ = self._panel_universal_transtation(panel_name)
            return (round(location[0], 3), round(location[2], 3), round(location[1], 3), panel_name)

        return sorted(self.pattern['panels'], key=sort_key)

    # ------------- geometry helpers -------------
    @staticmethod
    def _edge_as_vector(vertices, edge):
        """Edge as 4-vector: 2D (end - start) + 2 relative curvature coords."""
        vertices = np.asarray(vertices, dtype=float)
        start, end = edge['endpoints']
        edge_vector = vertices[end] - vertices[start]
        curvature = np.asarray(edge.get('curvature', [0.0, 0.0]), dtype=float)
        return np.concatenate([edge_vector, curvature])

    @staticmethod
    def _point_in_3D(local_coord_2d, rotation, translation):
        """Panel-local 2D point -> world 3D. `rotation` is either euler degrees
        (len-3) or a 3x3 matrix."""
        rotation = np.asarray(rotation, dtype=float)
        if rotation.shape == (3,):
            rotation = rot_tools.euler_xyz_to_matrix(rotation)
        point_3d = rotation @ np.array([local_coord_2d[0], local_coord_2d[1], 0.0])
        return point_3d + np.asarray(translation, dtype=float)

    def _panel_universal_transtation(self, panel_name):
        """'Universal' panel translation: the world position of the mid-point
        of the top edge of the panel's 2D bounding box (stable across designs).
        Returns (3D world point, 2D local offset of that point).
        (Name intentionally mirrors the reference's misspelled API —
        pattern_converter.py:221.)"""
        panel = self.pattern['panels'][panel_name]
        vertices = np.asarray(panel['vertices'], dtype=float)
        top_right = vertices.max(axis=0)
        low_left = vertices.min(axis=0)
        top_mid_2d = np.array([(top_right[0] + low_left[0]) / 2.0, top_right[1]])
        top_mid_3d = self._point_in_3D(top_mid_2d, panel['rotation'], panel['translation'])
        return top_mid_3d, top_mid_2d

    def _invalidate_all_values(self):
        """Drop design-parameter values: after numeric edits they no longer
        describe the geometry."""
        for param in self.parameters.values():
            if isinstance(param, dict) and 'value' in param:
                param['value'] = None

    # ------------- panel vertex utilities -------------
    def panel_vertices_3d(self, panel_name):
        """All panel vertices placed in 3D world coordinates."""
        panel = self.pattern['panels'][panel_name]
        rot_matrix = rot_tools.euler_xyz_to_matrix(panel['rotation'])
        vertices = np.asarray(panel['vertices'], dtype=float)
        return np.stack([
            self._point_in_3D(vertices[i], rot_matrix, panel['translation'])
            for i in range(len(vertices))
        ])

    # ------------- serialization -------------
    def serialize(self, path, to_subfolder=True, tag='', with_3d_info=False):
        """Write the spec to `path` (the rendered images are not ported).

        Returns the directory the files were written into.
        File naming matches what the reference pipeline greps for:
        ``<name><tag>_specification.json`` and ``<name><tag>_pattern.png``
        (see nn/data/datasets.py:699-704, 1109-1115).
        """
        path = Path(path)
        if to_subfolder:
            final_dir = path / self.name
        else:
            final_dir = path
        final_dir.mkdir(parents=True, exist_ok=True)

        spec_file = final_dir / f'{self.name}{tag}_specification.json'
        with open(spec_file, 'w') as f:
            json.dump(self.spec, f, indent=2, default=_json_default)

        return str(final_dir)

    # ------------- misc -------------
    def is_self_intersecting(self):
        """Quick validity probe: checks every panel loop is closed."""
        for panel_name, panel in self.pattern['panels'].items():
            verts = np.asarray(panel['vertices'], dtype=float)
            if len(verts) < 3:
                return True
        return False

    def __len__(self):
        return len(self.pattern['panels'])


def _json_default(obj):
    """JSON encoder hook for numpy scalars/arrays leaking into specs."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    raise TypeError(f'Object of type {type(obj)} is not JSON serializable')
