"""Garment datasets: folder scanning, caching, splits, standardization,
feature/GT assembly, prediction saving.

The port's copy of garment_pattern_estimation_tpu/data/datasets.py:32-785
(numpy inside, so every sample is bitwise the JAX package's; tensors appear
only where `loader.default_collate` stacks a batch). Behavioral counterpart
of nn/data/datasets.py on a numpy pipeline:
  * BaseDataset — folder-of-subfolders scan, per-folder start ids, caches,
    transform pipeline, random/count/dict splits
  * GarmentBaseDataset — failed-sim filtering via dataset_properties.json,
    template nicknames, design-parameter filtering, size inference
  * Garment3DPatternFullDataset — point-cloud features (sampled via the
    native preprocessing library, deterministic per datapoint), padded
    pattern GT dict, standardization stats, prediction -> spec saving

`GarmentStitchPairsDataset` (the stitch model's) and on-device sampling
(`on_device_sampling`) are not ported: the latter raises.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path

import numpy as np

from ..core import NNSewingPattern, PanelClasses, Properties, InvalidPatternDefError
from ..preprocess import mesh as mesh_ops
from ..losses.stitches import tags_to_stitches_np
from . import transforms
from .loader import Subset


class BaseDataset:
    """Folder-of-subfolders dataset base: datapoint listing, caching,
    transform pipeline, splits (reference: nn/data/datasets.py:20-338)."""

    def __init__(self, root_dir, start_config=None, gt_caching=False,
                 feature_caching=False, in_transforms=None):
        self.root_path = Path(root_dir)
        self.config = {}
        self.update_config(dict(start_config or {'data_folders': []}))
        self.config['class'] = self.__class__.__name__

        self.data_folders = self.config['data_folders']
        self.data_folders_nicknames = {f: f for f in self.data_folders}

        self.datapoints_names, self.dataset_start_ids = self._scan_folders()
        self.config['size'] = len(self)

        self.gt_cached, self.gt_caching = {}, gt_caching
        self.feature_cached, self.feature_caching = {}, feature_caching

        self.transforms = [transforms.SampleToTensor()] + list(in_transforms or [])

        if 'standardize' in self.config:
            self.standardize()

        self._estimate_data_shape()

    def _scan_folders(self):
        """Enumerate datapoint dirs per folder (sorted), run the subclass
        cleaning hook, apply the per-type cap. Returns (names,
        [(folder, first global id)] + (None, total) sentinel)."""
        names, first_ids = [], []
        cap = self.config.get('max_datapoints_per_type')
        for folder in self.data_folders:
            folder_path = self.root_path / folder
            if not folder_path.is_dir():
                raise FileNotFoundError(
                    f'{self.__class__.__name__}::Error::data folder '
                    f'<{folder_path}> does not exist')
            found = [f'{folder}/{d.name}' for d in sorted(folder_path.iterdir())
                     if d.is_dir()]
            first_ids.append((folder, len(names)))
            kept = self._clean_datapoint_list(found, folder)
            names += kept if cap is None else kept[:cap]
        first_ids.append((None, len(names)))
        return names, first_ids

    # ---- experiment hook ----
    def save_to_wandb(self, experiment):
        """Record the data configuration into the experiment tracker.
        (Name kept from the reference API; works with the local tracker.)"""
        experiment.add_config('dataset', self.config)

    # ---- core protocol ----
    def __len__(self):
        return len(self.datapoints_names)

    def __getitem__(self, idx):
        datapoint_name = self.datapoints_names[idx]
        features, ground_truth = self._get_sample_info(datapoint_name)
        folder, name = datapoint_name.split('/')
        sample = {'features': features, 'ground_truth': ground_truth,
                  'name': name, 'data_folder': folder}
        for transform in self.transforms:
            sample = transform(sample)
        return sample

    def update_config(self, in_config):
        self.config.update(in_config)
        if not self.config.get('data_folders') or not isinstance(
                self.config['data_folders'], list):
            raise RuntimeError(
                'BaseDataset::Error::information on datasets (folders) to use '
                'is missing in the incoming config')
        self._update_on_config_change()

    def _drop_cache(self):
        self.gt_cached = {}
        self.feature_cached = {}

    def warm_cache(self, workers=None, indices=None):
        """Fill the feature/GT caches with a parallel preprocessing pool —
        the native-thread analog of the reference's DataLoader workers
        (torch multiprocessing behind nn/data/wrapper.py loaders).

        The per-sample hot path (OBJ parse, barycentric surface sampling,
        nearest-vertex label snap) runs in the C++ extension through ctypes,
        which releases the GIL — a thread pool preprocesses truly in parallel
        on multi-core hosts, without torch's worker-process serialization.
        Per-sample RNG seeds derive from datapoint names, so the cache
        contents are identical to the lazy path regardless of completion
        order. No-op unless caching is enabled. Returns the number of
        samples assembled."""
        if not (self.feature_caching or self.gt_caching):
            return 0
        names = self.datapoints_names if indices is None \
            else [self.datapoints_names[int(i)] for i in indices]
        pending = [n for n in dict.fromkeys(names)
                   if (self.feature_caching and n not in self.feature_cached)
                   or (self.gt_caching and n not in self.gt_cached)]
        if not pending:
            return 0
        workers = workers or min(8, os.cpu_count() or 1)
        if workers <= 1:
            for name in pending:
                self._get_sample_info(name)
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=workers) as pool:
                # consume the iterator so worker exceptions surface here
                for _ in pool.map(self._get_sample_info, pending):
                    pass
        return len(pending)

    # ---- split machinery ----
    def indices_by_data_folder(self, index_list):
        """Split given global indices per data folder. Returns
        ({folder: global ids}, {folder: positions within index_list})."""
        index_list = np.asarray(index_list)
        ids_dict, mapping = {}, {}
        self.dataset_start_ids = sorted(self.dataset_start_ids, key=lambda x: x[1])
        for i in range(len(self.dataset_start_ids) - 1):
            folder = self.dataset_start_ids[i][0]
            lo, hi = self.dataset_start_ids[i][1], self.dataset_start_ids[i + 1][1]
            selection = (index_list >= lo) & (index_list < hi)
            ids_dict[folder] = index_list[selection]
            mapping[folder] = np.flatnonzero(selection)
        return ids_dict, mapping

    def subsets_per_datafolder(self, index_list=None):
        if index_list is None:
            index_list = list(range(len(self)))
        per_data, _ = self.indices_by_data_folder(index_list)
        return {
            self.data_folders_nicknames[folder]: Subset(self, ids)
            for folder, ids in per_data.items()
        }

    def random_split_by_dataset(self, valid_per_type, test_per_type=0,
                                split_type='count', with_breakdown=False, rng=None):
        """Per-folder random split by count or percent
        (reference: nn/data/datasets.py:180-244)."""
        if split_type not in ('count', 'percent'):
            raise NotImplementedError(
                f'{self.__class__.__name__}::Error::unsupported split type {split_type}')
        rng = rng or np.random.default_rng()

        picked = {'train': [], 'valid': [], 'test': []}
        folder_subsets = {'train': {}, 'valid': {}, 'test': {}}
        for folder_i, folder in enumerate(self.data_folders):
            begin = self.dataset_start_ids[folder_i][1]
            size = self.dataset_start_ids[folder_i + 1][1] - begin
            shuffled = rng.permutation(size) + begin     # one draw per folder:
                                                         # seeded splits stay stable
            if split_type == 'percent':
                n_valid = int(size * valid_per_type / 100)
                n_test = int(size * test_per_type / 100)
            else:
                n_valid, n_test = valid_per_type, test_per_type or 0
            n_train = size - n_valid - n_test
            slices = np.split(shuffled, [n_train, n_train + n_valid,
                                         n_train + n_valid + n_test])[:3]

            nickname = self.data_folders_nicknames[folder]
            for section, ids in zip(('train', 'valid', 'test'), slices):
                ids = ids.tolist()
                picked[section] += ids
                folder_subsets[section][nickname] = Subset(self, ids) \
                    if (ids or section != 'test') else None

        result = (Subset(self, picked['train']), Subset(self, picked['valid']),
                  Subset(self, picked['test']) if picked['test'] else None)
        if with_breakdown:
            return result + (folder_subsets['train'], folder_subsets['valid'],
                             folder_subsets['test'])
        return result

    def split_from_dict(self, split_dict, with_breakdown=False):
        """Reproduce a frozen split from its stored name lists
        (reference: nn/data/datasets.py:246-283). A name claimed by an
        earlier section never lands in a later one (training > test >
        validation precedence)."""
        names = np.asarray(self.datapoints_names, dtype=object)
        free = np.ones(len(names), dtype=bool)
        picked = {}
        for section in ('training', 'test', 'validation'):
            member = np.isin(names, np.asarray(
                list(split_dict.get(section, [])), dtype=object)) & free
            free &= ~member
            picked[section] = np.flatnonzero(member).tolist()

        result = (Subset(self, picked['training']),
                  Subset(self, picked['validation']),
                  Subset(self, picked['test']) if picked['test'] else None)
        if with_breakdown:
            return result + tuple(
                self.subsets_per_datafolder(picked[s])
                for s in ('training', 'validation', 'test'))
        return result

    # ---- hooks for subclasses ----
    def save_prediction_batch(self, *args, **kwargs):
        print(f'{self.__class__.__name__}::Warning::no prediction saving is implemented')

    def standardize(self, training=None):
        print(f'{self.__class__.__name__}::Warning::no standardization is implemented')

    def _clean_datapoint_list(self, datapoints_names, dataset_folder):
        return datapoints_names

    def _get_sample_info(self, datapoint_name):
        return np.zeros(1, dtype=np.float32), np.zeros(1, dtype=np.float32)

    def _estimate_data_shape(self):
        elem = self[0]
        feature_size = elem['features'].shape[0]
        gt = elem['ground_truth']
        gt_size = gt.shape[0] if hasattr(gt, 'shape') else None
        self.config['feature_size'] = feature_size
        self.config['ground_truth_size'] = gt_size

    def _update_on_config_change(self):
        pass

    # ---- stats helpers ----
    @staticmethod
    def _unpad(element, tolerance=1.e-5):
        """Drop all-zero rows (padding)."""
        selection = ~np.all(np.isclose(element, 0, atol=tolerance), axis=1)
        return element[selection]

    def _get_distribution_stats(self, input_batch, padded=False):
        """(mean, std) over rows of a (..., C) stacked batch."""
        flat = np.asarray(input_batch, dtype=np.float64).reshape(-1, np.asarray(input_batch).shape[-1])
        if padded:
            flat = self._unpad(flat)
        mean = flat.mean(axis=0)
        stds = np.sqrt(((flat - mean) ** 2).sum(0) / flat.shape[0])
        return mean.astype(np.float32), stds.astype(np.float32)

    def _get_norm_stats(self, input_batch, padded=False):
        """(min, max-min) per dimension with zero-range protection."""
        flat = np.asarray(input_batch, dtype=np.float64).reshape(-1, np.asarray(input_batch).shape[-1])
        if padded:
            flat = self._unpad(flat)
        min_v, max_v = flat.min(axis=0), flat.max(axis=0)
        scale = np.empty_like(min_v)
        for i, (lo, hi) in enumerate(zip(min_v, max_v)):
            if np.isclose(lo, hi):
                scale[i] = lo if not np.isclose(lo, 0) else 1.0
            else:
                scale[i] = hi - lo
        return min_v.astype(np.float32), scale.astype(np.float32)


class GarmentBaseDataset(BaseDataset):
    """Garment-specific base: sim-failure filtering, nicknames, parameter
    filtering, max-size inference (reference: nn/data/datasets.py:341-568)."""

    def __init__(self, root_dir, start_config=None, gt_caching=False,
                 feature_caching=False, in_transforms=None):
        start_config = dict(start_config or {'data_folders': []})
        if ('max_pattern_len' not in start_config
                or 'max_panel_len' not in start_config
                or 'max_num_stitches' not in start_config):
            start_config.update(max_pattern_len=None, max_panel_len=None,
                                max_num_stitches=None)
            pattern_size_initialized = False
        else:
            pattern_size_initialized = True
        start_config.setdefault('obj_filetag', 'sim')
        start_config.setdefault('panel_classification', None)
        self.panel_classifier = None

        super().__init__(root_dir, start_config, gt_caching=gt_caching,
                         feature_caching=feature_caching, in_transforms=in_transforms)

        nicknames = list(self.data_folders_nicknames.values())
        if len(nicknames) > len(set(nicknames)):
            print(f'{self.__class__.__name__}::Warning::non-unique data folder '
                  'nicknames; reverting to original folder names')
            self.data_folders_nicknames = dict(zip(self.data_folders, self.data_folders))

        if self.config['panel_classification'] is not None:
            self.panel_classifier = PanelClasses(self.config['panel_classification'])
            self.config.update(max_pattern_len=len(self.panel_classifier))

        if not pattern_size_initialized:
            num_panels, num_edges, num_stitches = [], [], []
            sorted_ids = sorted(self.dataset_start_ids, key=lambda x: x[1])
            for (data_folder, start_id), (_, next_start) in zip(
                    sorted_ids, sorted_ids[1:]):
                if data_folder is None:
                    break
                if start_id >= next_start:
                    # every datapoint of this folder was filtered out (failed
                    # sims / parameter filter): nothing to sample a size from
                    # — and datapoints_names[start_id] would be the NEXT
                    # folder's first entry (or out of range for the last one)
                    continue
                datapoint = self.datapoints_names[start_id]
                folder_elements = [f.name for f in (self.root_path / datapoint).glob('*')]
                pattern_flat, _, _, stitches, _ = self._read_pattern(
                    datapoint, folder_elements, with_stitches=True)
                num_panels.append(pattern_flat.shape[0])
                num_edges.append(pattern_flat.shape[1])
                num_stitches.append(stitches.shape[1])
            self.config.update(max_pattern_len=max(num_panels),
                               max_panel_len=max(num_edges),
                               max_num_stitches=max(num_stitches))

        self._drop_cache()

    def save_to_wandb(self, experiment):
        super().save_to_wandb(experiment)
        for dataset_folder in self.data_folders:
            try:
                shutil.copy(self.root_path / dataset_folder / 'dataset_properties.json',
                            Path(experiment.local_artifacts_path())
                            / (dataset_folder + '_properties.json'))
            except FileNotFoundError:
                pass
        if self.panel_classifier is not None:
            shutil.copy(self.panel_classifier.filename,
                        Path(experiment.local_artifacts_path()) / 'panel_classes.json')
        if self.config.get('filter_by_params'):
            shutil.copy(self.config['filter_by_params'],
                        Path(experiment.local_artifacts_path()) / 'param_filter.json')

    # ---- cleaning & filtering ----
    def _clean_datapoint_list(self, datapoints_names, dataset_folder):
        found = [n for n in datapoints_names if n != f'{dataset_folder}/renders']
        try:
            props = Properties(self.root_path / dataset_folder / 'dataset_properties.json')
        except FileNotFoundError:
            print(f'{self.__class__.__name__}::Warning::No `dataset_properties.json` '
                  'found. Using all datapoints without filtering.')
            self.data_folders_nicknames[dataset_folder] = dataset_folder
            return found

        if not props['to_subfolders']:
            raise NotImplementedError('Only working with datasets organized in subfolders')

        # nickname = template file stem ('tee_sleeveless' etc.)
        self.data_folders_nicknames[dataset_folder] = \
            props['templates'].split('/')[-1].split('.')[0]

        failed = {f'{dataset_folder}/{name}'
                  for names in props['sim']['stats']['fails'].values()
                  for name in names}
        found = [n for n in found if n not in failed]

        if self.config.get('filter_by_params'):
            found = self.filter_by_params(
                self.config['filter_by_params'], dataset_folder, found)
        return found

    def filter_by_params(self, filter_file, dataset_folder, datapoint_names):
        """Keep only datapoints whose design parameters fall inside the
        allowed ranges (reference: nn/data/datasets.py:474-499)."""
        with open(filter_file, 'r') as f:
            allowed_ranges = json.load(f)

        def in_range(name):
            spec = NNSewingPattern(self.root_path / name / 'specification.json')
            ranges = allowed_ranges.get(self.template_name(name), {})
            return all(lo <= spec.parameters[param]['value'] <= hi
                       for param, (lo, hi) in ranges.items())

        survivors = [n for n in datapoint_names if in_range(n)]
        print(f'{self.__class__.__name__}::Filtering::{dataset_folder}::'
              f'{len(survivors)} of {len(datapoint_names)}')
        return survivors

    # ---- datapoint utils ----
    def template_name(self, datapoint_name):
        return self.data_folders_nicknames[datapoint_name.split('/')[0]]

    def _read_pattern(self, datapoint_name, folder_elements,
                      pad_panels_to_len=None, pad_panel_num=None, pad_stitches_num=None,
                      with_placement=False, with_stitches=False, with_stitch_tags=False):
        spec_list = [f for f in folder_elements if 'specification.json' in f]
        if not spec_list:
            raise RuntimeError(
                f'GarmentBaseDataset::Error::*specification.json not found for {datapoint_name}')
        pattern = NNSewingPattern(
            self.root_path / datapoint_name / spec_list[0],
            panel_classifier=self.panel_classifier,
            template_name=self.template_name(datapoint_name))
        return pattern.pattern_as_tensors(
            pad_panels_to_len, pad_panels_num=pad_panel_num,
            pad_stitches_num=pad_stitches_num, with_placement=with_placement,
            with_stitches=with_stitches, with_stitch_tags=with_stitch_tags)


class Garment3DPatternFullDataset(GarmentBaseDataset):
    """Full pattern GT (outlines + placement + stitches) from 3D point-cloud
    features (reference: nn/data/datasets.py:571-982)."""

    def __init__(self, root_dir, start_config=None, gt_caching=False,
                 feature_caching=False, in_transforms=None):
        start_config = dict(start_config or {'data_folders': []})
        start_config.setdefault('mesh_samples', 2000)
        start_config.setdefault('point_noise_w', 0)
        start_config.setdefault('sampling_seed', 601)
        start_config.setdefault('on_device_sampling', False)
        start_config.setdefault('mesh_vertex_cap', 8192)
        start_config.setdefault('mesh_face_cap', 16384)
        if start_config['on_device_sampling']:
            raise NotImplementedError(
                f'{self.__class__.__name__}: on_device_sampling '
                '(garment_pattern_estimation_tpu/preprocess/device_sampling.py) is not '
                'ported; set dataset.on_device_sampling: false')
        self.segm_cached = {}
        super().__init__(root_dir, start_config, gt_caching=gt_caching,
                         feature_caching=feature_caching, in_transforms=in_transforms)
        first_gt = self[0]['ground_truth']
        self.config.update(
            element_size=first_gt['outlines'].shape[2],
            rotation_size=first_gt['rotations'].shape[1],
            translation_size=first_gt['translations'].shape[1],
            stitch_tag_size=first_gt['stitch_tags'].shape[-1],
            explicit_stitch_tags=False,
        )

    def standardize(self, training=None):
        """Compute (or reuse) standardization stats and install the
        transforms (reference: nn/data/datasets.py:596-654)."""
        print(f'{self.__class__.__name__}::standardizing features & GT')
        if 'standardize' in self.config:
            print(f'{self.__class__.__name__}::standardization stats taken from config')
            stats = self.config['standardize']
        elif training is not None:
            samples = [training[i] for i in range(len(training))]
            features = np.stack([s['features'] for s in samples])
            gt_field = lambda key: np.stack([s['ground_truth'][key] for s in samples])

            feature_shift, feature_scale = self._get_distribution_stats(features)
            panel_shift, panel_scale = self._get_distribution_stats(
                gt_field('outlines'), padded=True)
            panel_shift[0] = panel_shift[1] = 0  # keep the loop property intact
            transl_min, transl_scale = self._get_norm_stats(gt_field('translations'))
            rot_min, rot_scale = self._get_norm_stats(gt_field('rotations'))
            tags_min, tags_scale = self._get_norm_stats(gt_field('stitch_tags'))

            self.config['standardize'] = {
                'f_shift': feature_shift.tolist(), 'f_scale': feature_scale.tolist(),
                'gt_shift': {
                    'outlines': panel_shift.tolist(), 'rotations': rot_min.tolist(),
                    'translations': transl_min.tolist(), 'stitch_tags': tags_min.tolist(),
                },
                'gt_scale': {
                    'outlines': panel_scale.tolist(), 'rotations': rot_scale.tolist(),
                    'translations': transl_scale.tolist(), 'stitch_tags': tags_scale.tolist(),
                },
            }
            stats = self.config['standardize']
        else:
            raise ValueError(
                f'{self.__class__.__name__}::Error::standardization requires either '
                'stats in config or a training subset')

        self.transforms = [t for t in self.transforms
                           if not isinstance(t, (transforms.GTtandartization,
                                                 transforms.FeatureStandartization))]
        self.transforms.append(transforms.GTtandartization(stats['gt_shift'], stats['gt_scale']))
        self.transforms.append(transforms.FeatureStandartization(stats['f_shift'], stats['f_scale']))

    # ---- prediction saving ----
    def save_prediction_batch(self, predictions, datanames, data_folders, save_to,
                              features=None, weights=None, orig_folder_names=False,
                              **kwargs):
        """Save per-datapoint predicted patterns (json + png + GT copies)
        (reference: nn/data/datasets.py:657-729)."""
        save_to = Path(save_to)
        rendered = []
        for idx, (name, folder) in enumerate(zip(datanames, data_folders)):
            prediction = {key: np.asarray(batch[idx])
                          for key, batch in predictions.items()}
            cached_gt = self.gt_cached.get(f'{folder}/{name}') \
                if self.gt_caching else None

            # complement the prediction with GT fields when available — but
            # NOT when the model trained with order/origin matching: its
            # panels then live in arbitrary slots and GT stitch/edge ids do
            # not apply (reference: datasets.py:676-685)
            canonicalized = (self.config.get('order_matching')
                             or self.config.get('origin_matching'))
            if not canonicalized and cached_gt is not None:
                for key, value in cached_gt.items():
                    prediction.setdefault(key, np.asarray(value))
            elif canonicalized or not self.gt_caching:
                print(f'{self.__class__.__name__}::Warning::propagating '
                      'information from GT on prediction is not implemented '
                      'in given context')

            pattern = self._pred_to_pattern(prediction, name)
            if cached_gt is not None:
                pattern.spec['properties']['correct_num_panels'] = \
                    int(cached_gt['num_panels'])

            into = folder if orig_folder_names \
                else self.data_folders_nicknames[folder]
            try:
                out_dir = Path(pattern.serialize(
                    save_to / into, to_subfolder=True, tag='_predicted_'))
            except (RuntimeError, InvalidPatternDefError, TypeError) as e:
                print(f'{self.__class__.__name__}::Error::{name} serializing skipped: {e}')
                continue
            rendered.append(out_dir / f'{pattern.name}_predicted__pattern.png')

            # GT renders/specs ride along for side-by-side inspection
            for source in (self.root_path / folder / name).glob('*'):
                if source.suffix in ('.png', '.json'):
                    shutil.copy2(str(source), str(out_dir))

            if features is not None:
                stats = self.config['standardize']
                cloud = np.asarray(features[idx]) * np.asarray(stats['f_scale']) \
                    + np.asarray(stats['f_shift'])
                np.savetxt(save_to / into / name / f'{name}_point_cloud.txt', cloud)
            if 'att_weights' in prediction:
                np.savetxt(save_to / into / name / f'{name}_att_weights.txt',
                           np.asarray(prediction['att_weights']))
        return rendered

    def _pred_to_pattern(self, prediction, dataname):
        """Standardized prediction dict -> NNSewingPattern
        (reference: nn/data/datasets.py:731-767)."""
        gt_shifts = self.config['standardize']['gt_shift']
        gt_scales = self.config['standardize']['gt_scale']
        prediction = dict(prediction)
        for key in gt_shifts:
            if key == 'stitch_tags' and not self.config.get('explicit_stitch_tags', False):
                continue
            prediction[key] = np.asarray(prediction[key]) * np.asarray(gt_scales[key]) \
                + np.asarray(gt_shifts[key])

        if 'stitches' in prediction:
            stitches = np.asarray(prediction['stitches'])
        else:
            stitches = tags_to_stitches_np(prediction['stitch_tags'],
                                           prediction['free_edges_mask'])

        pattern = NNSewingPattern(view_ids=False, panel_classifier=self.panel_classifier)
        pattern.name = dataname
        try:
            pattern.pattern_from_tensors(
                prediction['outlines'], panel_rotations=prediction['rotations'],
                panel_translations=prediction['translations'], stitches=stitches,
                padded=True)
        except (RuntimeError, InvalidPatternDefError) as e:
            print(f'{self.__class__.__name__}::Warning::{dataname}: {e}')
        return pattern

    # ---- sample assembly ----
    def _get_sample_info(self, datapoint_name):
        folder_elements = [f.name for f in (self.root_path / datapoint_name).glob('*')]

        if datapoint_name in self.feature_cached:
            features = self.feature_cached[datapoint_name]
            segm = self.segm_cached[datapoint_name]
        else:
            points, verts = self._sample_points(datapoint_name, folder_elements)
            segm = self._point_classes_from_mesh(points, verts, datapoint_name,
                                                 folder_elements)
            features = points
            if self.feature_caching:
                self.feature_cached[datapoint_name] = features
                self.segm_cached[datapoint_name] = segm

        if datapoint_name in self.gt_cached:
            ground_truth = self.gt_cached[datapoint_name]
        else:
            ground_truth = self._get_pattern_ground_truth(datapoint_name, folder_elements)
            if segm is not None:
                ground_truth['segmentation'] = segm
            if self.gt_caching:
                self.gt_cached[datapoint_name] = ground_truth
        return features, ground_truth

    def _get_pattern_ground_truth(self, datapoint_name, folder_elements):
        pattern, num_edges, num_panels, rots, transls, stitches, num_stitches, stitch_tags = \
            self._read_pattern(
                datapoint_name, folder_elements,
                pad_panels_to_len=self.config['max_panel_len'],
                pad_panel_num=self.config['max_pattern_len'],
                pad_stitches_num=self.config['max_num_stitches'],
                with_placement=True, with_stitches=True, with_stitch_tags=True)
        free_edges_mask = self.free_edges_mask(pattern, stitches, num_stitches)
        empty_panels_mask = num_edges == 0
        return {
            'outlines': pattern, 'num_edges': num_edges,
            'rotations': rots, 'translations': transls,
            'num_panels': num_panels, 'empty_panels_mask': empty_panels_mask,
            'num_stitches': num_stitches, 'stitches': stitches,
            'free_edges_mask': free_edges_mask, 'stitch_tags': stitch_tags,
        }

    def _sample_points(self, datapoint_name, folder_elements):
        """Sample the point cloud (deterministic per datapoint + config seed)."""
        obj_list = [f for f in folder_elements
                    if self.config['obj_filetag'] in f and '.obj' in f]
        if not obj_list:
            raise RuntimeError(
                f'Dataset::Error::geometry file *{self.config["obj_filetag"]}*.obj '
                f'not found for {datapoint_name}')
        verts, faces = mesh_ops.read_triangle_mesh(
            str(self.root_path / datapoint_name / obj_list[0]))
        # zlib.crc32, NOT hash(): str hashing is salted per process, which
        # would break the deterministic-per-(datapoint, seed) guarantee
        # across runs (stats vs eval vs parity checks)
        seed = (zlib.crc32(datapoint_name.encode())
                ^ self.config['sampling_seed']) & (2 ** 63 - 1)
        points = mesh_ops.sample_mesh_points(
            self.config['mesh_samples'], verts, faces, seed=seed)
        if self.config['point_noise_w']:
            noise_rng = np.random.default_rng(seed ^ 0x9E3779B9)
            points = points + noise_rng.normal(
                0.0, self.config['point_noise_w'], size=points.shape)
        return points, verts

    @staticmethod
    def sample_mesh_points(num_points, verts, faces, seed=None):
        """Standalone sampling routine (reference API: datasets.py:845-861)."""
        return mesh_ops.sample_mesh_points(num_points, verts, faces, seed=seed)

    def _point_classes_from_mesh(self, points, verts, datapoint_name, folder_elements):
        """Transfer per-vertex segmentation labels to sampled points via
        nearest-vertex snap; 'stitch'/'None' labels are reassigned to the
        closest panel-labeled point (reference: datasets.py:863-905)."""
        seg_list = [f for f in folder_elements
                    if self.config['obj_filetag'] in f and 'segmentation.txt' in f]
        if not seg_list:
            return np.zeros(len(points), dtype=np.int64)
        with open(self.root_path / datapoint_name / seg_list[0], 'r') as f:
            vert_labels = np.array([line.rstrip() for line in f])

        map_list, _ = mesh_ops.snap_points(points, verts)
        if len(verts) > len(vert_labels):
            print(f'{self.__class__.__name__}::{datapoint_name}::WARNING::not enough '
                  f'segmentation labels — {len(vert_labels)} for {len(verts)} vertices. '
                  'Setting segmentation to zero')
            return np.zeros(len(map_list), dtype=np.int64)

        point_labels = vert_labels[map_list]
        stitch_ids = (point_labels == 'stitch') | (point_labels == 'None')
        non_stitch_ids = ~stitch_ids
        if stitch_ids.any() and non_stitch_ids.any():
            map_stitches, _ = mesh_ops.snap_points(
                points[stitch_ids], points[non_stitch_ids])
            non_stitch_pos = np.flatnonzero(non_stitch_ids)
            point_labels[stitch_ids] = point_labels[non_stitch_pos[map_stitches]]

        if self.panel_classifier is not None:
            segmentation = self.panel_classifier.map(
                self.template_name(datapoint_name), point_labels)
        else:
            unique = {name: i for i, name in enumerate(np.unique(point_labels))}
            segmentation = np.array([unique[name] for name in point_labels])
        return segmentation.astype(np.int64)

    # ---- stitch tools ----
    tags_to_stitches = staticmethod(tags_to_stitches_np)

    @staticmethod
    def free_edges_mask(pattern, stitches, num_stitches):
        """True for edges not participating in any stitch
        (reference: datasets.py:970-982)."""
        n_panels, row_len = pattern.shape[:2]
        stitched = np.asarray(stitches)[:, :num_stitches].ravel()
        mask = np.ones(n_panels * row_len, dtype=bool)
        mask[stitched] = False
        return mask.reshape(n_panels, row_len)


DATASET_REGISTRY = {
    'Garment3DPatternFullDataset': Garment3DPatternFullDataset,
}
