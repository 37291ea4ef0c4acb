"""Local-first experiment tracking with the reference's W&B capabilities.

The port's copy of garment_pattern_estimation_tpu/experiment/tracker.py:57-366
in local mode: checkpoints are `torch.save` files (`checkpoint.py`), and the
optional wandb mirror keeps only its absent-package path. A run without a
'best' checkpoint falls back to its config's `NN.pre-trained` file, a port
checkpoint or a reference `.pth` (`torch_import.load_checkpoint_any`).

Counterpart of nn/experiment.py's ExperimentWrappper: run init/resume by id,
config persistence, metric logging, summary statistics, versioned + aliased
checkpoints, dataset/model recovery from a stored run, and batch prediction —
all against the local filesystem (no cloud dependency; runs are plain
directories that can be synced anywhere).

Run directory layout:
    <output>/<project>/<run_name>_<run_id>/
        config.json         # nested run config (experiment/dataset/NN/trainer/…)
        summary.json        # add_statistic() results
        metrics.jsonl       # one JSON line per log() call
        checkpoints/
            checkpoint_<N>.pt
            aliases.json    # {"latest": N, "best": M}
        artifacts/          # split files, panel classes, dataset props, …
"""
from __future__ import annotations

import json
import math
import time
import uuid
from pathlib import Path

import numpy as np

from .checkpoint import save_checkpoint_file, load_checkpoint_file


def _to_jsonable(value):
    if isinstance(value, dict):
        return {k: _to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_jsonable(v) for v in value]
    if isinstance(value, np.ndarray):
        return _to_jsonable(value.tolist())
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        value = float(value)
    if isinstance(value, float) and not math.isfinite(value):
        # NaN/Inf are not valid strict JSON (correct-panel-restricted
        # metrics are NaN when no pattern qualifies): record null
        return None
    if isinstance(value, (np.bool_,)):
        return bool(value)
    if hasattr(value, 'item') and not isinstance(value, (str, bytes)):
        try:
            return _to_jsonable(value.item())
        except Exception:
            return str(value)
    return value


class ExperimentWrappper:
    """Local experiment tracker. (Class name kept — including the reference's
    spelling — for drop-in config/API compatibility; `ExperimentWrapper` is an
    alias.)"""

    def __init__(self, config, output_root='./experiments', no_sync=False):
        """`config` carries an 'experiment' section with project_name /
        run_name / run_id (id empty -> new run on init_run()).

        The local directory is the source of truth; `no_sync` is accepted
        for the JAX package's signature (its optional wandb mirror is not
        ported)."""
        exp_section = config.get('experiment', {})
        self.project = exp_section.get('project_name', 'Garments-Reconstruction')
        self.run_name = exp_section.get('run_name', 'run')
        self.run_id = exp_section.get('run_id') or None
        self.output_root = Path(output_root)
        self.in_config = config
        self.initialized = False
        self.resumed = False
        self.checkpoint_counter = 0
        self._local_step = -1

        # when the run already exists on disk, surface its stored config
        if self.run_id and self.run_dir().exists():
            self._load_run_files()
        else:
            self.config = {k: v for k, v in config.items() if k != 'experiment'}
            self.summary = {}

    # ------------- paths -------------
    def run_dir(self):
        if self.run_id is None:
            raise RuntimeError('ExperimentWrappper::run_id is not set yet')
        return self.output_root / self.project / f'{self.run_name}_{self.run_id}'

    def checkpoint_dir(self):
        return self.run_dir() / 'checkpoints'

    def local_artifacts_path(self):
        path = self.run_dir() / 'artifacts'
        path.mkdir(parents=True, exist_ok=True)
        return path

    # reference-API aliases
    local_wandb_path = local_artifacts_path

    def cloud_path(self):
        return str(self.run_dir())

    def full_name(self):
        return f'{self.project}/{self.run_name}_{self.run_id}'

    # ------------- lifecycle -------------
    def init_run(self, config_extras=None):
        """Create a new run directory, or resume when run_id points to an
        existing one (reference: experiment.py:47-66, resume='allow')."""
        if self.run_id is None:
            self.run_id = uuid.uuid4().hex[:8]
        self.resumed = self.run_dir().exists() and (
            self.checkpoint_dir() / 'aliases.json').exists()
        self.run_dir().mkdir(parents=True, exist_ok=True)
        self.checkpoint_dir().mkdir(parents=True, exist_ok=True)

        if self.resumed:
            self._load_run_files()
            # continue checkpoint versioning where the run left off: a reset
            # counter would overwrite versions that aliases.json (e.g.
            # 'best') still points at. Callers may still advance it (the
            # trainer aligns it with the resumed epoch), but never backward.
            self.checkpoint_counter = max(self.checkpoint_counter,
                                          self._aliases().get('latest', -1) + 1)
        if config_extras:
            self.config.update(_to_jsonable(config_extras))
        self._save_config()
        if not (self.run_dir() / 'summary.json').exists():
            self._save_summary()
        self.initialized = True
        return self.run_id

    def is_finished(self):
        return (self.run_dir() / 'finished.marker').exists() if self.run_id \
            and self.run_dir().exists() else False

    def stop(self):
        if self.run_id and self.run_dir().exists():
            (self.run_dir() / 'finished.marker').write_text(str(time.time()))

    def _load_run_files(self):
        config_file = self.run_dir() / 'config.json'
        summary_file = self.run_dir() / 'summary.json'
        self.config = json.loads(config_file.read_text()) if config_file.exists() else {}
        self.summary = json.loads(summary_file.read_text()) if summary_file.exists() else {}

    def _save_config(self):
        with open(self.run_dir() / 'config.json', 'w') as f:
            json.dump(_to_jsonable(self.config), f, indent=2)

    def _save_summary(self):
        with open(self.run_dir() / 'summary.json', 'w') as f:
            json.dump(_to_jsonable(self.summary), f, indent=2)

    # ------------- config & stats -------------
    def add_config(self, section, config_dict):
        self.config[section] = _to_jsonable(config_dict)
        if self.run_id and self.run_dir().exists():
            self._save_config()

    def add_statistic(self, tag, info, log=''):
        """Record a (possibly nested) statistic into the run summary; nested
        dicts flatten to dotted keys like the reference
        (experiment.py:138-161)."""
        if log:
            print(f'{log}: {tag}: {info}')
        self.summary[tag] = _to_jsonable(info)
        if isinstance(info, dict):
            for key, value in _flatten(info, prefix=tag).items():
                self.summary[key] = _to_jsonable(value)
        if self.run_id and self.run_dir().exists():
            self._save_summary()

    def add_artifact(self, path, name=None, type=None):
        """Copy a file/dir into the run's artifacts."""
        import shutil
        src = Path(path)
        dst = self.local_artifacts_path() / (name or src.name)
        if src.is_dir():
            shutil.copytree(src, dst, dirs_exist_ok=True)
        else:
            shutil.copy2(src, dst)
        return dst

    def log(self, metrics, step=None):
        """Append a metric record (per-batch/per-epoch logging)."""
        self._local_step = step if step is not None else self._local_step + 1
        record = {'step': self._local_step}
        record.update({k: _to_jsonable(v) for k, v in metrics.items()})
        with open(self.run_dir() / 'metrics.jsonl', 'a') as f:
            f.write(json.dumps(record) + '\n')

    def last_best_validation_loss(self):
        return self.summary.get('best_valid_loss')

    # ------------- stored-run recovery -------------
    def data_info(self):
        """(split config, batch_size, data config) as stored in the run —
        with the saved data_split.json re-attached (reference:
        experiment.py:92-124)."""
        split = dict(self.config.get('data_split', {}))
        batch_size = self.config.get('trainer', {}).get('batch_size')
        data_config = dict(self.config.get('dataset', {}))
        split_file = self.local_artifacts_path() / 'data_split.json'
        if split_file.exists():
            split['filename'] = str(split_file)
        classes_file = self.local_artifacts_path() / 'panel_classes.json'
        if classes_file.exists():
            data_config['panel_classification'] = str(classes_file)
        filter_file = self.local_artifacts_path() / 'param_filter.json'
        if filter_file.exists():
            data_config['filter_by_params'] = str(filter_file)
        return split, batch_size, data_config

    def NN_config(self):
        return self.config.get('NN', {})

    def last_epoch(self):
        aliases = self._aliases()
        return aliases.get('latest', -1)

    # ------------- checkpoints -------------
    def _aliases(self):
        aliases_file = self.checkpoint_dir() / 'aliases.json'
        if aliases_file.exists():
            return json.loads(aliases_file.read_text())
        return {}

    def save_checkpoint(self, state, aliases=(), wait_for_upload=False):
        """Save a versioned checkpoint; `state` is a dict of tensors and
        plain types (`checkpoint.save_checkpoint_file`). Aliases
        ('best', …) point at versions; 'latest' always updates."""
        self.checkpoint_dir().mkdir(parents=True, exist_ok=True)
        version = self.checkpoint_counter
        self.checkpoint_counter += 1
        path = self.checkpoint_dir() / f'checkpoint_{version}.pt'
        save_checkpoint_file(state, path)

        aliases_map = self._aliases()
        aliases_map['latest'] = version
        for alias in aliases:
            aliases_map[alias] = version
        with open(self.checkpoint_dir() / 'aliases.json', 'w') as f:
            json.dump(aliases_map, f)

        # prune old unaliased versions to bound disk usage
        keep = set(aliases_map.values()) | {version}
        for old in self.checkpoint_dir().glob('checkpoint_*.pt'):
            try:
                v = int(old.stem.split('_')[1])
            except (IndexError, ValueError):
                continue
            if v not in keep and v < version - 2:
                old.unlink(missing_ok=True)
        return path

    def get_checkpoint_file(self, alias='latest', map_location='cpu'):
        """Load a checkpoint dict by alias ('latest'/'best') or version."""
        aliases_map = self._aliases()
        if isinstance(alias, int):
            version = alias
        elif alias in aliases_map:
            version = aliases_map[alias]
        else:
            raise FileNotFoundError(
                f'ExperimentWrappper::no checkpoint with alias <{alias}> in '
                f'{self.checkpoint_dir()}')
        path = self.checkpoint_dir() / f'checkpoint_{version}.pt'
        return load_checkpoint_file(path, map_location=map_location)

    def get_best_model(self, map_location='cpu'):
        """The 'best' checkpoint; falls back to the config's `NN.pre-trained`
        file when the run has none (reference: experiment.py:311-335)."""
        try:
            return self.get_checkpoint_file('best', map_location=map_location)
        except FileNotFoundError:
            pretrained = self.config.get('NN', {}).get('pre-trained')
            if pretrained and Path(pretrained).exists():
                from .torch_import import load_checkpoint_any
                return load_checkpoint_any(pretrained, map_location=map_location)
            raise

    # ------------- factories -------------
    def load_dataset(self, data_root, eval_config=None, unseen=False,
                     batch_size=None, load_all=False):
        """Rebuild the dataset + wrapper from this run's stored config and
        split (reference: experiment.py:203-225). `eval_config` patches the
        data config (e.g. `obj_filetag`, `point_noise_w`); `unseen` swaps in
        its `unseen_data_folders` and, like `load_all`, drops the split (the
        whole dataset is the 'full' section); `batch_size` overrides the
        stored one."""
        from ..data import DATASET_REGISTRY, DatasetWrapper

        split, stored_batch, data_config = self.data_info()
        data_config.update(eval_config or {})
        if unseen:
            data_config['data_folders'] = data_config.get(
                'unseen_data_folders', data_config.get('data_folders'))
            split = None
        if load_all:
            split = None
        batch_size = batch_size or stored_batch or 1
        dataset_class = DATASET_REGISTRY[data_config.get(
            'class', 'Garment3DPatternFullDataset')]
        dataset = dataset_class(data_root, data_config,
                                gt_caching=True, feature_caching=True)
        wrapper = DatasetWrapper(dataset, known_split=split, batch_size=batch_size)
        if wrapper.batch_size is None:
            wrapper.batch_size = batch_size
            wrapper.new_loaders()
        dataset.standardize()  # stats must already be in the stored config
        return dataset, wrapper

    def load_model(self, data_config, alias='best', nn_overrides=None, device=None):
        """Rebuild the model from the stored NN config on `device` (None =
        CUDA) and load the weights of checkpoint `alias` (for 'best', the
        `NN.pre-trained` fallback of `get_best_model`) into it. Returns
        (GarmentModel, state dict).

        `nn_overrides` patches the stored NN config before the rebuild, for
        knobs that change compute but not parameters (`compute_dtype`,
        `f32_conv_layers`, `f32_attention_mlp`)."""
        from ..models import build_model

        nn_config = dict(self.NN_config())
        nn_config.update(nn_overrides or {})
        model = build_model(nn_config.get('model', 'GarmentSegmentPattern3D'),
                            data_config, nn_config, nn_config.get('loss', {}),
                            device=device)
        checkpoint = (self.get_best_model(map_location=model.device) if alias == 'best'
                      else self.get_checkpoint_file(alias, map_location=model.device))
        state = checkpoint['model']
        model.module.load_state_dict(state)
        return model, state

    def prediction(self, save_to, predict_fn, datawrapper, nick='test',
                   sections=('test',), model=None):
        """Batch prediction + artifact registration. Predictions keep the
        original data-folder names (not nicknames) so they can serve as a
        dataset root downstream (reference: experiment.py:243-255)."""
        prediction_path = datawrapper.predict(
            predict_fn, save_to=Path(save_to), dir_tag=nick, sections=sections,
            model=model, orig_folder_names=True)
        if self.run_id and self.run_dir().exists():
            self.add_statistic('prediction_path', str(prediction_path))
        return prediction_path


ExperimentWrapper = ExperimentWrappper  # corrected-spelling alias


def _flatten(nested, prefix=''):
    flat = {}
    for key, value in nested.items():
        name = f'{prefix}.{key}' if prefix else key
        if isinstance(value, dict):
            flat.update(_flatten(value, name))
        else:
            flat[name] = value
    return flat
