"""DatasetWrapper: split management + named loaders + batch prediction.

Counterpart of nn/data/wrapper.py: keeps the dataset and its
train/validation/test subsets, builds the 9 named loaders (full/train/
validation/test, the per-data-folder breakdowns, and a one-sample-per-type
loader for visual logging), reproduces frozen splits, and drives batched
prediction saving.

The port's copy of garment_pattern_estimation_tpu/data/wrapper.py:1-204.
"""
from __future__ import annotations

import json
from argparse import Namespace
from datetime import datetime
from pathlib import Path

import numpy as np

from .loader import DataLoader, Subset
from .sampler import BalancedBatchSampler


class DatasetWrapper:
    """Dataset + splits + loaders + prediction routines."""

    def __init__(self, dataset, known_split=None, batch_size=None,
                 shuffle_train=True):
        self.dataset = dataset
        # whole-dataset section until a split is loaded
        self.training, self.validation, self.test = dataset, None, None
        self.full_per_datafolder = None
        self.training_per_datafolder = {}
        self.validation_per_datafolder = {}
        self.test_per_datafolder = {}
        self.batch_size = None
        self.loaders = Namespace(
            full=None, full_per_data_folder=None,
            train=None,
            test=None, test_per_data_folder=None,
            validation=None, valid_per_data_folder=None,
            valid_single_per_data=None,
        )
        self.split_info = {'random_seed': None, 'valid_per_type': None,
                           'test_per_type': None}

        if known_split is not None:
            self.load_split(known_split)
        if batch_size is not None:
            self.batch_size = batch_size
            self.new_loaders(batch_size, shuffle_train)

    def get_loader(self, data_section='full'):
        if not hasattr(self.loaders, data_section):
            raise ValueError(
                f'DataWrapper::requested loader on unknown data section {data_section}')
        return getattr(self.loaders, data_section)

    def new_loaders(self, batch_size=None, shuffle_train=True):
        """(Re)build loaders for the current split."""
        self.batch_size = batch_size if batch_size is not None else self.batch_size
        if self.batch_size is None:
            raise RuntimeError('DataWrapper::Error::cannot create loaders: batch_size not set')

        seed = self.split_info.get('random_seed')
        if self.full_per_datafolder is None:
            self.full_per_datafolder = self.dataset.subsets_per_datafolder()

        # plain sections + their per-folder breakdowns, one recipe each;
        # train/validation never depend on a test section existing (a split
        # with test_per_type=0/None is legal)
        plain = (('full', 'full_per_data_folder',
                  self.dataset, self.full_per_datafolder),
                 ('validation', 'valid_per_data_folder',
                  self.validation, self.validation_per_datafolder),
                 ('test', 'test_per_data_folder',
                  self.test, self.test_per_datafolder))
        for name, breakdown_name, subset, per_folder in plain:
            if subset is None:
                continue
            setattr(self.loaders, name, DataLoader(subset, self.batch_size))
            setattr(self.loaders, breakdown_name, {
                folder: DataLoader(sub, self.batch_size)
                for folder, sub in per_folder.items() if sub is not None})

        if self.training is not None:
            self.loaders.train = self._training_loader(shuffle_train, seed)
        if self.validation is not None:
            # one sample of every garment type, for visual logging
            first_of_each = [sub.indices[0]
                             for sub in self.validation_per_datafolder.values()
                             if sub is not None and len(sub)]
            self.loaders.valid_single_per_data = DataLoader(
                Subset(self.dataset, first_of_each), batch_size=self.batch_size)

        return self.loaders.train, self.loaders.validation, self.loaders.test

    def _training_loader(self, shuffle_train, seed):
        """Balanced garment-type batches when the dataset supports the
        grouping; plain shuffling otherwise."""
        try:
            self.dataset.config['balanced_batch_sampling'] = True
            _, per_type = self.dataset.indices_by_data_folder(
                self.training.indices)
            sampler = BalancedBatchSampler(per_type, batch_size=self.batch_size,
                                           seed=seed)
            return DataLoader(self.training, batch_sampler=sampler)
        except (AttributeError, NotImplementedError):
            print(f'{self.__class__.__name__}::Warning::failed to create balanced '
                  'batches for training. Using default sampling')
            self.dataset.config['balanced_batch_sampling'] = False
            return DataLoader(self.training, self.batch_size,
                              shuffle=shuffle_train, seed=seed)

    # ---- split reproduction ----
    def new_split(self, valid, test=None, random_seed=None):
        # `is None`, not falsy: random_seed=0 is a legitimate fixed seed
        self.split_info.update(
            random_seed=(int(datetime.now().timestamp())
                         if random_seed is None else random_seed),
            valid_per_type=valid, test_per_type=test, type='count')
        return self.load_split()

    def load_split(self, split_info=None, batch_size=None):
        """Reproduce (or create) the split; reseeds the split RNG so the same
        `random_seed` always yields the same subsets."""
        if split_info:
            self.split_info = dict(split_info)
        if self.split_info.get('random_seed') is None:
            self.split_info['random_seed'] = int(datetime.now().timestamp())
        rng = np.random.default_rng(self.split_info['random_seed'])

        if self.split_info.get('filename'):
            print(f'DatasetWrapper::reproducing split from {self.split_info["filename"]}')
            with open(self.split_info['filename'], 'r') as f:
                split_dict = json.load(f)
            (self.training, self.validation, self.test,
             self.training_per_datafolder, self.validation_per_datafolder,
             self.test_per_datafolder) = self.dataset.split_from_dict(
                split_dict, with_breakdown=True)
        else:
            required = ['test_per_type', 'valid_per_type', 'type']
            if any(key not in self.split_info for key in required):
                raise ValueError(
                    f'Specified split information is not full: {self.split_info}. '
                    f'It needs to contain: {required}')
            (self.training, self.validation, self.test,
             self.training_per_datafolder, self.validation_per_datafolder,
             self.test_per_datafolder) = self.dataset.random_split_by_dataset(
                self.split_info['valid_per_type'], self.split_info['test_per_type'],
                self.split_info['type'], with_breakdown=True, rng=rng)

        if batch_size is not None:
            self.batch_size = batch_size
        if self.batch_size is not None:
            self.new_loaders()

        sizes = {tag: len(subset) if subset else 0 for tag, subset in
                 (('train', self.training), ('valid', self.validation),
                  ('test', self.test))}
        print('DatasetWrapper::split sizes (train/valid/test): '
              + ' / '.join(str(n) for n in sizes.values()))
        self.split_info.update({f'size_{tag}': n for tag, n in sizes.items()})
        return self.training, self.validation, self.test

    def save_to_wandb(self, experiment):
        """Record split info + serialized split into the experiment tracker."""
        experiment.add_config('data_split', self.split_info)
        split_datanames = {
            'training': [self.dataset.datapoints_names[i] for i in self.training.indices],
            'validation': [self.dataset.datapoints_names[i] for i in self.validation.indices],
            'test': [self.dataset.datapoints_names[i] for i in self.test.indices]
            if self.test else [],
        }
        with open(Path(experiment.local_artifacts_path()) / 'data_split.json', 'w') as f:
            json.dump(split_datanames, f, indent=2, sort_keys=True)
        self.dataset.save_to_wandb(experiment)

    # ---- standardization ----
    def standardize_data(self):
        self.dataset.standardize(self.training)

    # ---- prediction ----
    def predict(self, predict_fn, save_to, dir_tag='pred', sections=('test',),
                single_batch=False, orig_folder_names=False, model=None):
        """Run `predict_fn(features_batch) -> prediction dict/array` over the
        requested sections and save via the dataset's hooks
        (reference: nn/data/wrapper.py:504-537)."""
        stamp = datetime.now().strftime('%y%m%d-%H-%M-%S')
        out_root = Path(save_to) / f'nn_{dir_tag}_{stamp}'
        out_root.mkdir(parents=True, exist_ok=True)

        for section in sections:
            target = out_root / section
            target.mkdir(parents=True, exist_ok=True)
            loader = self.get_loader(section)
            if not loader:
                continue
            for batch in loader:
                self.dataset.save_prediction_batch(
                    predict_fn(batch['features']), batch['name'],
                    batch['data_folder'], target, features=batch['features'],
                    model=model, orig_folder_names=orig_folder_names)
                if single_batch:
                    break
        return out_root
