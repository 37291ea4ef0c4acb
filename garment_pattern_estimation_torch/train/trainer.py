"""Training of the port: optimizer, one-cycle schedule, loss-phase
bookkeeping, one train or eval step on a batch, and `Trainer.fit` over a
dataset with its tracker, checkpoints, early stopping and f32 tail.

Counterpart of garment_pattern_estimation_tpu/train/trainer.py:46-652.
Over a dataset (ROADMAP queue A item 1):

    trainer = Trainer(config['trainer'], experiment, dataset, config['data_split'])
    model = build_model(..., dataset.config, ...)         # on CUDA
    trainer.fit(model)

or a caller drives the steps itself:

    trainer = Trainer(config['trainer'])                  # on CUDA
    trainer.make_optimizer(model, steps_per_epoch)
    loss, terms = trainer.train_step(model, batch, epoch, generator)

A batch is {'features': (B, N, 3) standardized points, 'ground_truth':
{name: tensor}} as `data.DataLoader` collates it, or for the stitch model
{'features': (B, P, 16) edge pairs, 'ground_truth': (B, P) bool}. Under
`dataset.on_device_sampling` the features are a padded mesh dict, and each
step first draws its cloud on the device (`device_sampler`,
preprocess/device_sampling.py): a fresh cloud every training step, one
cloud per epoch for validation, the labels in the ground truth where the
loss reads them. With `with_visualization`, `fit` renders one prediction
per data folder after each epoch into the run's `intermediate_preds/`
(`_log_an_image`). `trainer.profile` (true, or {start_step, num_steps},
defaults 10 and 5) traces a window of `fit`'s steps with `torch.profiler`
into the run's `profile/`; the port's spans (`utils/tracing.py`: a step's
`gpe.train_step` and its `gpe.forward`, `gpe.loss`, `gpe.backward`,
`gpe.optimizer`) record while it is open and show in it.

Data parallelism (`trainer.mesh`, garment_pattern_estimation_tpu/train/
trainer.py:290-313): when a process group is initialised (`torchrun
--nproc_per_node=W`, `parallel.init_from_env`), `fit` trains over a 'data'
mesh of the W ranks, one card each; `trainer.mesh: {data: W}` must name the
world, and absent it is the world. Every rank iterates the same loaders; a
step pads the batch to a multiple of W (the last sample repeated), runs its
rows, with BatchNorm statistics and LSTM random draws of the whole padded
batch, gathers the predictions, slices them to the real batch and computes
the whole batch's loss, as the JAX step over a mesh slices inside the
step; the parameter gradients are summed over the ranks. A step computes
what one process computes on the padded batch. Only the first rank writes
files. Without a process group, `trainer.mesh` absent or {data: 1}, fit
runs in one process.

Points sharding (`trainer.mesh: {data: d, points: p}`, p > 1, d p
processes): a (data x points) mesh; each rank holds its data slice's rows
and, of each cloud, its p-th slice of the points. The encoder works on
this rank's points up to its first graph pool and on whole clouds after
it (`models.blocks`: `EdgeConvFeatures`, `EdgeConvPoolingFeatures`,
`PointNetPlusPlus`): an EdgeConv layer on a shard is the ring; the first
graph pool gathers its input over the points ranks (`PointsShard.gather`),
and the pools and layers after it run on the whole pooled clouds, the same
on every points rank; PointNet++ gathers the positions, samples the
centroids on the whole clouds and keeps this rank's share of them. The
BatchNorm statistics are means over all d p ranks (weighted by their shares
of rows where those are uneven), sparsemax and the attention MLP stay per point, and a pool over sharded
points is the pool over every points rank's (`PointsShard.sum`, `mean`,
`max`), as is the segmentation term (`ComposedPatternLoss.points_shard`).
The predictions, the same on the points ranks of a data slice (the
attention weights excepted, which are this rank's points where the
encoder's output is sharded), are gathered over the data ranks, and every
rank computes the whole batch's loss, but only the first points rank of
each data slice takes its backward. The others' cotangents flow in through
the collectives, each of whose backward sums the cotangents over the
points ranks: so every parameter's gradient is the sum over all ranks of
their shares, the post-pool layers' counted once, and one sum over the
mesh gives the one-process gradient on the padded batch.
"""
from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..data import DatasetWrapper
from ..device import resolve_device
from ..parallel import (
    DataShard, all_gather_rows, broadcast_object, is_first_rank, make_mesh, make_mesh_2d,
    pad_batch_to_multiple, replicate, sum_gradients)
from ..parallel.collectives import initialized
from ..preprocess.device_sampling import SAMPLING_STREAM, maybe_batch_sampler, reads_segmentation
from ..utils import tracing


def cosine_onecycle_schedule(transition_steps, peak_value, pct_start=0.3,
                             div_factor=25.0, final_div_factor=1e4):
    """optax.cosine_onecycle_schedule: from peak / div_factor up to the peak
    over int(pct_start * transition_steps) steps, then down to
    peak / (div_factor * final_div_factor) at `transition_steps`, both
    halves cosine; held there after. Like optax, the cosine and the blend
    are taken in float32 (the half range in float64 first). Returns
    step -> lr (float)."""
    if transition_steps <= 0:
        raise ValueError('cosine_onecycle_schedule: transition_steps must be positive')
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = [peak_value / div_factor]              # optax's cumulative product
    values += [values[0] * div_factor, values[0] * div_factor / (div_factor * final_div_factor)]

    def schedule(step):
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                cos = torch.cos(torch.tensor(math.pi * pct, dtype=torch.float32))
                end = torch.tensor(values[i + 1], dtype=torch.float32)
                half = torch.tensor((values[i] - values[i + 1]) / 2.0, dtype=torch.float32)
                return float(end + half * (cos + 1))
        return values[2]

    return schedule


def phase_of(loss_config, epoch):
    """(stitch phase, random-order phase) of `epoch`."""
    ews = loss_config.get('epoch_with_stitches', 40)
    ewo = loss_config.get('epoch_with_order_matching', 0)
    return epoch >= ews, epoch < ewo and loss_config.get('panel_order_inariant_loss', False)


def canonical_epoch(loss_config, stitch_phase, order_random):
    """A representative epoch with the phase's decisions: the loss sees it
    in place of the raw epoch, as the JAX trainer's cached steps do."""
    ews = loss_config.get('epoch_with_stitches', 40)
    ewo = loss_config.get('epoch_with_order_matching', 0)
    for epoch in range(0, max(ews, ewo) + 2):
        if (epoch >= ews) == stitch_phase and (epoch < ewo) == order_random:
            return epoch
    raise ValueError(f'Trainer: unsatisfiable loss phase: stitch={stitch_phase} '
                     f'order_random={order_random} (ews={ews}, ewo={ewo})')


class Trainer:
    """`setup` is the config's `trainer:` section (learning_rate, optimizer,
    weight_decay, lr_scheduling, epochs, batch_size, random_seed, best_by,
    early_stopping, f32_tail_epochs, ...). `experiment_tracker`, `dataset`
    and `data_split` are needed by `fit` only; `device` None is CUDA."""

    def __init__(self, setup, experiment_tracker=None, dataset=None, data_split=None,
                 with_norm=True, with_visualization=False, device=None):
        self.setup = dict(setup)
        self.device = resolve_device(device)
        self.experiment = experiment_tracker
        self.datawrapper = None
        self.standardize_data = with_norm
        self.log_with_visualization = with_visualization
        self.optimizer = None
        self.schedule = None
        self.step_count = 0
        self._root_seed = None
        self.device_sampler = None   # set in fit once the dataset config is final
        self._profiler = None
        self.data_shard = None       # this rank's share of a data mesh (`use_mesh`)

        # trainer.best_by: the 'best' checkpoint tracks a validation metric
        # instead of the loss (garment_pattern_estimation_tpu/train/trainer.py:57-90)
        self._monitor_key = self.setup.get('best_by') or None
        mode = self.setup.get('best_by_mode')
        if mode is not None and mode not in ('max', 'min'):
            raise ValueError(f"Trainer: best_by_mode must be 'max' or 'min', got {mode!r}")
        if mode is not None:
            self._monitor_max = mode == 'max'
        else:
            self._monitor_max = bool(self._monitor_key) and any(
                t in self._monitor_key for t in ('acc', 'precision', 'recall'))
        if self._monitor_key:
            print(f"Trainer::best checkpoint tracks '{self._monitor_key}' "
                  f"({'maximize' if self._monitor_max else 'minimize'}"
                  f"{', inferred' if mode is None else ''}), "
                  'ties broken by validation loss')
        self._monitor_warned_absent = False

        if dataset is not None:
            self.use_dataset(dataset, data_split or {})

    # ------------- setup -------------
    def init_randomizer(self, random_seed=None):
        """Fix the training seed and record it in the config
        (garment_pattern_estimation_tpu/train/trainer.py:96)."""
        if random_seed:
            self.setup['random_seed'] = random_seed
        elif not self.setup.get('random_seed'):
            # the first rank's clock: every rank must draw the same streams
            self.setup['random_seed'] = broadcast_object(int(time.time()))
        self._root_seed = int(self.setup['random_seed'])

    def use_dataset(self, dataset, split_info):
        """Split, loaders and (with_norm) standardization
        (garment_pattern_estimation_tpu/train/trainer.py:104)."""
        self.datawrapper = DatasetWrapper(dataset)
        if initialized() and split_info.get('random_seed') is None:
            # every rank must draw the same split and batch order
            split_info = dict(split_info, random_seed=broadcast_object(int(time.time())))
        self.datawrapper.load_split(split_info)
        self.datawrapper.new_loaders(self.setup['batch_size'], shuffle_train=True)
        workers = dataset.config.get('cache_fill_workers')
        if workers and workers > 1:
            start = time.time()
            n = dataset.warm_cache(workers=workers)
            if n:
                print(f'Trainer::warmed {n} samples with {workers} workers '
                      f'in {time.time() - start:.1f} s')
        if self.standardize_data:
            self.datawrapper.standardize_data()
        return self.datawrapper

    def _generator(self, stream):
        """A generator on the device seeded from the run's seed and `stream`
        (the step + 1 for training, 2**20 + epoch for validation): the
        counterpart of JAX's fold_in(root, stream). Its draws differ from
        JAX's; their law is the same."""
        seed = (self._root_seed * 1_000_003 + stream) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(seed)

    def make_optimizer(self, model, steps_per_epoch):
        """Adam or SGD over the model's parameters with the one-cycle (or a
        constant) schedule over epochs x steps_per_epoch steps; weight decay
        is added to the gradient, as torch's optimizers and the JAX
        package's optax chain both do."""
        lr = float(self.setup['learning_rate'])
        if self.setup.get('lr_scheduling') is not None:
            # optax's schedule is NaN when a phase rounds to zero length
            total_steps = self.setup['epochs'] * max(steps_per_epoch, 1)
            self.schedule = cosine_onecycle_schedule(max(total_steps, 4), lr)
        else:
            self.schedule = lambda step: lr
        weight_decay = float(self.setup.get('weight_decay', 0) or 0)
        params = model.module.parameters()
        if self.setup.get('optimizer', 'SGD') == 'Adam':
            self.optimizer = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
        else:
            self.optimizer = torch.optim.SGD(params, lr=lr, weight_decay=weight_decay)
        self.step_count = 0
        return self.optimizer

    def mesh_from_setup(self):
        """The mesh `trainer.mesh` asks for, or None: with a process group, a
        data mesh of the world (`data` must equal it), or for `points` p > 1
        a (data x points) mesh of d p = the world ranks (`data` d defaults
        to 1 there, as in the JAX trainer); without one, None, and `data`
        and `points` must be 1."""
        config = self.setup.get('mesh') or {}
        world = dist.get_world_size() if initialized() else 1
        points = int(config.get('points', 1))
        if points > 1:
            data = int(config.get('data', 1))
            if data * points != world:
                raise ValueError(
                    f'Trainer: trainer.mesh {{data: {data}, points: {points}}} needs '
                    f'{data * points} processes, one card each, and this run has {world}: '
                    f'start it with torchrun --standalone --nproc_per_node={data * points} '
                    '-m garment_pattern_estimation_torch.cli.train ...')
            return make_mesh_2d(data, points)
        data = int(config.get('data', world))
        if data != world:
            raise ValueError(
                f'Trainer: trainer.mesh.data = {data} needs {data} processes, one card each, '
                f'and this run has {world}: start it with torchrun --standalone '
                f'--nproc_per_node={data} -m garment_pattern_estimation_torch.cli.train ...')
        return make_mesh(data) if initialized() else None

    def use_mesh(self, model, mesh):
        """Train and evaluate `model` data-parallel over `mesh` (a 'data'
        mesh of the world, `parallel.make_mesh`, or a data x points mesh,
        `make_mesh_2d`): its parameters and buffers are broadcast from the
        first rank, its BatchNorm statistics and random draws become those
        of the global batch (`DataShard` on every module that takes one),
        and under a points axis its EdgeConv layers and pools work on this
        rank's points (`points_shard`). `mesh` None returns to one
        process."""
        shard = None if mesh is None else DataShard(mesh)
        points = shard.points if shard is not None else None
        self.data_shard = shard
        for module in model.module.modules():
            if hasattr(module, 'data_shard'):
                module.data_shard = shard
            if hasattr(module, 'points_shard'):
                module.points_shard = points
        if hasattr(model.loss, 'points_shard'):
            model.loss.points_shard = self._output_shard(model)
        if mesh is not None:
            replicate(mesh, model.module)

    @staticmethod
    def _output_shard(model):
        """The points shard of the model's per-point outputs (the attention
        weights): the encoder's (`output_shard`), None without one."""
        encoder = getattr(model.module, 'feature_extractor', None)
        return encoder.output_shard() if encoder is not None else None

    def _pad(self, batch):
        """Under a data mesh, the batch's features and ground truth padded
        to a multiple of the ranks (the last sample repeated) and its real
        size; else the batch and None."""
        if self.data_shard is None:
            return batch, None
        return pad_batch_to_multiple({'features': batch['features'],
                                      'ground_truth': batch['ground_truth']},
                                     self.data_shard.size)

    def _forward(self, model, features, gt, real, generator):
        """(predictions, ground truth) of the whole batch. Under a data mesh
        this rank runs its rows of the padded batch, and the predictions of
        every rank are gathered and, with the ground truth, cut to the
        `real` batch."""
        shard = self.data_shard
        if shard is None:
            return model.module(features, generator=generator), gt
        local = shard.rows(features)
        if shard.points is not None:
            local = shard.points.local(local).contiguous()
        preds = model.module(local, generator=generator)

        def whole(value):
            return all_gather_rows(value, shard.group)[:real]
        if isinstance(preds, dict):
            preds = {k: whole(v) for k, v in preds.items()}
        else:
            preds = whole(preds)
        gt = {k: v[:real] for k, v in gt.items()} if isinstance(gt, dict) else gt[:real]
        return preds, gt

    def _place(self, batch):
        """(features, ground truth) on the device; the features are points
        or a mesh dict, the ground truth a dict of tensors (the shape
        models) or one tensor (the stitch model's (B, P) labels)."""
        def place(value):
            if isinstance(value, dict):
                return {k: v.to(self.device, non_blocking=True) for k, v in value.items()}
            return value.to(self.device, non_blocking=True)
        features = place(batch['features'])
        if not isinstance(features, dict):
            features = features.float()
        return features, place(batch['ground_truth'])

    def _sample(self, features, gt, generator, labels):
        """A mesh-dict batch's cloud drawn on the device by
        `device_sampler` from `generator`, with the snapped labels in the
        ground truth when `labels` (the snap runs only then). Points pass
        through."""
        if not isinstance(features, dict):
            return features, gt
        if self.device_sampler is None:
            raise ValueError('Trainer: mesh features need trainer.device_sampler '
                             '(fit sets it from dataset.on_device_sampling)')
        features, segm = self.device_sampler(generator, features, labels=labels)
        if labels:
            gt = dict(gt, segmentation=segm)
        return features, gt

    def train_step(self, model, batch, epoch, generator=None, sampling_generator=None):
        """One optimizer step on `batch`: train-mode forward (batch
        statistics, BN running averages updated), the composed loss at the
        epoch's phase, backward, update. The lr is the schedule at the
        number of steps taken before this one. `generator` draws the LSTM
        decoders' random initial states, their dropout masks and the loss's
        random GT panel order (the JAX step's three rng streams);
        `sampling_generator` a mesh batch's cloud (`_sample`). Returns
        (loss, dict of the loss terms and quality metrics), detached, on the
        device. Under a data mesh (`use_mesh`) the loss is the whole batch's
        and the gradients, left on the parameters, are summed over the
        ranks."""
        if self.optimizer is None:
            raise RuntimeError('Trainer: call make_optimizer before train_step')
        with tracing.span('gpe.train_step'):
            with tracing.span('gpe.forward'):
                batch, real = self._pad(batch)
                features, gt = self._sample(*self._place(batch), sampling_generator,
                                            reads_segmentation(model.loss))
                epoch_c = canonical_epoch(model.loss.config, *phase_of(model.loss.config, epoch))
                for group in self.optimizer.param_groups:
                    group['lr'] = self.schedule(self.step_count)
                model.module.train()
                self.optimizer.zero_grad(set_to_none=True)
                preds, gt = self._forward(model, features, gt, real, generator)
            with tracing.span('gpe.loss'):
                loss, loss_dict, _ = model.loss(preds, gt, epoch=epoch_c, generator=generator)
            with tracing.span('gpe.backward'):
                shard = self.data_shard
                if shard is not None and shard.points is not None and shard.points.rank > 0:
                    # the loss's backward on the first points rank of each data
                    # slice alone: the others get their cotangents through the
                    # pools' sums
                    (loss * 0.0).backward()
                else:
                    loss.backward()
                if shard is not None:
                    sum_gradients(model.module.parameters(), shard.stats_group)
            with tracing.span('gpe.optimizer'):
                self.optimizer.step()
        self.step_count += 1
        return loss.detach(), {k: v.detach() for k, v in loss_dict.items()}

    @torch.no_grad()
    def eval_step(self, model, batch, epoch, generator=None, sampling_generator=None):
        """Eval-mode forward (running statistics, the fused EdgeConv kernel
        on the card) and the composed loss with its quality metrics.
        `generator` draws the LSTM decoder's random initial states, as the
        JAX trainer's eval step draws them from its 'recurrent_init' rng;
        without one they are zeros. The loss draws its random GT panel order
        from it too; `sampling_generator` draws a mesh batch's cloud.
        Returns (loss, dict): under a data mesh the whole batch's."""
        batch, real = self._pad(batch)
        features, gt = self._sample(*self._place(batch), sampling_generator,
                                    reads_segmentation(model.loss))
        epoch_c = canonical_epoch(model.loss.config, *phase_of(model.loss.config, epoch))
        model.module.eval()
        preds, gt = self._forward(model, features, gt, real, generator)
        loss, loss_dict, _ = model.loss(preds, gt, epoch=epoch_c, generator=generator)
        return loss, loss_dict

    # ------------- fit -------------
    def fit(self, model, state=None):
        """Train `model` (`models.GarmentModel`) over the dataset for
        `setup['epochs']` epochs, resuming from the run's 'latest'
        checkpoint when the tracker's run exists
        (garment_pattern_estimation_tpu/train/trainer.py:286-551). `state`
        is a state dict of the module to start from (e.g.
        `models.flax_import.state_dict_from_flax` of JAX variables); None
        keeps the module's weights. Returns the module's final state dict.

        Losses stay on the device through an epoch's batches and are
        fetched once per epoch. Under `compute_dtype: bfloat16` the last
        `f32_tail_epochs` epochs (or every epoch after an early-stop signal
        in the bf16 phase) run the module in f32, parameters and optimizer
        state shared; the module's compute dtypes are restored on return.

        Under `dataset.on_device_sampling` each training step draws its
        cloud from the stream of its step, validation from the epoch's
        stream, each offset by SAMPLING_STREAM from the LSTM states' stream
        of the same step or epoch (those streams are unchanged). A profiler
        window (`trainer.profile`) still open when fit ends is stopped and
        written.

        Under a process group fit trains data-parallel over `trainer.mesh`
        (`mesh_from_setup`, `use_mesh`), and returns to one process when it
        ends; only the first rank writes the run's files, renders images
        and profiles."""
        if not self.datawrapper:
            raise RuntimeError('Trainer: fit called before use_dataset()')
        if self.experiment is None:
            raise RuntimeError('Trainer: fit needs an experiment tracker')
        mesh = self.mesh_from_setup()
        if self._root_seed is None:
            self.init_randomizer()

        start_epoch = self._start_experiment(model)
        # loaders and the schedule only after _start_experiment: a resumed
        # run reloads its stored split there
        train_loader = self.datawrapper.loaders.train
        valid_loader = self.datawrapper.loaders.validation
        # batches assembled in this thread: the step's host time (Python
        # dispatch) is the bottleneck, and a prefetch thread holding the
        # interpreter lock slows it by more than it overlaps (PERF.md §5,
        # fit); page-locked batches, so their copies to the card do not
        # wait for the previous step's kernels
        for loader in (train_loader, valid_loader):
            loader.prefetch = 0
            loader.pin_memory = self.device.type == 'cuda'
        if len(train_loader) == 0:
            raise ValueError(
                f'Trainer: training subset ({len(self.datawrapper.training)} '
                f'samples) produces no batches at batch_size='
                f'{self.datawrapper.batch_size} (partial batches are '
                'dropped): lower trainer.batch_size or provide more data')
        if state is not None:
            model.module.load_state_dict(state)
        self.make_optimizer(model, len(train_loader))
        # after _start_experiment: a resumed run's restored config decides
        # whether the on-device sampling stage is part of the step
        self.device_sampler = maybe_batch_sampler(self.datawrapper.dataset.config)
        sampling = self.device_sampler is not None

        if start_epoch > 0:
            checkpoint = self.experiment.get_checkpoint_file('latest', map_location=self.device)
            model.module.load_state_dict(checkpoint['model'])
            self.optimizer.load_state_dict(checkpoint['optimizer'])
            self.step_count = checkpoint['step']
            self.experiment.checkpoint_counter = max(
                self.experiment.checkpoint_counter, start_epoch)
            print(f'Trainer::Resumed run from epoch {start_epoch}')
        if mesh is not None:
            self.use_mesh(model, mesh)
            points = self.data_shard.points
            print(f'Trainer::data-parallel mesh over {self.data_shard.size} ranks'
                  + (f' x {points.size} points ranks' if points is not None else ''))

        # under a points mesh every rank runs the images' forward on its
        # points, and the first rank writes
        sharded = self.data_shard is not None and self.data_shard.points is not None
        log_images = self.log_with_visualization and (is_first_rank() or sharded)
        if log_images and is_first_rank():
            self.folder_for_preds = Path(self.experiment.run_dir()) / 'intermediate_preds'
            self.folder_for_preds.mkdir(exist_ok=True)

        best_valid_loss = self.experiment.last_best_validation_loss()
        best_monitor = self.experiment.summary.get('best_monitor') \
            if self._monitor_key else None
        es_tracking = []
        loss_config = model.loss.config
        log_step = self.step_count - 1

        bf16 = model.config.get('compute_dtype') not in (None, 'float32')
        f32_tail = int(self.setup.get('f32_tail_epochs', 0) or 0)
        tail_start = self.setup['epochs'] - f32_tail if f32_tail else None
        stored_tail = self.experiment.summary.get('f32_tail_entered')
        if tail_start is not None and stored_tail is not None:
            tail_start = min(tail_start, int(stored_tail))
        dtypes = {m: m.compute_dtype for m in model.module.modules()
                  if hasattr(m, 'compute_dtype')}
        in_tail = False
        try:
            for epoch in range(start_epoch, self.setup['epochs']):
                if tail_start is not None and epoch >= tail_start and bf16 and not in_tail:
                    in_tail = True
                    for m in dtypes:
                        m.compute_dtype = None
                    print(f'Trainer::precision tail: compute_dtype bfloat16 -> float32 '
                          f'for the final {self.setup["epochs"] - epoch} epochs')
                epoch_start = time.perf_counter()

                pending, waits = [], []
                batches = iter(train_loader)
                for batch_i in range(len(train_loader)):
                    wait_start = time.perf_counter()
                    try:
                        batch = next(batches)
                    except StopIteration:
                        break
                    step_start = time.perf_counter()
                    self._maybe_profile(self.step_count)
                    stream = self.step_count + 1
                    loss, loss_dict = self.train_step(
                        model, batch, epoch, self._generator(stream),
                        self._generator(SAMPLING_STREAM + stream) if sampling else None)
                    log_step += 1
                    pending.append((log_step, batch_i, self.step_count - 1, loss, loss_dict,
                                    time.perf_counter() - step_start,
                                    step_start - wait_start))

                # one transfer for the whole epoch's losses and metrics
                names = sorted(pending[0][4]) if pending else []
                fetched = torch.stack([
                    torch.stack([p[3].float()] + [p[4][k].float() for k in names])
                    for p in pending]).cpu().numpy() if pending else np.zeros((0, 1))
                train_time = time.perf_counter() - epoch_start
                epoch_losses = fetched[:, 0]
                last_loss = np.nan if np.any(np.isnan(epoch_losses)) \
                    else (float(epoch_losses[-1]) if len(epoch_losses) else np.nan)
                for (lstep, bi, sc, _, _, step_time, data_time), row in zip(pending, fetched):
                    record = {k: float(v) for k, v in zip(names, row[1:])}
                    record.update(epoch=epoch, batch=bi, loss=float(row[0]),
                                  learning_rate=float(self.schedule(sc)),
                                  step_time=step_time, data_time=data_time)
                    self.experiment.log(record, step=lstep)

                # validation: one transfer at the end
                valid_losses, valid_monitors = [], []
                for batch in valid_loader:
                    # the same streams for every batch: validation sees the
                    # same clouds whenever it runs at a given epoch
                    stream = 2 ** 20 + epoch
                    vloss, vdict = self.eval_step(
                        model, batch, epoch, self._generator(stream),
                        self._generator(SAMPLING_STREAM + stream) if sampling else None)
                    valid_losses.append(vloss)
                    if self._monitor_key:
                        if self._monitor_key not in vdict:
                            if not self._monitor_warned_absent:
                                self._monitor_warned_absent = True
                                print(f'Trainer::Warning::best_by metric '
                                      f'{self._monitor_key!r} not in the validation loss '
                                      f'dict this phase (available: {sorted(vdict)}); '
                                      'using the validation-loss rule until it appears')
                        else:
                            valid_monitors.append(vdict[self._monitor_key])
                valid_loss = float(torch.stack(valid_losses).float().mean()) \
                    if valid_losses else float('nan')
                valid_monitor = float(torch.stack(valid_monitors).float().mean()) \
                    if valid_monitors else None

                structure_update = (
                    epoch == loss_config.get('epoch_with_stitches', 40)
                    and any(c in loss_config['loss_components']
                            for c in ('stitch', 'stitch_supervised', 'free_class'))
                ) or (epoch == loss_config.get('epoch_with_order_matching', 0)
                      and loss_config.get('panel_order_inariant_loss', False))
                improved = self._best_update(valid_loss, valid_monitor, best_valid_loss,
                                             best_monitor, self._monitor_max)
                if structure_update or improved:
                    best_valid_loss = valid_loss if np.isfinite(valid_loss) else None
                    if valid_monitor is not None:
                        best_monitor = valid_monitor if np.isfinite(valid_monitor) else None
                    self._save_checkpoint(model, epoch, best=True)
                else:
                    self._save_checkpoint(model, epoch)

                print(f'Epoch: {epoch}, Validation Loss: {valid_loss}')
                epoch_record = {'epoch': epoch, 'valid_loss': valid_loss,
                                'best_valid_loss': best_valid_loss,
                                'compute_dtype': 'float32' if in_tail or not bf16
                                else 'bfloat16',
                                # wall seconds: the epoch, its batch loop up to the
                                # losses' fetch, and the loop's waits on the loader
                                'epoch_time': time.perf_counter() - epoch_start,
                                'train_time': train_time,
                                'data_time': float(sum(p[6] for p in pending))}
                if valid_monitor is not None:
                    epoch_record[f'valid_{self._monitor_key}'] = valid_monitor
                    epoch_record['best_monitor'] = best_monitor
                    self.experiment.add_statistic('best_monitor', best_monitor)
                self.experiment.log(epoch_record, step=log_step)
                self.experiment.add_statistic('best_valid_loss', best_valid_loss)

                if log_images:
                    self._log_an_image(model, epoch, log_step)

                if self._early_stopping(es_tracking, last_loss, best_valid_loss,
                                        float(self.schedule(self.step_count))):
                    if (tail_start is not None and not in_tail and bf16
                            and not np.isnan(last_loss)):
                        # the bf16 phase converged before the scheduled tail:
                        # enter the f32 tail now instead of stopping
                        tail_start = epoch + 1
                        es_tracking.clear()
                        self.experiment.add_statistic('f32_tail_entered', tail_start)
                        print('Trainer::early-stop signal in the bf16 phase -> '
                              'entering the f32 precision tail early')
                        continue
                    print('Trainer::Stopped training early')
                    break
        finally:
            for m, dtype in dtypes.items():
                m.compute_dtype = dtype
            if self._profiler is not None:
                self._profile_stop()
            if mesh is not None:
                self.use_mesh(model, None)

        print('Trainer::Finished training')
        return model.module.state_dict()

    # ------------- internals -------------
    def _start_experiment(self, model):
        """Start or resume the tracker's run; a resumed run reloads its
        stored split and data config
        (garment_pattern_estimation_tpu/train/trainer.py:584)."""
        self.experiment.init_run({'trainer': self.setup})
        if self.experiment.resumed:
            start_epoch = self.experiment.last_epoch() + 1
            split, batch_size, data_config = self.experiment.data_info()
            self.datawrapper.dataset.update_config(data_config)
            self.datawrapper.load_split(split, batch_size)
        else:
            start_epoch = 0
            if is_first_rank():
                self.datawrapper.save_to_wandb(self.experiment)
                self.experiment.add_config('NN', model.config)
        return start_epoch

    def _maybe_profile(self, step_count):
        """Start or stop the `trainer.profile` window before the step
        numbered `step_count` (the optimizer steps taken before it, resumed
        runs included): it starts at `start_step` and stops at
        `start_step + num_steps` (garment_pattern_estimation_tpu/train/
        trainer.py:564). Under a process group the first rank profiles."""
        profile_cfg = self.setup.get('profile')
        if not profile_cfg or not is_first_rank():
            return
        start = profile_cfg.get('start_step', 10) if isinstance(profile_cfg, dict) else 10
        steps = profile_cfg.get('num_steps', 5) if isinstance(profile_cfg, dict) else 5
        if step_count == start and self._profiler is None:
            trace_dir = Path(self.experiment.run_dir()) / 'profile'
            trace_dir.mkdir(exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self._profile_file = trace_dir / f'steps_{start}-{start + steps}.pt.trace.json'
            print(f'Trainer::profiler trace started -> {trace_dir}')
        elif self._profiler is not None and step_count == start + steps:
            self._profile_stop()

    def _profile_stop(self):
        """Stop the profiler window and write its Chrome trace."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        profiler, self._profiler = self._profiler, None
        profiler.stop()
        profiler.export_chrome_trace(str(self._profile_file))
        print(f'Trainer::profiler trace stopped -> {self._profile_file}')

    def _save_checkpoint(self, model, epoch, best=False):
        """(garment_pattern_estimation_tpu/train/trainer.py:597)"""
        state = {'epoch': epoch, 'step': self.step_count,
                 'model': model.module.state_dict(),
                 'optimizer': self.optimizer.state_dict()}
        self.experiment.save_checkpoint(state, aliases=['best'] if best else [])

    @torch.no_grad()
    def _log_an_image(self, model, epoch, log_step):
        """Save one predicted pattern per data folder, rendered, into
        `intermediate_preds/` and log each image's path as
        'pred_img::<file name>' (garment_pattern_estimation_tpu/train/trainer.py:654).
        Unlike the JAX trainer, nothing here is caught: the eval forward
        (the fused EdgeConv kernel on the card) raises as everywhere else,
        and `PatternSpec.serialize` already makes a failed render a
        warning. Mesh batches are sampled from the stream 2**21 + epoch,
        without the label snap. Under a points mesh every rank runs the
        forward on its points, the attention weights are gathered over the
        points ranks in global order where they are sharded (as
        `PointsShard.sizes` splits them), and the first rank writes."""
        loader = self.datawrapper.loaders.valid_single_per_data
        if loader is None:
            print('Trainer::Error::suitable loader is not available. Nothing logged')
            return
        points = self.data_shard.points if self.data_shard is not None else None
        model.module.eval()
        img_files = []
        for batch in loader:
            features, _ = self._place(batch)
            if isinstance(features, dict):
                features, _ = self._sample(features, None, self._generator(2 ** 21 + epoch),
                                           labels=False)
            if points is None:
                preds = model.module(features)
            else:
                preds = model.module(points.local(features).contiguous())
                shard = self._output_shard(model)
                if shard is not None and 'att_weights' in preds:
                    att = preds['att_weights']
                    total = shard.sum(att.new_tensor([float(att.shape[1])]))
                    preds['att_weights'] = shard.gather(att, shard.sizes(int(total.item())))
                if not is_first_rank():
                    continue
            preds = {k: v.float().cpu().numpy() for k, v in preds.items()}
            img_files += self.datawrapper.dataset.save_prediction_batch(
                preds, batch['name'], batch['data_folder'], save_to=self.folder_for_preds)
        for img in img_files:
            self.experiment.log({f'pred_img::{img.name}': str(img), 'epoch': epoch},
                                step=log_step)

    @staticmethod
    def _best_update(valid_loss, valid_monitor, best_valid_loss, best_monitor,
                     monitor_max):
        """Should this epoch become the 'best' checkpoint? Without a monitor
        the lowest finite validation loss; with one (`best_by`) a strictly
        better monitor, equal monitors broken by the loss. NaNs never latch
        (garment_pattern_estimation_tpu/train/trainer.py:604)."""
        if valid_monitor is None:
            return bool(np.isfinite(valid_loss) and (
                best_valid_loss is None or not np.isfinite(best_valid_loss)
                or valid_loss < best_valid_loss))
        if not np.isfinite(valid_monitor):
            return False
        if best_monitor is None or not np.isfinite(best_monitor):
            return True
        sign = 1.0 if monitor_max else -1.0
        if sign * valid_monitor > sign * best_monitor:
            return True
        return bool(valid_monitor == best_monitor
                    and np.isfinite(valid_loss)
                    and (best_valid_loss is None
                         or not np.isfinite(best_valid_loss)
                         or valid_loss < best_valid_loss))

    def _early_stopping(self, es_tracking, last_loss, best_valid, last_lr):
        """A NaN loss, a flat best validation loss over `patience` epochs
        (within `window`) or a vanished learning rate stop the run
        (garment_pattern_estimation_tpu/train/trainer.py:630)."""
        if np.isnan(last_loss):
            self.experiment.add_statistic('stopped early', 'Nan in losses',
                                          log='Trainer::EarlyStopping')
            return True
        if best_valid is not None:
            es_tracking.append(float(best_valid))
        patience = int(self.setup.get('early_stopping', {}).get('patience', 50))
        window = float(self.setup.get('early_stopping', {}).get('window', 1e-4))
        if len(es_tracking) > patience + 1:
            es_tracking.pop(0)
            if abs(max(es_tracking) - min(es_tracking)) < window:
                self.experiment.add_statistic(
                    'stopped early', f'Metric have not changed for {patience} epochs',
                    log='Trainer::EarlyStopping')
                return True
        if last_lr < 1e-6:
            self.experiment.add_statistic('stopped early', 'Learning Rate vanished',
                                          log='Trainer::EarlyStopping')
            return True
        return False
