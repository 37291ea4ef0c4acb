"""Training: `Trainer.train_step` of the configuration's model after
`Trainer.make_optimizer`, back to back on batches of standardized clouds
and generated ground truth.

Traffic keys: `batch`, `points`, `meshes`, `pool_batches` (distinct
batches, cycled), `epoch` (the loss phase), `steps_per_epoch` (the
one-cycle schedule's), `checked_steps` (the first steps, which the check
follows), `warmup_steps` (steps before the window, the checked ones
included), `trace_seconds` and `trace_max_iterations`.

Set-up builds one model, trainer and optimizer, drives them from the seed
through the first steps on distinct batches, each step's LSTM states drawn
from a generator seeded for that step, and hands the same objects to the
window. The window ends in a synchronize.
"""
from __future__ import annotations

import gc
import time

import torch

from . import SetupClock, profiled, span, sync
from .. import traffic as generator
from ..common import derived_seed
from ..reference import compare
from ..reference import model as reference

ADAM_BETA1 = 0.9


class Entry:
    kind = 'train'

    def __init__(self, cell, device, seed):
        self.phases = SetupClock(device)
        from garment_pattern_estimation_torch.models import build_model
        from garment_pattern_estimation_torch.train.trainer import Trainer

        self.phases.mark('import')
        self.config, self.traffic = cell['config'], cell['traffic']
        self.device, self.seed = torch.device(device), seed
        cfg, tr = self.config, self.traffic
        self.batch = tr['batch']
        self.pool = generator.training_pool(tr, cfg['data'], seed, self.device)
        self.phases.mark('clouds')
        model = build_model(cfg['model'], cfg['data'], cfg['NN'], cfg['loss'], device=self.device)
        model.module.load_state_dict(
            reference.make_weights(cfg, derived_seed(seed, 'weights'), self.device), strict=True)
        self.model = model
        self.trainer = Trainer(cfg['trainer'], device=self.device)
        optimizer = self.trainer.make_optimizer(model, tr['steps_per_epoch'])
        params = dict(model.module.named_parameters())
        self.phases.mark('model')
        self.first = {'losses': []}
        self.steps = 0
        for step in range(tr['checked_steps']):
            loss, _ = self._step(self._step_generator(step))
            self.first['losses'].append(loss.item())
            if step == 0:
                self.first['grad1'] = {n: (optimizer.state[p]['exp_avg'] / (1 - ADAM_BETA1)).cpu()
                                       for n, p in params.items()}
        self.first['params'] = {n: p.detach().cpu().clone() for n, p in params.items()}
        self.first['buffers'] = {n: b.cpu().clone() for n, b in model.module.named_buffers()
                                 if n.endswith(('running_mean', 'running_var'))}
        self.phases.mark('checked steps')
        self.generator = torch.Generator(device=self.device).manual_seed(
            derived_seed(seed, 'window'))
        while self.steps < tr['warmup_steps']:
            self._step(self.generator)
        self.phases.mark('warm-up')
        self.losses, self.peak_window_bytes = [], None

    def _step_generator(self, step):
        return torch.Generator(device=self.device).manual_seed(derived_seed(self.seed, 'step', step))

    def _step(self, gen):
        with span('bench.train_step'):
            loss, terms = self.trainer.train_step(
                self.model, self.pool[self.steps % len(self.pool)], self.traffic['epoch'], gen)
        self.steps += 1
        return loss, terms

    def window(self, seconds):
        cuda = self.device.type == 'cuda'
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        start = time.perf_counter()
        n = 0
        while time.perf_counter() - start < seconds:
            loss, _ = self._step(self.generator)
            self.losses.append(loss)
            n += 1
        sync(self.device)
        elapsed = time.perf_counter() - start
        self.measured = (n, elapsed)
        if cuda:
            self.peak_window_bytes = torch.cuda.max_memory_allocated(self.device)
        return {'train_clouds_per_s': n * self.batch / elapsed}

    def traced(self, seconds, max_iterations, host=False):
        return profiled(self.device, lambda: self._step(self.generator), seconds, max_iterations,
                        host)

    def failed(self):
        """Window steps whose loss is not finite."""
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def release(self):
        self.model = self.trainer = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def numbers(self, lowered=False):
        """The training numbers of the first steps against the reference's
        steps on the same batches, weights, generators and learning rates;
        with `lowered`, the control's."""
        self.release()
        cfg, tr = self.config, self.traffic
        n = tr['checked_steps']
        seed = derived_seed(self.seed, 'weights')
        initial = reference.make_weights(cfg, seed, self.device)
        setup = cfg['trainer']
        total = max(setup['epochs'] * tr['steps_per_epoch'], 4)
        lrs = [reference.onecycle_lr(i, total, setup['learning_rate']) for i in range(n)]

        def run(low):
            gens = [self._step_generator(i) for i in range(n)]
            out = reference.train_steps(cfg, reference.make_weights(cfg, seed, self.device),
                                        self.pool[:n], gens, lrs, lowered=low)
            return {'losses': out['losses'],
                    **{key: {k: v.cpu() for k, v in out[key].items()}
                       for key in ('grad1', 'params', 'buffers')}}

        expected = run(False)
        got = run(True) if lowered else self.first
        return compare.training_numbers(got, expected, {k: v.cpu() for k, v in initial.items()})
