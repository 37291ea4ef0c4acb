"""Serving: `build_serving_fn(model, data_config)` of the configuration's
model, fed batches of clouds in physical units.

Traffic keys: `batch`, `points`, `meshes`, `pool_batches` (distinct
batches, cycled), `warmup_batches`, `check_clouds` (the most clouds the
check compares), `trace_seconds` and `trace_max_iterations`.

A closed loop with one client and one batch in flight: each batch is sent
from pinned host memory as soon as the previous one's whole output dict
is in pinned host memory, as a caller that decodes the pattern does. A
batch's latency runs from its send to its outputs on the host. One cloud
of each batch, chosen from the seed, keeps its outputs for the check.
"""
from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from . import SetupClock, profiled, span, sync
from .. import traffic as generator
from ..common import derived_seed
from ..reference import compare
from ..reference import model as reference


class Entry:
    kind = 'serve'

    def __init__(self, cell, device, seed):
        self.phases = SetupClock(device)
        from garment_pattern_estimation_torch.experiment import build_serving_fn
        from garment_pattern_estimation_torch.models import build_model

        self.phases.mark('import')
        self.config, self.traffic = cell['config'], cell['traffic']
        self.device, self.seed = torch.device(device), seed
        cfg, tr = self.config, self.traffic
        self.batch = tr['batch']
        self.pool = generator.serving_pool(tr, seed, self.device)
        self.phases.mark('clouds')
        model = build_model(cfg['model'], cfg['data'], cfg['NN'], cfg['loss'], device=self.device)
        model.module.load_state_dict(
            reference.make_weights(cfg, derived_seed(seed, 'weights'), self.device), strict=True)
        model.module.eval()
        self.model = model
        self.serve = build_serving_fn(model, cfg['data'])
        self.phases.mark('model')
        out = None
        for i in range(tr['warmup_batches']):
            out = self.serve(self.pool[i % len(self.pool)].to(self.device, non_blocking=True))
        pinned = self.device.type == 'cuda'
        self.host = {key: torch.empty(value.shape, dtype=value.dtype, pin_memory=pinned)
                     for key, value in out.items()}
        del out
        self.phases.mark('warm-up')
        self.keep = np.random.default_rng(derived_seed(seed, 'kept')).integers(
            self.batch, size=1 << 16)
        self.kept, self.latencies = [], []

    def _one(self, i):
        """Serve batch i: send, serve, copy the outputs to the host."""
        with span('bench.send'):
            x = self.pool[i % len(self.pool)].to(self.device, non_blocking=True)
        with span('bench.serve'):
            out = self.serve(x)
        with span('bench.receive'):
            for key, value in out.items():
                self.host[key].copy_(value, non_blocking=True)
            sync(self.device)

    def window(self, seconds):
        start = time.perf_counter()
        i = 0
        while time.perf_counter() < start + seconds:
            sent = time.perf_counter()
            self._one(i)
            self.latencies.append(time.perf_counter() - sent)
            c = int(self.keep[i % len(self.keep)])
            self.kept.append((i, c, {key: value[c].clone() for key, value in self.host.items()}))
            i += 1
        elapsed = time.perf_counter() - start
        self.measured = (i, elapsed)
        p95 = statistics.quantiles(self.latencies, n=20)[-1] if i > 1 else self.latencies[0]
        return {'serve_clouds_per_s': i * self.batch / elapsed, 'serve_batch_p95_ms': p95 * 1e3}

    def traced(self, seconds, max_iterations, host=False):
        count = iter(range(1 << 30))
        return profiled(self.device, lambda: self._one(next(count)), seconds, max_iterations,
                        host)

    def failed(self):
        """Batches whose kept cloud has a non-finite output."""
        return sum(not all(bool(torch.isfinite(v).all()) for v in out.values())
                   for _, _, out in self.kept)

    def release(self):
        """Free the program's state before the reference runs."""
        self.model = self.serve = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def numbers(self, lowered=False):
        """Gap of each output key over the checked clouds (every kept cloud,
        or `check_clouds` of them drawn from the seed); with `lowered`, the
        control's gaps on the same clouds."""
        self.release()
        kept = self.kept
        limit = self.traffic['check_clouds']
        if len(kept) > limit:
            pick = np.random.default_rng(derived_seed(self.seed, 'checked')).choice(
                len(kept), limit, replace=False)
            kept = [kept[j] for j in sorted(pick)]
        weights = reference.make_weights(self.config, derived_seed(self.seed, 'weights'),
                                         self.device)
        ref = reference.Reference(self.config, weights)
        low = reference.Reference(self.config, weights, lowered=True) if lowered else None
        group = max(1, 40000 // self.traffic['points'])
        ref_out, low_out = [], []
        for s in range(0, len(kept), group):
            clouds = torch.stack([self.pool[i % len(self.pool), c] for i, c, _ in kept[s:s + group]])
            clouds = clouds.to(self.device)
            ref_out.append({k: v.cpu() for k, v in ref.serve(clouds).items()})
            if low is not None:
                low_out.append({k: v.cpu() for k, v in low.serve(clouds).items()})

        def stacked(outs):
            return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

        expected = stacked(ref_out)
        got = stacked(low_out) if lowered else \
            {k: torch.stack([out[k] for _, _, out in kept]) for k in kept[0][2]}
        gaps = compare.output_gaps(got, expected, self.traffic['points'])
        return {f'gap.{key}': value for key, value in gaps.items()}
