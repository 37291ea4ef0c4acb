#!/usr/bin/env python3
"""The readings that the limits of limits/<cell>.json are set from, and the
capacity sweep of a serving cell; run on the chip, one process per cell.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control 3 \
        [--seconds 3] [--first-seed N] [--sweep 0.5,0.8,1,1.2] [--out FILE]

For each of `--seeds` seeds: the cell's set-up, a window of `--seconds`,
then the numbers the check compares (the program against the reference).
For the first `--control` of them also the control's numbers: the
reference in the next lower precision put in the program's place (see
reference/model.py). For a training cell also the fault 'half': the
reference's steps on the first half of each batch (the mean over the
rest) in the program's place. One JSON line per reading.

`--sweep`: serving only; windows at these multiples of the rate that one
closed-loop window sustains, each reporting the completed rate and the
95th percentile of latency counted from each batch's due time.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault('PYTORCH_CUDA_ALLOC_CONF', 'expandable_segments:True')
os.environ.setdefault('OMP_NUM_THREADS', '1')

from benchmark import common  # noqa: E402


def emit(out, record):
    line = json.dumps(record)
    print(line, flush=True)
    if out is not None:
        with open(out, 'a') as handle:
            handle.write(line + '\n')


def half_fault(entry):
    """The training numbers of the reference on the first half of each
    checked batch, in the program's place."""
    from benchmark.common import derived_seed
    from benchmark.reference import compare
    from benchmark.reference import model as reference

    cfg, tr = entry.config, entry.traffic
    n = tr['checked_steps']
    seed = derived_seed(entry.seed, 'weights')
    total = max(cfg['trainer']['epochs'] * tr['steps_per_epoch'], 4)
    lrs = [reference.onecycle_lr(i, total, cfg['trainer']['learning_rate']) for i in range(n)]

    def run(batches):
        gens = [entry._step_generator(i) for i in range(n)]
        out = reference.train_steps(cfg, reference.make_weights(cfg, seed, entry.device),
                                    batches, gens, lrs)
        return {'losses': out['losses'], **{k: {n_: v.cpu() for n_, v in out[k].items()}
                                            for k in ('grad1', 'params', 'buffers')}}

    half = [{'features': b['features'][:len(b['features']) // 2],
             'ground_truth': {k: v[:len(v) // 2] for k, v in b['ground_truth'].items()}}
            for b in entry.pool[:n]]
    initial = {k: v.cpu() for k, v in reference.make_weights(cfg, seed, entry.device).items()}
    return compare.training_numbers(run(half), run(entry.pool[:n]), initial)


def sweep(entry, multiples, seconds):
    """The closed loop's rate, then an open loop at each multiple of it:
    batches fall due at a fixed rate, and latency counts from the due
    time."""
    capacity = entry.window(seconds)['serve_clouds_per_s'] / entry.batch
    rows = []
    for m in multiples:
        period = 1.0 / (capacity * m)
        done = []
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < seconds:
            due = start + i * period
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            entry._one(i)
            done.append(time.perf_counter() - due)
            i += 1
        elapsed = time.perf_counter() - start
        rows.append({'multiple': m, 'offered_batches_per_s': capacity * m,
                     'completed_batches_per_s': i / elapsed,
                     'p95_from_due_ms': statistics.quantiles(done, n=20)[-1] * 1e3})
    return capacity, rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, default=12)
    parser.add_argument('--control', type=int, default=3)
    parser.add_argument('--seconds', type=float, default=3.0)
    parser.add_argument('--first-seed', type=int, default=3_000_000_000)
    parser.add_argument('--sweep', default='')
    parser.add_argument('--out')
    args = parser.parse_args(argv)

    import torch

    from benchmark.entries import entry_class

    cell = common.cell(args.workload)
    kind = entry_class(cell['traffic']['entry'])
    emit(args.out, {'workload': args.workload, 'device': torch.cuda.get_device_name(0)})
    for j in range(args.seeds):
        seed = args.first_seed + 7919 * j
        start = time.perf_counter()
        entry = kind(cell, 'cuda', seed)
        setup_s = time.perf_counter() - start
        if args.sweep and j == 0:
            capacity, rows = sweep(entry, [float(m) for m in args.sweep.split(',')],
                                   args.seconds)
            emit(args.out, {'sweep': rows, 'closed_loop_batches_per_s': capacity})
            entry.kept, entry.latencies = [], []
        values = entry.window(args.seconds)
        record = {'seed': seed, 'setup_s': setup_s, **values,
                  'program': entry.numbers()}
        if j < args.control:
            record['control'] = entry.numbers(lowered=True)
            if entry.kind == 'train':
                record['fault_half'] = half_fault(entry)
        record['check_s'] = time.perf_counter() - start - setup_s - args.seconds
        emit(args.out, record)
        del entry
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
