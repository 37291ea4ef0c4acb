#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on this machine's cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (model, weights and inputs from the seed, warm-up, the first
training steps) is timed as `setup_s` from the process's start. Then a
window of `--seconds` is measured. With `--trace 1` a profiled steady
window follows, and the per-layer metrics are printed in place of the
end-to-end ones. Last, the program's state is freed and the plain
reference checks what the window produced.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `checks`, each compared number with its limit (also
the last lines of standard error). The run exits 2 without a result where
the cards are missing, and 3 where a module of JAX or of the JAX package
has loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# read by the caching allocator before the first card allocation; no
# library that the port loads may bring in flax; the host side is one
# Python thread launching kernels, so the CPU's thread pool is kept to one
os.environ.setdefault('PYTORCH_CUDA_ALLOC_CONF', 'expandable_segments:True')
os.environ['USE_FLAX'] = '0'
os.environ.setdefault('OMP_NUM_THREADS', '1')
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import common  # noqa: E402


def device_info(device, chips, peak_bytes):
    import torch

    if torch.device(device).type == 'cuda':
        return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': chips,
                'memory_peak_bytes': int(peak_bytes)}
    return {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': 0}


def run_cell(name, seed, seconds, trace, *, device='cuda', bench=None, cell=None,
             t_start=None, log=sys.stderr):
    """The result dict of one run of cell `name` (its files read from the
    manifest unless `cell` is given). Raises SystemExit(3) where a
    forbidden module has loaded once the window has closed."""
    import torch

    from benchmark.entries import entry_class
    from benchmark.readers import Run
    from benchmark.reference import compare

    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or common.manifest()
    cell = cell or common.cell(name, bench)
    e2e, per_layer = common.metrics_of(name, bench)
    traffic, cuda = cell['traffic'], torch.device(device).type == 'cuda'

    # the CUDA context, made apart so that the set-up's phases show it
    before = time.perf_counter()
    torch.zeros(1, device=device)
    context = time.perf_counter()
    entry = entry_class(traffic['entry'])(cell, device, seed)
    # what set-up made lives through the window: out of the collector's scans
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    print(f'setup {setup_s:.3f} s: interpreter and torch {before - t_start:.3f} s, '
          f'CUDA context {context - before:.3f} s, {entry.phases}', file=log)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    values = entry.window(seconds)
    values['setup_s'] = setup_s
    result = {}
    if trace:
        window, iterations, counters = entry.traced(traffic['trace_seconds'],
                                                    traffic['trace_max_iterations'])
        labelled, _, _ = entry.traced(traffic['trace_seconds'], 3, host=True)
        run = Run(kind=entry.kind, config=cell['config'], traffic=traffic, trace=window,
                  iterations=iterations, counters=counters, families=common.kernel_families(),
                  peak_window_bytes=getattr(entry, 'peak_window_bytes', None),
                  measured=entry.measured)
        metrics = {}
        for metric in per_layer:
            value = common.load_reader(metric['name'])(run)
            if value is not None:
                metrics[metric['name']] = {'value': value, 'unit': metric['unit']}
        busy = window.busy_ns() / 1e9
        result['breakdown'] = {'device_ops': window.top_device_ops(),
                               'idle_gaps': labelled.idle_gaps()}
        extra = {'busy_s': busy, 'window_s': window.window_ns / 1e9}
        print(f'trace: {iterations} iterations in {window.window_ns / 1e9} s, '
              f'{len(window.device)} device operations, {window.overlap_ns() / 1e9} s of them '
              f'beside another; labels: {len(labelled.host)} host ranges', file=log)
    else:
        metrics = {m['name']: {'value': values[common.quantity(m['name'], values)],
                               'unit': m['unit']} for m in e2e}
        extra = {}
    found = common.forbidden_loaded()
    if found:
        print(f'run: forbidden modules loaded: {found}', file=log)
        raise SystemExit(3)
    peak = max(setup_peak, torch.cuda.max_memory_allocated() if cuda else 0)
    attempted = entry.measured[0]
    failed = entry.failed()
    numbers = entry.numbers()
    correct, checks = compare.judge(numbers, cell['limits']['numbers'])
    result = {'correct': correct and failed == 0, 'attempted': attempted, 'failed': failed,
              'metrics': metrics, 'device': {**device_info(device, cell['workload']['chips'],
                                                           peak), **extra},
              **result, 'checks': checks}
    for key in numbers.keys() - checks.keys():
        print(f'number {key}: {numbers[key]} (not compared)', file=log)
    for key, check in checks.items():
        print(f"check {key}: {check['value']} (limit {check['limit']})", file=log)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = common.manifest()
    cell = common.cell(args.workload, bench)
    import torch

    chips = cell['workload']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'run: {args.workload} needs {chips} CUDA card(s); '
              f'this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench,
                      cell=cell, t_start=T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
