"""What every part of the benchmark shares: the manifest and the files it
names, the seeds, the check for modules that must not load, and the result.

The harness is driven by data. A cell of `BENCHMARK.json`'s `workloads`
names a configuration and a traffic mix; each is a file of its own:

    configs/<config>.json     the model configuration as it is run
    traffic/<traffic>.json    the traffic mix: entry, batch, points, pool
    limits/<cell>.json        the limit of each number the check compares
    metrics/<metric>.py       the reader of one per-layer metric (or of its
                              quantity, for `<quantity>.<cell group>`)
    kernels/<family>.json     the port's own kernels of one family

so a new cell, configuration or metric is new files and entries only.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / 'BENCHMARK.json'

# top-level module names that may not load in a run: the JAX package and JAX
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'garment_pattern_estimation_tpu')


def load_json(path):
    return json.loads(Path(path).read_text())


def manifest():
    return load_json(MANIFEST)


def cell(name, bench=None):
    """The `workloads` entry of `name` with its configuration, traffic and
    limits read from their files: {'workload', 'config', 'traffic',
    'limits'}. KeyError for an unknown cell."""
    bench = bench or manifest()
    by_name = {w['name']: w for w in bench['workloads']}
    if name not in by_name:
        raise KeyError(f'unknown workload {name!r} (known: {sorted(by_name)})')
    workload = by_name[name]
    return {'workload': workload,
            'config': load_json(HERE / 'configs' / f"{workload['config']}.json"),
            'traffic': load_json(HERE / 'traffic' / f"{workload['traffic']}.json"),
            'limits': load_json(HERE / 'limits' / f'{name}.json')}


def metrics_of(name, bench=None):
    """(end-to-end entries, per-layer entries) that cell `name` reports. An
    end-to-end metric without `workloads` belongs to every cell; a per-layer
    metric without it to every cell that reports its `moves`."""
    bench = bench or manifest()
    e2e = [m for m in bench['end_to_end'] if name in m.get('workloads', [name])]
    names = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if (name in m['workloads'] if 'workloads' in m else m['moves'] in names)]
    return e2e, per_layer


def derived_seed(seed, *parts):
    """A 63-bit seed from the run's seed and a path of names or numbers: the
    same arguments give the same seed in every process."""
    text = '/'.join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], 'little') >> 1


def forbidden_loaded(modules=None):
    """The forbidden top-level names among the loaded modules' names, each
    compared whole (the part before the first dot)."""
    names = {name.split('.', 1)[0] for name in (modules if modules is not None else sys.modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def quantity(metric_name, known):
    """The name among `known` that a metric measures: itself, or, for a
    metric split by cell as `<quantity>.<cell group>`, its quantity.
    KeyError where there is none."""
    name = metric_name
    while name not in known:
        if '.' not in name:
            raise KeyError(f'no quantity of {known} is measured as {metric_name}')
        name = name.rsplit('.', 1)[0]
    return name


def load_reader(metric_name):
    """The `read(run)` function of metrics/<metric_name>.py, or, for a
    metric split by cell as `<quantity>.<cell group>`, of the quantity's
    metrics/<quantity>.py."""
    readers = {p.stem for p in (HERE / 'metrics').glob('*.py')}
    path = HERE / 'metrics' / f'{quantity(metric_name, readers)}.py'
    spec = importlib.util.spec_from_file_location(f'benchmark_metric_{metric_name}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kernel_families():
    """Every kernels/<family>.json: the port's own kernels by symbol and
    the cost function of each launch counter's variant."""
    return {p.stem: load_json(p) for p in sorted((HERE / 'kernels').glob('*.json'))}
