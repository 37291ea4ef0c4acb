"""What the per-layer metrics read: `Run`, the record of a traced run, and
the arithmetic that several readers share. Each metric is a file
metrics/<name>.py whose `read(run)` returns its value, or None where the
run has nothing for it to read (then the metric is left out of the line).
"""
from __future__ import annotations

from dataclasses import dataclass

from . import yardstick
from .trace import own_kernel_ns


@dataclass
class Run:
    kind: str                 # the entry: 'serve' or 'train'
    config: dict
    traffic: dict
    trace: object             # trace.Trace of the profiled window
    iterations: int           # batches or steps inside it
    counters: dict            # {family: {(variant, N, C, k): launches}} inside it
    families: dict            # kernels/<family>.json by family
    peak_window_bytes: int | None   # allocated peak over the measured window (training)
    measured: tuple           # (iterations, seconds) of the measured window, untraced

    def symbols(self):
        return [s for spec in self.families.values() for s in spec['symbols']]

    def own_and_other_ns(self):
        return own_kernel_ns(self.trace, self.symbols())


def model_share_of_peak(run, kind):
    """Operations of the measured window's iterations over what the chip's
    peak does in its seconds, in %; None for another entry."""
    iterations, seconds = run.measured
    if run.kind != kind or iterations == 0 or seconds <= 0:
        return None
    ops = yardstick.model_operations(run.config, run.traffic['batch'], run.traffic['points'],
                                     train=kind == 'train')
    return 100.0 * ops * iterations / (seconds * yardstick.PEAK_FLOPS)


def kernels_roofline(run, kind):
    """Sum of the launches' least times over the port's own kernels' device
    time, in %; None for another entry or without own kernels in the trace.
    A launch of a variant that kernels/<family>.json does not list raises:
    a kernel the yardstick does not count would leave the metric wrong."""
    if run.kind != kind:
        return None
    own_ns, _ = run.own_and_other_ns()
    if own_ns <= 0:
        return None
    widths = yardstick.edge_widths(run.config['NN'])
    bound = 0.0
    for family, launches in run.counters.items():
        costs = run.families[family]['costs']
        for (variant, N, C, k), count in launches.items():
            if variant not in costs:
                raise KeyError(f'kernels/{family}.json lists no cost of the launched '
                               f'variant {variant!r}')
            if costs[variant] is None:
                continue
            ops, n_bytes = yardstick.COSTS[costs[variant]](run.traffic['batch'], N, C, k, widths)
            bound += count * yardstick.bound_seconds(ops, n_bytes)
    return 100.0 * bound / (own_ns / 1e9) if bound > 0 else None


def idle_share(run, kind):
    """Share of the measured window's time with no device operation, in %:
    the traced window's busy time per iteration over the measured window's
    time per iteration. Tracing slows the host of a host-bound loop, not
    the kernels, so the untraced window's pace is the one users see."""
    iterations, seconds = run.measured
    if run.kind != kind or not run.trace.device or run.iterations == 0 or iterations == 0:
        return None
    busy = run.trace.busy_ns() / 1e9 / run.iterations
    return 100.0 * (1.0 - busy / (seconds / iterations))
