"""The entries a traffic mix drives, one module each (`serve`, `train`),
found by the traffic file's `entry`. Each defines `Entry(cell, device,
seed)`, whose construction is the set-up, with:

    phases                   a SetupClock: the seconds of each phase of
                             the set-up, for standard error
    window(seconds)          the measured window; returns its end-to-end
                             values by quantity, and keeps `measured`,
                             its (iterations, seconds)
    traced(seconds, n, host) a profiled steady window after it; returns
                             what the per-layer readers read
    failed()                 the window's iterations whose outputs are not
                             finite
    numbers(lowered=False)   after the windows: the program's state freed,
                             the reference run, the compared numbers (with
                             `lowered`, those of the control: the reference
                             in the next lower precision in the program's
                             place)
"""
from __future__ import annotations

import contextlib
import importlib
import time

import torch

from ..trace import Trace, profiler_events


class SetupClock:
    """The seconds of each named phase of a set-up, in order, each from the
    end of the one before (the first from the clock's making); a phase's
    end waits for the device."""

    def __init__(self, device):
        self.device, self.last, self.phases = device, time.perf_counter(), []

    def mark(self, name):
        sync(self.device)
        now = time.perf_counter()
        self.phases.append((name, now - self.last))
        self.last = now

    def __str__(self):
        return ', '.join(f'{name} {seconds:.3f} s' for name, seconds in self.phases)


def entry_class(name):
    return importlib.import_module(f'{__name__}.{name}').Entry


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def launch_counters():
    """The port's launch counters by kernel family: {family: Counter of
    (variant, N, C, k)}, from the modules kernels/<family>.json names."""
    from ..common import kernel_families

    return {family: importlib.import_module(spec['module']).launches_by_shape
            for family, spec in kernel_families().items()}


def reset_counters():
    for counter in launch_counters().values():
        counter.clear()


def read_counters():
    return {family: dict(counter) for family, counter in launch_counters().items()}


def profiled(device, one, seconds, max_iterations, host=False):
    """Run `one()` under torch.profiler: one call traced and dropped (the
    profiler's first cycle can lose a kernel), then calls for `seconds` or
    `max_iterations`, whichever ends first, between two synchronizations of
    the device. Returns (Trace of the window, iterations, launch counters
    of the window).

    On the card the profiler records the device's activity alone, whose
    cost to the host is small; with `host` it records the host's operators
    too, which slows a host-bound loop several times over, and the window
    is the 'bench.window' annotation (the idle gaps' labels read it)."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    cuda = torch.device(device).type == 'cuda'
    activities = [ProfilerActivity.CUDA] if cuda and not host else \
        [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        one()
        sync(device)
        prof.step()
        reset_counters()
        iterations = 0
        with record_function('bench.window'):
            sync(device)
            start = time.perf_counter_ns()
            while iterations < max_iterations and (
                    iterations == 0 or time.perf_counter_ns() - start < seconds * 1e9):
                one()
                iterations += 1
            sync(device)
            elapsed = time.perf_counter_ns() - start
        prof.step()
    counters = read_counters()
    events = list(profiler_events(prof))
    windows = [(s, e) for name, kind, s, e in events
               if name == 'bench.window' and kind == 'annotation']
    if windows:
        start_ns, end_ns = windows[0]
    else:
        starts = [s for _, kind, s, _ in events if kind == 'device']
        if not starts:
            raise RuntimeError('profiler: no device operation and no bench.window annotation')
        start_ns = min(starts)
        end_ns = start_ns + elapsed
    return Trace.from_events(events, start_ns, end_ns), iterations, counters


@contextlib.contextmanager
def span(name):
    """A host range in the trace (`torch.profiler.record_function`)."""
    with torch.profiler.record_function(name):
        yield
