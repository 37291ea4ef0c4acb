"""The port's spans (garment_pattern_estimation_torch/utils/tracing.py) over
a traced window, and the arithmetic of the readers that read them (source
`program_span`).

The port records its spans while torch.profiler records, so when the
readers run, its record holds those of the run's traced windows. `of(run)`
takes the record once per traced window, for every reader of the run, and
keeps each name's spans over the window, clipped to it. A program without
the recorder, or a window that no span overlaps, gives none, and each
reader then returns None.

    host_ms(run, kind, name)             host ms per traced iteration
                                         inside spans of `name`
    program_idle_share(run, kind, name)  the run's device idle share times
                                         the share of the window's
                                         device-idle ns inside spans of
                                         `name`, in %: at most the idle
                                         share; the rest is idle time
                                         outside the program
"""
from __future__ import annotations

from .readers import idle_share

_taken = [None, {}]          # the Trace last taken for, and its spans by name


def union(intervals):
    """Sorted disjoint [(start, end)] covering the same ns as `intervals`."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def overlap_ns(xs, ys):
    """Ns that two sorted lists of disjoint intervals share."""
    total = i = j = 0
    while i < len(xs) and j < len(ys):
        total += max(0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def clipped(trace, spans):
    """{name: union of its spans' intervals clipped to the trace's window};
    spans outside it, or still open, are dropped."""
    by_name = {}
    for span in spans:
        if span.end_ns is None:
            continue
        start, end = max(span.start_ns, trace.start_ns), min(span.end_ns, trace.end_ns)
        if end > start:
            by_name.setdefault(span.name, []).append((start, end))
    return {name: union(intervals) for name, intervals in by_name.items()}


def of(run):
    """The port's spans over run.trace's window, by name (`clipped`)."""
    if _taken[0] is not run.trace:
        try:
            from garment_pattern_estimation_torch.utils import tracing
        except ImportError:      # a program without the recorder
            recorded = []
        else:
            recorded = tracing.take()
        _taken[:] = run.trace, clipped(run.trace, recorded)
    return _taken[1]


def host_ms(run, kind, name):
    """Host ms per traced iteration inside spans of `name`; None for another
    entry or where the window holds none."""
    if run.kind != kind or run.iterations == 0:
        return None
    intervals = of(run).get(name)
    if not intervals:
        return None
    return sum(end - start for start, end in intervals) / 1e6 / run.iterations


def program_idle_share(run, kind, name):
    """`readers.idle_share` times the share of the traced window's
    device-idle ns that fall inside spans of `name`, in %; None for another
    entry or where the window holds none."""
    share = idle_share(run, kind)
    intervals = of(run).get(name)
    if share is None or not intervals:
        return None
    gaps = run.trace.gaps()
    idle = sum(end - start for start, end in gaps)
    return share * overlap_ns(intervals, gaps) / idle if idle else 0.0
