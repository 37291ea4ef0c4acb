"""The reader of a device trace: torch.profiler's events over a traced
window, reduced to what the per-layer metrics read.

`Trace.from_events(profiler_events(prof), start_ns, end_ns)` keeps, inside the window,
the device's operations (kernels, copies, fills) and the host's operator
and annotation ranges; everything else is computed from those lists, so
a synthetic list tests it on the CPU:

    busy_ns()             union of the device operations' intervals
    idle_gaps()           device idle intervals, longest first, each named
                          by what the host was doing in it
    device_ns_by_name()   device time summed by operation name
"""
from __future__ import annotations

from dataclasses import dataclass, field

DEVICE_ACTIVITIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _ns(event, what):
    """An event's start or end in ns, across torch versions' event APIs."""
    if hasattr(event, f'{what}_ns'):
        return getattr(event, f'{what}_ns')()
    start = event.start_us() * 1000
    return start if what == 'start' else start + event.duration_us() * 1000


def profiler_events(prof):
    """(name, kind, start_ns, end_ns) of each event of a finished
    torch.profiler session; kind is 'device' (a kernel, copy or fill on the
    card), 'annotation' (a host range the code named) or 'host'. Where the
    events carry no activity type, a device event is one on the card that
    does not repeat a host annotation's name (nor carry the benchmark's own
    `bench.` prefix or the profiler's step)."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    typed = hasattr(events[0], 'activity_type') if events else True
    annotations = set()
    if not typed:
        annotations = {e.name() for e in events if e.device_type() == DeviceType.CPU
                       and (e.is_user_annotation() if hasattr(e, 'is_user_annotation')
                            else e.name().startswith(('bench.', 'ProfilerStep')))}
    for e in events:
        name = e.name()
        if typed:
            activity = e.activity_type()
            kind = 'device' if activity in DEVICE_ACTIVITIES else \
                'annotation' if activity == 'user_annotation' else \
                'host' if e.device_type() == DeviceType.CPU else 'other'
        elif e.device_type() == DeviceType.CPU:
            kind = 'annotation' if name in annotations else 'host'
        else:
            kind = 'other' if name in annotations or name.startswith(('ProfilerStep', 'bench.')) \
                else 'device'
        yield name, kind, _ns(e, 'start'), _ns(e, 'end')


@dataclass
class Trace:
    """Device operations [(name, start_ns, end_ns)] and host ranges [(name,
    start_ns, end_ns)] of the window [start_ns, end_ns]."""
    start_ns: int
    end_ns: int
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @classmethod
    def from_events(cls, events, start_ns, end_ns):
        """From `profiler_events`' (name, kind, start, end) tuples."""
        device, host = [], []
        for name, kind, start, end in events:
            if end < start_ns or start > end_ns:
                continue
            if kind == 'device':
                device.append((name, start, end))
            elif kind in ('host', 'annotation') and not name.startswith('ProfilerStep'):
                host.append((name, start, end))
        return cls(start_ns, end_ns, sorted(device, key=lambda e: e[1]), host)

    @property
    def window_ns(self):
        return self.end_ns - self.start_ns

    def _clipped(self):
        for name, start, end in self.device:
            start, end = max(start, self.start_ns), min(end, self.end_ns)
            if end > start:
                yield name, start, end

    def busy_ns(self):
        """Nanoseconds of the window in which some device operation ran."""
        busy, reach = 0, self.start_ns
        for _, start, end in self._clipped():
            if end > reach:
                busy += end - max(start, reach)
                reach = end
        return busy

    def overlap_ns(self):
        """Device time that runs beside another device operation (streams)."""
        return sum(ns for ns in self.device_ns_by_name().values()) - self.busy_ns()

    def idle_share(self):
        return 1.0 - self.busy_ns() / self.window_ns if self.window_ns > 0 else None

    def device_ns_by_name(self):
        totals = {}
        for name, start, end in self._clipped():
            totals[name] = totals.get(name, 0) + end - start
        return totals

    def gaps(self):
        """[(start_ns, end_ns)] of the window with no device operation."""
        out, reach = [], self.start_ns
        for _, start, end in self._clipped():
            if start > reach:
                out.append((reach, start))
            reach = max(reach, end)
        if self.end_ns > reach:
            out.append((reach, self.end_ns))
        return out

    def host_at(self, t_ns):
        """What the host was doing at t_ns: the outermost annotation and the
        innermost operator whose ranges hold it, joined by ' > '."""
        holding = [(name, start, end) for name, start, end in self.host if start <= t_ns <= end]
        if not holding:
            return 'host: outside any operator'
        outer = min(holding, key=lambda h: h[1])
        inner = max(holding, key=lambda h: h[1])
        return outer[0] if outer is inner else f'{outer[0]} > {inner[0]}'

    def idle_gaps(self, top=10):
        """[(label, seconds)] of the longest idle gaps, each labelled by what
        the host was doing at its middle."""
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return [[self.host_at((a + b) // 2), (b - a) / 1e9] for a, b in gaps]

    def top_device_ops(self, top=10):
        """[(name, seconds)] of the device operations that took most time."""
        totals = sorted(self.device_ns_by_name().items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in totals]


def own_kernel_ns(trace, symbols):
    """(own ns, other ns): device time of the operations whose names hold
    one of `symbols` (the port's own kernels), and of all others."""
    own = other = 0
    for name, ns in trace.device_ns_by_name().items():
        if any(s in name for s in symbols):
            own += ns
        else:
            other += ns
    return own, other
