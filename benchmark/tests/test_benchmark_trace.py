"""The trace reader on synthetic event lists."""
import pytest

from benchmark.readers import Run, idle_share, kernels_roofline
from benchmark.trace import Trace, own_kernel_ns


def synthetic():
    # window 0-100 ns; kernels 10-30, 20-40 (overlapping), 60-70; a copy 90-110
    device = [('k_a', 10, 30), ('k_b', 20, 40), ('k_a', 60, 70), ('memcpy', 90, 110)]
    host = [('bench.serve', 0, 80), ('aten::mm', 45, 55), ('bench.receive', 80, 100)]
    return Trace(0, 100, device, host)


def test_busy_and_idle_share():
    trace = synthetic()
    assert trace.busy_ns() == 30 + 10 + 10          # 10-40, 60-70, 90-100
    assert trace.idle_share() == 0.5
    assert trace.gaps() == [(0, 10), (40, 60), (70, 90)]


def test_idle_gaps_are_named_by_the_host():
    assert synthetic().idle_gaps() == [['bench.serve > aten::mm', 20e-9],
                                       ['bench.serve > bench.receive', 20e-9],
                                       ['bench.serve', 10e-9]]


def test_device_time_by_name_and_own_kernels():
    trace = synthetic()
    assert trace.device_ns_by_name() == {'k_a': 30, 'k_b': 20, 'memcpy': 10}
    assert trace.top_device_ops(2) == [['k_a', 30e-9], ['k_b', 20e-9]]
    assert own_kernel_ns(trace, ['k_']) == (50, 10)


def test_empty_trace_reads_nothing():
    run = Run(kind='serve', config={}, traffic={}, trace=Trace(0, 100), iterations=3,
              counters={}, families={}, peak_window_bytes=None,
              measured=(3, 1.0))
    assert idle_share(run, 'serve') is None
    assert kernels_roofline(run, 'serve') is None


def _roofline_run(counters):
    families = {'fam': {'symbols': ['k_'], 'costs': {'dist': 'knn', 'tail': None}}}
    config = {'NN': {'EConv_hidden': 4, 'EConv_hidden_depth': 1, 'EConv_feature': 4}}
    return Run(kind='serve', config=config, traffic={'batch': 2}, trace=synthetic(),
               iterations=1, counters=counters, families=families, peak_window_bytes=None,
               measured=(1, 1.0))


def test_kernels_roofline_is_the_launches_bound_over_own_time():
    from benchmark import yardstick

    run = _roofline_run({'fam': {('dist', 1000, 3, 5): 2, ('tail', 1000, 3, 5): 4}})
    bound = 2 * yardstick.bound_seconds(*yardstick.knn(2, 1000, 3, 5))
    assert kernels_roofline(run, 'serve') == pytest.approx(100 * bound / 50e-9)


def test_kernels_roofline_refuses_an_uncounted_launch():
    run = _roofline_run({'fam': {('dist', 1000, 3, 5): 1, ('new_variant', 1000, 3, 5): 1}})
    with pytest.raises(KeyError, match='new_variant'):
        kernels_roofline(run, 'serve')


class _Event:
    """A profiler event of an older torch: no activity type, times in us."""

    def __init__(self, name, device, start_us, duration_us):
        from torch.autograd import DeviceType
        self._name, self._start, self._duration = name, start_us, duration_us
        self._device = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_us(self):
        return self._start

    def duration_us(self):
        return self._duration


class _Profile:
    def __init__(self, events):
        class Results:
            def events(self_):
                return events

        class Profiler:
            kineto_results = Results()
        self.profiler = Profiler()


def test_events_without_an_activity_type():
    from benchmark.trace import profiler_events
    events = [_Event('bench.window', False, 0, 100), _Event('aten::mm', False, 10, 5),
              _Event('bench.window', True, 0, 100), _Event('gemm_kernel', True, 20, 30),
              _Event('ProfilerStep#1', True, 0, 120)]
    kinds = [(name, kind) for name, kind, _, _ in profiler_events(_Profile(events))]
    assert kinds == [('bench.window', 'annotation'), ('aten::mm', 'host'),
                     ('bench.window', 'other'), ('gemm_kernel', 'device'),
                     ('ProfilerStep#1', 'other')]
    trace = Trace.from_events(profiler_events(_Profile(events)), 0, 100_000)
    assert trace.device == [('gemm_kernel', 20_000, 50_000)]
    assert trace.busy_ns() == 30_000
