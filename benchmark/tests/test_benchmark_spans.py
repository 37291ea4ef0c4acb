"""The readers of the port's spans (`program_span` metrics) on a synthetic
trace: hand-computed values, spans clipped to the window, and None where the
program records no span."""
import sys

import pytest

from benchmark import common, spans
from benchmark.readers import Run, idle_share
from benchmark.trace import Trace
from garment_pattern_estimation_torch import utils
from garment_pattern_estimation_torch.utils import tracing
from garment_pattern_estimation_torch.utils.tracing import Span

# the window 0-100 ns: device busy 10-30 and 60-70, idle 0-10, 30-60, 70-100
DEVICE = [('k_a', 10, 30), ('k_b', 60, 70)]
IDLE_NS = 70
# two iterations at 100 ns each in the measured window: 15 ns busy each
MEASURED = (2, 200e-9)
IDLE_SHARE = 100.0 * (1 - 15 / 100)

TRAIN = [Span('gpe.train_step', None, 0, -20, 50), Span('gpe.forward', 0, 0, -20, 5),
         Span('gpe.loss', 0, 0, 5, 20), Span('gpe.backward', 0, 0, 20, 40),
         Span('gpe.optimizer', 0, 0, 40, 50),
         Span('gpe.train_step', None, 1, 55, 120), Span('gpe.forward', 5, 1, 55, 65),
         Span('gpe.loss', 5, 1, 65, 80), Span('gpe.backward', 5, 1, 80, 95),
         Span('gpe.optimizer', 5, 1, 95, 120),
         # after the window (the labelled window's), and one left open
         Span('gpe.train_step', None, 2, 150, 200), Span('gpe.forward', 10, 2, 150, None)]
SERVE = [Span('gpe.serve', None, 0, 5, 25), Span('gpe.serve', None, 1, 50, 90),
         Span('gpe.serve', None, 2, -50, -10)]

# metric name -> (entry, its value: ns per iteration / 1e6, or the idle share)
EXPECTED = {
    'forward_ms.train.n2000': ('train', (5 + 10) / 2 / 1e6),
    'loss_ms.train.n2000': ('train', (15 + 15) / 2 / 1e6),
    'backward_ms.train.n2000': ('train', (20 + 15) / 2 / 1e6),
    'optimizer_ms.train.n2000': ('train', (10 + 5) / 2 / 1e6),
    # idle inside gpe.train_step: 0-10, 30-50, 55-60, 70-100
    'program_idle_share.train.n2000': ('train', IDLE_SHARE * (10 + 20 + 5 + 30) / IDLE_NS),
    'dispatch_ms.serve.n2000': ('serve', (20 + 40) / 2 / 1e6),
    # idle inside gpe.serve: 5-10, 50-60, 70-90
    'program_idle_share.serve.n2000': ('serve', IDLE_SHARE * (5 + 10 + 20) / IDLE_NS),
}


def _run(kind, recorded, monkeypatch):
    """A run of `kind` over the synthetic window whose program recorded
    `recorded`; returns it and the list of the recorder's `take` calls."""
    calls = []

    def take():
        calls.append(1)
        return list(recorded)

    monkeypatch.setattr(tracing, 'take', take)
    run = Run(kind=kind, config={}, traffic={}, trace=Trace(0, 100, list(DEVICE)),
              iterations=2, counters={}, families={}, peak_window_bytes=None,
              measured=MEASURED)
    return run, calls


@pytest.mark.parametrize('metric', sorted(EXPECTED))
def test_each_reader_reads_its_hand_computed_value(metric, monkeypatch):
    kind, value = EXPECTED[metric]
    run, _ = _run(kind, TRAIN if kind == 'train' else SERVE, monkeypatch)
    assert common.load_reader(metric)(run) == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize('kind', ['train', 'serve'])
def test_spans_are_clipped_and_taken_once_for_every_reader(kind, monkeypatch):
    """The spans outside the window and the open one are dropped; the four
    phases partition the step's clipped ns; the readers of one run take
    the record once; the program's idle share is at most the device's."""
    run, calls = _run(kind, TRAIN if kind == 'train' else SERVE, monkeypatch)
    by_name = spans.of(run)
    if kind == 'train':
        assert by_name['gpe.train_step'] == [(0, 50), (55, 100)]
        assert by_name['gpe.forward'] == [(0, 5), (55, 65)]
        phases = sum(spans.host_ms(run, 'train', f'gpe.{p}')
                     for p in ('forward', 'loss', 'backward', 'optimizer'))
        assert phases == pytest.approx(spans.host_ms(run, 'train', 'gpe.train_step'))
    else:
        assert by_name == {'gpe.serve': [(5, 25), (50, 90)]}
    values = [common.load_reader(m)(run) for m, (k, _) in EXPECTED.items() if k == kind]
    assert len(calls) == 1 and None not in values
    program = common.load_reader(f'program_idle_share.{kind}.n2000')(run)
    assert 0 <= program <= idle_share(run, kind)


@pytest.mark.parametrize('without', ['spans', 'recorder', 'entry'])
def test_a_run_without_spans_reads_none(without, monkeypatch):
    """No span in the window (the program recorded none, or a program
    without the recorder, as before it), or the other entry's readers:
    every new reader returns None."""
    if without == 'entry':
        run = _run('serve', SERVE, monkeypatch)[0]
        metrics = [m for m, (kind, _) in EXPECTED.items() if kind == 'train']
    else:
        run = _run('train', [] if without == 'spans' else TRAIN, monkeypatch)[0]
        metrics = sorted(EXPECTED)
        if without == 'recorder':
            monkeypatch.delattr(utils, 'tracing')
            monkeypatch.setitem(sys.modules, 'garment_pattern_estimation_torch.utils.tracing',
                                None)
    for metric in metrics:
        assert common.load_reader(metric)(run) is None, metric


def test_idle_ns_inside_spans():
    assert spans.union([(5, 8), (0, 3), (2, 4), (8, 9)]) == [(0, 4), (5, 9)]
    assert spans.overlap_ns([(0, 4), (5, 9)], [(3, 6), (8, 20)]) == 1 + 1 + 1
    assert spans.overlap_ns([], [(0, 1)]) == 0


@pytest.mark.parametrize('name,metrics', [
    ('att-train-n2000', ['forward_ms.train.n2000', 'loss_ms.train.n2000',
                         'backward_ms.train.n2000', 'optimizer_ms.train.n2000']),
    ('baseline-serve-n2000', ['dispatch_ms.serve.n2000']),
])
def test_a_traced_run_on_the_cpu_reads_the_programs_spans(name, metrics):
    """A traced run at a small size on the CPU: the port records its spans
    under the traced windows' profiler with tracing never enabled, and the
    host-ms readers read them (the idle shares need device operations, which
    the CPU has none of)."""
    from benchmark.tests.test_benchmark_faults import run

    assert not tracing._on
    result = run(name, trace=True)
    assert result['correct']
    for metric in metrics:
        assert result['metrics'][metric]['value'] > 0, metric
    assert tracing.take() == []
