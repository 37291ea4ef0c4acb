"""The port's spans (`utils/tracing.py`): off, nothing is recorded and the
profiler is never entered; on, or under a profiler session, nested spans
record their parent and iteration, each span's stamps match its own
`record_function` event (the profiler's clock), `Trainer.train_step`
records its four phases and `build_serving_fn` its batch, an exported
artifact holds no profiler op, and tracing moves no number of the step or
the served batch."""
import copy

import numpy as np
import pytest
import torch

from garment_pattern_estimation_torch.experiment import build_serving_fn, export_serving_artifact
from garment_pattern_estimation_torch.models import build_model
from garment_pattern_estimation_torch.ops import edgeconv, knn, knn_gather
from garment_pattern_estimation_torch.train import Trainer
from garment_pattern_estimation_torch.utils import tracing
from test_torch_serving import SERVE_DATA
from test_torch_train import DATA, LOSS, NN, SETUP, _ground_truth, _torch

torch.set_num_threads(1)

B, N = 2, 96
STEP = ['gpe.train_step', 'gpe.forward', 'gpe.loss', 'gpe.backward', 'gpe.optimizer']


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _nested():
    for _ in range(2):
        with tracing.span('top'):
            with tracing.span('a'):
                with tracing.span('a.inner'):
                    pass
            with tracing.span('b'):
                pass


@pytest.mark.parametrize('name', ['nested', 'train_step', 'serve'])
def test_off_records_nothing_and_never_enters_the_profiler(monkeypatch, name):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f'record_function({name!r}) entered with tracing off')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    assert tracing.span('top') is tracing.span('other')
    if name == 'nested':
        _nested()
        assert tracing.take() == []
    else:
        assert _run(name, _model(name))[1] == []


def test_nested_spans_record_parent_and_iteration():
    tracing.enable()
    _nested()
    spans = tracing.take()
    assert [(s.name, s.parent, s.iteration) for s in spans] == [
        ('top', None, 0), ('a', 0, 0), ('a.inner', 1, 0), ('b', 0, 0),
        ('top', None, 1), ('a', 4, 1), ('a.inner', 5, 1), ('b', 4, 1)]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            parent = spans[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert tracing.take() == []
    _nested()
    assert [s.iteration for s in tracing.take()] == [0] * 4 + [1] * 4


@pytest.mark.parametrize('enabled', [True, False])
def test_span_stamps_match_their_profiler_events(enabled):
    """The spans' stamps are on the clock of torch.profiler's events: each
    holds its own `record_function` event (stamped inside the span's) and
    lies within 100 us of it. A profiler session records spans whether
    tracing is enabled or not; after it, disabled, nothing is recorded."""
    from torch.profiler import ProfilerActivity, profile

    if enabled:
        tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _nested()                # the first ranges of a process set up the profiler's path
        tracing.take()
        _nested()
        spans = tracing.take()
    _nested()
    assert (tracing.take() != []) == enabled
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in {'top', 'a', 'a.inner', 'b'}]
    events = sorted(events, key=lambda e: (e.start_ns(), -e.end_ns()))[len(spans):]
    assert len(events) == len(spans) == 8
    for s, e in zip(spans, events):
        assert s.name == e.name()
        # the profiler converts its own clock to Unix-epoch ns: a few us
        assert s.start_ns - 20_000 <= e.start_ns() and e.end_ns() <= s.end_ns + 20_000, s
        assert abs(s.start_ns - e.start_ns()) <= 100_000, s
        assert abs(s.end_ns - e.end_ns()) <= 100_000, s


def _model(name):
    if name == 'train_step':
        return build_model('GarmentSegmentPattern3D', DATA, NN, LOSS, device='cpu', seed=4)
    return build_model('GarmentSegmentPattern3D', SERVE_DATA, dict(NN, lstm_init='zeros'),
                       device='cpu', seed=4)


def _run(name, model):
    """One step or one served batch on fixed inputs: (its numbers, the
    spans recorded, the launch counters)."""
    rng = np.random.default_rng(7)
    points = torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float32))
    for module in (edgeconv, knn, knn_gather):
        module.launches_by_shape.clear()
    if name == 'train_step':
        trainer = Trainer(SETUP, device='cpu')
        trainer.make_optimizer(model, 2)
        batch = {'features': points, 'ground_truth': _torch(_ground_truth(rng, N=N))}
        loss, terms = trainer.train_step(model, batch, epoch=0,
                                         generator=torch.Generator().manual_seed(3))
        numbers = {'loss': loss, **terms,
                   **{n: p.grad for n, p in model.module.named_parameters()},
                   **model.module.state_dict()}
    else:
        model.module.eval()
        numbers = build_serving_fn(model, SERVE_DATA)(points * 10.0)
    counters = [dict(m.launches_by_shape) for m in (edgeconv, knn, knn_gather)]
    return numbers, tracing.take(), counters


@pytest.mark.parametrize('name,expected', [
    ('train_step', [(n, None if i == 0 else 0) for i, n in enumerate(STEP)]),
    ('serve', [('gpe.serve', None)]),
])
def test_entry_records_its_spans(name, expected):
    """One `Trainer.train_step` records one `gpe.train_step` with its four
    phases as children, in order and inside it; one served batch one
    `gpe.serve`."""
    tracing.enable()
    _, spans, _ = _run(name, _model(name))
    assert [(s.name, s.parent) for s in spans] == expected
    assert all(s.iteration == 0 and s.start_ns <= s.end_ns for s in spans)
    for before, after in zip(spans[1:], spans[2:]):
        assert before.end_ns <= after.start_ns
    if len(spans) > 1:
        assert spans[0].start_ns <= spans[1].start_ns and spans[-1].end_ns <= spans[0].end_ns


@pytest.mark.parametrize('name', ['train_step', 'serve'])
def test_tracing_changes_no_number(name):
    """The step's loss, terms, gradients and state, or the served outputs,
    and the launch counters, are the same with tracing on and off."""
    model = _model(name)
    twin = copy.deepcopy(model)
    off, off_spans, off_counters = _run(name, model)
    tracing.enable()
    on, on_spans, on_counters = _run(name, twin)
    assert off_spans == [] and on_spans != []
    assert on_counters == off_counters
    assert sorted(on) == sorted(off)
    for key in off:
        torch.testing.assert_close(on[key], off[key], rtol=0, atol=0, equal_nan=True, msg=key)


class _Spanned(torch.nn.Module):
    def forward(self, x):
        with tracing.span('gpe.inside_the_graph'):
            return x + 1


@pytest.mark.parametrize('strict', [False, True])
def test_export_with_tracing_on_holds_no_profiler_op(tmp_path, strict):
    """`export_serving_artifact` with tracing on writes a graph with no
    profiler op, and a span inside an exported module neither records nor
    enters the graph."""
    tracing.enable()
    export_serving_artifact(_model('serve'), SERVE_DATA, tmp_path, batch_size=B, num_points=N)
    programs = [torch.export.load(tmp_path / 'model.pt2'),
                torch.export.export(_Spanned(), (torch.zeros(2),), strict=strict)]
    assert tracing.take() == []
    for program in programs:
        targets = [str(node.target) for node in program.graph.nodes]
        assert not any('profiler' in t or 'record_function' in t for t in targets), targets
