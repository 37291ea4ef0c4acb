"""The port's spans: named host ranges at its layer boundaries, recorded in
memory for a caller that reads them.

    tracing.take()              # drop what was recorded before
    tracing.enable()
    ...                         # code that runs `with tracing.span(name):`
    spans = tracing.take()      # [Span], oldest first; the record cleared
    tracing.disable()

A span records while tracing is enabled, and also while a torch.profiler
session records (`torch.autograd.profiler._is_profiler_enabled`, the flag
torch keeps for such checks), so every profile of the port carries its
spans: the benchmark's traced windows and `trainer.profile`'s window take
them without a switch. What is recorded is kept until `take()`.

Otherwise, the default, `span` returns one shared null context: it records
nothing and makes no torch call. Recording, a span keeps its name, the
index of its parent span in the record, the iteration it belongs to (the
index of its top-level span since the last `take`, so every span of one
batch or step shares it) and its start and end, and it enters
`torch.profiler.record_function(name)`, so a profile with CPU activity
shows the same names. Its stamps are `time.time_ns()`: torch.profiler's
events carry Unix-epoch ns, the device's operations converted to them, so
a span lies on the device trace of the same window. Inside a graph that
`torch.compile` or `torch.export` traces a span does nothing, so no
profiler op enters the graph. Spans are recorded from one thread.

The port's spans:

    gpe.serve          one batch of `build_serving_fn`'s serve
    gpe.train_step     one `Trainer.train_step`, partitioned in order by
      gpe.forward      its start through the forward
      gpe.loss         the composed loss
      gpe.backward     autograd's backward (and the mesh's gradient sum)
      gpe.optimizer    the optimizer's step
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch
from torch.autograd import profiler as _profiler


@dataclass
class Span:
    """One recorded span. `parent` is the index of the enclosing span in the
    same record (None at the top level); `end_ns` is None while it is open."""
    name: str
    parent: int | None
    iteration: int
    start_ns: int
    end_ns: int | None = None


_NULL = contextlib.nullcontext()
_on = False
_spans: list[Span] = []
_open: list[int] = []    # indices of the open spans in `_spans`, innermost last
_iterations = 0          # top-level spans since the last take()


def enable():
    """Record spans outside a profiler session too."""
    global _on
    _on = True


def disable():
    """Stop recording outside a profiler session; spans already open still
    close."""
    global _on
    _on = False


def take():
    """The recorded spans, oldest first, and the record cleared. Call it
    outside any span."""
    global _spans, _iterations
    spans, _spans, _iterations = _spans, [], 0
    _open.clear()
    return spans


def span(name):
    """A context manager that records the range it holds as `name`."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NULL
    return _Recording(name)


class _Recording:
    __slots__ = ('name', 'record', 'range', 'index')

    def __init__(self, name):
        self.name, self.record = name, None

    def __enter__(self):
        global _iterations
        if torch.compiler.is_compiling():
            return self
        parent = _open[-1] if _open else None
        if parent is None:
            iteration, _iterations = _iterations, _iterations + 1
        else:
            iteration = _spans[parent].iteration
        self.index = len(_spans)
        self.record = Span(self.name, parent, iteration, 0)
        _spans.append(self.record)
        _open.append(self.index)
        # the stamps hold the profiler's range: they lie closer to its own
        # stamps than stamps taken inside it
        self.range = torch.profiler.record_function(self.name)
        self.record.start_ns = time.time_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.record is None:
            return False
        self.range.__exit__(*exc)
        self.record.end_ns = time.time_ns()
        if _open and _open[-1] == self.index:
            _open.pop()
        return False
