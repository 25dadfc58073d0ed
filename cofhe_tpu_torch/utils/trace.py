"""Spans of the port's own work, on the host clock.

A span is a named interval of one thread: its start and end in
`time.perf_counter_ns()`, the thread (`threading.get_ident()`: no system
call, unlike the native id), the span's id, its parent's id, the id of
the request it belongs to and a few attributes.

When it records. Spans are recorded only while tracing is on: while a torch
profiler runs (`torch.autograd.profiler._is_profiler_enabled`, a flag every
thread sees), or inside `enabled()`. Off, `span()` returns one shared no-op
context after one flag test, and allocates nothing; the no-op is false in
a boolean test, so a site computes attributes, or synchronizes the card,
only under `if sp:`.

Request ids. A span opened with no current span is a root and takes a
fresh request id; the spans opened under it inherit it through a
`contextvars` stack. Work handed to another thread runs in a copy of the
caller's context (`contextvars.copy_context().run`, as a server's executor
does) to keep its spans children.

Records stay in memory, at most `CAPACITY` of them; later ones are only
counted (`dropped()`). `records()` returns them, `clear()` drops them.
There is no exporter.

The port's spans (PERF.md names the metric that reads each):
`node.request` (attributes `role` and `service`), `engine.part_decrypt`,
`engine.recode`, `engine.matmul.chain` / `.ladder` / `.finalize`,
`graphs.replay` (attributes `lanes`, `branches` and, on a card, `stream`)
and `graphs.ladder` (attributes `lanes`, `steps` and `branches`, on a card
also `stream` and `beside`). `utils/benchmark.PhaseTimer`'s phases
are spans too while tracing is on; on or off, they time their phase and
mark it in a profiler trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _prof

CAPACITY = 1 << 16

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "cofhe_tpu_torch.trace.span", default=None)


class Span:
    """One recorded interval; a context manager that records itself into
    its tracer when it ends."""

    __slots__ = ("name", "attrs", "thread", "start_ns", "end_ns", "span_id",
                 "parent_id", "request_id", "_tracer", "_token")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict | None = None):
        self._tracer = tracer
        self.name = name
        # kept as given: a site passes one dict to many spans and never
        # changes it; a site that adds attributes passes none
        self.attrs = {} if attrs is None else attrs

    def __enter__(self):
        parent = _CURRENT.get()
        tracer = self._tracer
        if parent is None:
            self.parent_id, self.request_id = None, next(tracer._requests)
        else:
            self.parent_id, self.request_id = parent.span_id, parent.request_id
        self.span_id = next(tracer._ids)
        self.thread = threading.get_ident()
        self._token = _CURRENT.set(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _CURRENT.reset(self._token)
        self._token = None
        self._tracer._record(self)
        return False

    def __bool__(self) -> bool:
        return True

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Phase(Span):
    """A timed interval marked as a `record_function` range (and an NVTX
    range with `nvtx`) in a profiler trace, and recorded as a span if
    tracing is on when it starts; `on_end(phase)` runs when it ends."""

    __slots__ = ("_range", "_nvtx", "_on_end", "_traced")

    def __init__(self, tracer, name, on_end=None, nvtx=False):
        super().__init__(tracer, name)
        self._on_end, self._nvtx = on_end, nvtx

    def __enter__(self):
        self._range = _prof.record_function(self.name)
        self._range.__enter__()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._traced = self._tracer.on()
        if self._traced:
            return super().__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._traced:
            super().__exit__(*exc)
        else:
            self.end_ns = time.perf_counter_ns()
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._range.__exit__(*exc)
        if self._on_end is not None:
            self._on_end(self)
        return False


class _Off:
    """The span of a site while tracing is off: does nothing, is false."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def __bool__(self) -> bool:
        return False


OFF = _Off()


class Tracer:
    """Spans in memory, at most `CAPACITY`."""

    def __init__(self):
        self._forced = 0
        self._records: list = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)

    def on(self) -> bool:
        """Whether spans are recorded now (a profiler runs, or `enabled()`)."""
        return bool(self._forced) or _prof._is_profiler_enabled

    def span(self, name: str, attrs: dict | None = None):
        """A span `name` with `attrs` (kept, not copied) while tracing is
        on, else `OFF`."""
        if self._forced or _prof._is_profiler_enabled:
            return Span(self, name, attrs)
        return OFF

    def phase(self, name: str, on_end=None, nvtx: bool = False) -> Span:
        """A timed phase, marked in a profiler trace and recorded while
        tracing is on (PhaseTimer's phases)."""
        return _Phase(self, name, on_end, nvtx)

    @contextlib.contextmanager
    def enabled(self):
        """Tracing on inside, in every thread (nests)."""
        with self._lock:
            self._forced += 1
        try:
            yield self
        finally:
            with self._lock:
                self._forced -= 1

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._records) < CAPACITY:
                self._records.append(span)
            else:
                self._dropped += 1

    def records(self) -> list:
        """The spans recorded so far, in the order they ended."""
        with self._lock:
            return list(self._records)

    def dropped(self) -> int:
        """Spans that ended while the records were full."""
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._dropped = 0


TRACER = Tracer()
on = TRACER.on
span = TRACER.span
phase = TRACER.phase
enabled = TRACER.enabled
records = TRACER.records
dropped = TRACER.dropped
clear = TRACER.clear


def traced(name: str, attrs=None):
    """Decorator: each call of the function is a span `name`; `attrs`, if
    given, maps the call's arguments to the span's attributes, and is
    called only while tracing is on."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name) as sp:
                if sp and attrs is not None:
                    sp.attrs.update(attrs(*args, **kwargs))
                return fn(*args, **kwargs)
        return call
    return wrap
