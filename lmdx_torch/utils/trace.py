"""Profiling and tracing: the program's own spans and host-wait counters.

- `trace(dir)` records a torch.profiler trace of the host and, when a card
  is present, the device (CUDA kernels and copies), and writes it into `dir`
  as a Chrome trace (`trace_<pid>_<ns>.json`), which Perfetto or
  chrome://tracing open.
- `recording()` keeps the program's spans and counters in memory for as long
  as it is open, and yields the `Recorder` that holds them.
- `annotate(name, **attrs)` is a span around one phase of the program. Under
  `recording()` it appends a `Span` to the recorder (host `perf_counter_ns`
  stamps, the index of the span it opened inside, the request id its root
  carries); under `trace()` it also enters `torch.profiler.record_function`,
  so the Chrome trace shows the same spans. With neither open it returns one
  shared null context: no clock read, no `record_function`.
- `wait(reason)` is the span `wait:<reason>` around a read on which the host
  blocks until the device has finished the work queued before it (a copy to
  the host, a value the host branches on); under `recording()` it also adds
  1 to the recorder's `counts["host_syncs"][reason]`. It adds no read and no
  synchronisation of its own.
- `to_host(x, reason)` and `to_device(x, device, reason)` are the copies
  between host and device inside `wait(reason)`, one wait a copy: a copy to
  the host waits for the work queued before it, and so does a copy from
  pageable host memory onto the device (the runtime synchronises the stream
  around it). A tensor already on a card goes to `device` without a wait.

A root span (one opened outside every other) takes `request_id` when it is
given one, else one more than the largest id yet; the spans opened inside
it carry the same id, whatever they are given. `request_id()` is the id of
the spans open now, for work a request leaves to be finished after it (a
deferred copy's wait takes it). Spans on the profiler's
clock: add `time.time_ns() - time.perf_counter_ns()`, read once, to the
stamps.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import tempfile
import time
from collections import Counter, defaultdict
from typing import NamedTuple

import torch

_clock = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int | None          # index in `Recorder.spans`; None for a root
    request_id: int
    attrs: dict


class Recorder:
    """What one `recording()` collects: `spans` in the order they opened,
    `counts` {counter: Counter} (`counts["host_syncs"][reason]`)."""

    def __init__(self):
        self.spans: list[Span] = []             # an open span's end_ns is -1
        self.counts: defaultdict[str, Counter] = defaultdict(Counter)
        self._stack: list[int] = []
        self._next_request = 0

    def _open(self, name: str, request_id, attrs: dict) -> int:
        parent = self._stack[-1] if self._stack else None
        if parent is not None:
            request_id = self.spans[parent].request_id
        else:
            request_id = self._next_request if request_id is None else request_id
            self._next_request = max(self._next_request, request_id + 1)
        index = len(self.spans)
        # Held open with its start; `_close` writes the end.
        self.spans.append(Span(name, _clock(), -1, parent, request_id, attrs))
        self._stack.append(index)
        return index

    def _close(self, index: int) -> None:
        self._stack.pop()
        self.spans[index] = self.spans[index]._replace(end_ns=_clock())


class _Active(NamedTuple):
    recorder: Recorder | None
    profiling: bool


_ACTIVE: contextvars.ContextVar[_Active | None] = contextvars.ContextVar(
    "lmdx_trace_active", default=None)
_NULL = contextlib.nullcontext()


class _SpanContext:
    __slots__ = ("_active", "_name", "_request_id", "_attrs", "_wait", "_index", "_fn")

    def __init__(self, active: _Active, name: str, request_id, attrs: dict, wait=None):
        self._active = active
        self._name = name
        self._request_id = request_id
        self._attrs = attrs
        self._wait = wait
        self._fn = None

    def __enter__(self):
        if self._active.profiling:
            self._fn = torch.profiler.record_function(self._name)
            self._fn.__enter__()
        rec = self._active.recorder
        if rec is not None:
            if self._wait is not None:
                rec.counts["host_syncs"][self._wait] += 1
            self._index = rec._open(self._name, self._request_id, self._attrs)
        return self

    def __exit__(self, *exc):
        rec = self._active.recorder
        if rec is not None:
            rec._close(self._index)
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


def _switch(**change):
    """Makes the context's recorder or profiling flag `change`; returns the
    token that puts it back."""
    new = (_ACTIVE.get() or _Active(None, False))._replace(**change)
    return _ACTIVE.set(new if new.recorder is not None or new.profiling else None)


def annotate(name: str, request_id: int | None = None, **attrs):
    """A span of the program (module docstring); `attrs` are kept with it."""
    active = _ACTIVE.get()
    if active is None:
        return _NULL
    return _SpanContext(active, name, request_id, attrs)


def wait(reason: str, request_id: int | None = None):
    """A host wait on the device (module docstring)."""
    active = _ACTIVE.get()
    if active is None:
        return _NULL
    return _SpanContext(active, "wait:" + reason, request_id, {}, wait=reason)


def request_id() -> int | None:
    """The request id of the spans open now; None outside every span or
    with recording off."""
    active = _ACTIVE.get()
    rec = active.recorder if active is not None else None
    if rec is None or not rec._stack:
        return None
    return rec.spans[rec._stack[-1]].request_id


def to_host(x: torch.Tensor, reason: str, request_id: int | None = None):
    """`x.cpu().numpy()` inside `wait(reason, request_id)`."""
    with wait(reason, request_id):
        return x.cpu().numpy()


def to_device(x, device, reason: str) -> torch.Tensor:
    """`torch.as_tensor(x, device=device)`, inside `wait(reason)` unless `x`
    is a tensor already on a card."""
    on_card = isinstance(x, torch.Tensor) and x.device.type != "cpu"
    with _NULL if on_card else wait(reason):
        return torch.as_tensor(x, device=device)


@contextlib.contextmanager
def recording():
    """Records the program's spans and counters in the body; yields the
    `Recorder`."""
    rec = Recorder()
    token = _switch(recorder=rec)
    try:
        yield rec
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profiles the body; yields `log_dir` (default: `lmdx_trace` under the
    temporary directory), where the trace file is written on exit."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "lmdx_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    token = _switch(profiling=True)
    try:
        yield log_dir
    finally:
        _ACTIVE.reset(token)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
