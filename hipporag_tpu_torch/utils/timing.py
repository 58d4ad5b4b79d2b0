"""Stage timing and span instrumentation.

The reference keeps manual per-stage wall-clock accumulators
(HippoRAG.py:184-186, 444-489). We generalize that into a tiny stage-timer
registry, and ``device_profile`` traces a block with ``torch.profiler``.

Spans name the stages of one call. ``span(name, **attrs)`` is off, and
costs a flag check, unless a ``torch.profiler`` session is recording or a
``recording()`` block is open. When on, a closed span goes into a bounded
in-process log (``spans()``; the oldest go first, counted by
``dropped_spans()``), and while a profiler records the span also opens
``record_function(name)``, so it lies on the trace's own timeline next to
the kernels it launched. Times are ``time.time_ns()``, the clock an
exported trace keeps (``baseTimeNanoseconds`` + ``ts`` in microseconds).
A span's parent is the innermost span open on its thread, or the
``parent`` it is given (a stage run on a worker thread for its call); its
call id is the span id of its root. ``count(key, n)`` adds ``n`` to the
innermost open span's ``attrs[key]``; ``on_close(key, start)`` adds counts
that are read once, when that span closes (a device counter accumulated
over the span). Nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _autograd_profiler

SPAN_LOG_CAPACITY = 65536


class StageTimers:
    """Accumulates wall-clock seconds per named stage; each tracked stage
    is also a span of the stage's name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def track(self, stage: str):
        start = time.perf_counter()
        try:
            with span(stage):
                yield
        finally:
            self.totals[stage] += time.perf_counter() - start
            self.counts[stage] += 1

    def add(self, stage: str, seconds: float):
        self.totals[stage] += seconds
        self.counts[stage] += 1

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)


class Span(NamedTuple):
    """One closed span of the log."""

    name: str
    span_id: int
    parent_id: Optional[int]
    call_id: int
    start_ns: int
    end_ns: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_lock = threading.Lock()
_log: deque = deque(maxlen=SPAN_LOG_CAPACITY)
_dropped = 0
_recording = 0  # open recording() blocks
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _OpenSpan:
    __slots__ = ("name", "attrs", "parent", "span_id", "parent_id", "call_id", "start_ns", "_range", "closers")

    def __init__(self, name: str, parent, attrs: dict):
        self.name, self.parent, self.attrs = name, parent, attrs
        self.closers = {}

    def __enter__(self):
        stack = _stack()
        parent = self.parent if self.parent is not None else (stack[-1] if stack else None)
        self.span_id = next(_ids)
        self.parent_id = parent.span_id if parent is not None else None
        self.call_id = parent.call_id if parent is not None else self.span_id
        self._range = None
        stack.append(self)
        self.start_ns = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            # the range takes its own timestamp while it is entered and
            # exited: the log keeps the middle of each of the two
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
            self.start_ns = (self.start_ns + time.time_ns()) // 2
        return self

    def __exit__(self, *exc):
        global _dropped
        end_ns = time.time_ns()
        _stack().remove(self)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            end_ns = (end_ns + time.time_ns()) // 2
        for read in self.closers.values():
            for key, n in read().items():
                self.attrs[key] = self.attrs.get(key, 0) + n
        record = Span(self.name, self.span_id, self.parent_id, self.call_id, self.start_ns, end_ns, self.attrs)
        with _lock:
            if len(_log) == _log.maxlen:
                _dropped += 1
            _log.append(record)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, parent=None, **attrs):
    """A context manager timing the stage ``name`` (see the module's
    docstring); ``parent`` is an open span of another thread, such as the
    call's root, for a stage run on a worker thread. Entering gives the
    open span, or ``None`` when recording is off."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _OpenSpan(name, parent, attrs)


def count(key: str, n=1) -> None:
    """Add ``n`` to ``attrs[key]`` of the innermost span open on this thread."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return
    stack = getattr(_local, "stack", None)
    if stack:
        attrs = stack[-1].attrs
        attrs[key] = attrs.get(key, 0) + n


def on_close(key: str, start) -> None:
    """While spans are recorded, once per ``key`` for the innermost span open
    on this thread: call ``start()`` now; the function it returns is called
    when the span closes (after its end is timed) and gives ``{counter: n}``
    to add to the span's attrs."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return
    stack = getattr(_local, "stack", None)
    if stack and key not in stack[-1].closers:
        stack[-1].closers[key] = start()


class Recording:
    """What ``recording()`` gives: the spans opened inside its block."""

    def __init__(self, after_id: int):
        self._after = after_id

    def spans(self) -> List[Span]:
        return [s for s in spans() if s.span_id > self._after]


@contextlib.contextmanager
def recording():
    """Record spans inside this block with no profiler running."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield Recording(next(_ids))
    finally:
        with _lock:
            _recording -= 1


def spans() -> List[Span]:
    """A snapshot of the span log, oldest first (in the order spans closed)."""
    with _lock:
        return list(_log)


def dropped_spans() -> int:
    """Spans pushed out of the full log since it was last reset."""
    return _dropped


def reset_spans(capacity: int = SPAN_LOG_CAPACITY) -> None:
    """Empty the span log and its dropped count; the log then holds
    ``capacity`` spans."""
    global _log, _dropped
    with _lock:
        _log = deque(maxlen=capacity)
        _dropped = 0


@contextlib.contextmanager
def device_profile(log_dir: str | None, device=None):
    """Optionally trace a block with ``torch.profiler`` and write a Chrome
    trace, ``trace-<pid>-<ns>.json``, into ``log_dir``. CPU activity is
    always recorded, CUDA activity (kernels, copies) when ``device`` is a
    CUDA device."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
