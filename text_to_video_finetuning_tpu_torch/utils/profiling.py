"""The port's spans and its profiler capture.

* Spans: `span(name, **attrs)` times a stretch of host work on
  `time.perf_counter()`, the clock the benchmark reads; `record(name, start,
  end, **attrs)` adds one whose ends were read elsewhere (a request's wait,
  closed on another thread).  A span knows its own id, its parent (the
  innermost span open on its thread when it opened), the run it belongs to
  (`begin_run`) and its attributes; one closed by an exception is kept with
  `error` set to the exception's type.  `span(..., device=True)` also records
  a CUDA event on the current stream at each end (once CUDA is up); the
  device seconds between them are read without waiting, once the card has
  passed the second event (`spans()`, `Span.device_seconds`), or by a
  reader that has waited for the span's work (`Span.settled_seconds`).  While a
  `torch.profiler` session records on the span's thread, the span is also a
  `record_function` user annotation of that trace, on the kernels' clock.
  Closed spans go to one ring of `RING` entries, always on, which counts
  what it drops (`dropped()`).
* `ProfilerTrace`: a `torch.profiler` capture (CPU and CUDA activities)
  written as a Chrome trace, for `profile_steps`.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import List, Optional

import torch

RING = 2 ** 16

_lock = threading.Lock()
_buffer: "collections.deque[Span]" = collections.deque(maxlen=RING)
_pending: List["Span"] = []        # closed device spans not yet resolved
_local = threading.local()
_ids = itertools.count(1)
_run_ids = itertools.count(1)
_run = (0, None)                   # (id, kind) of the newest run
_dropped = 0


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span: `name`, `start` / `end` (perf_counter seconds), `id`,
    `parent` (an id or None), `run` / `run_kind` (`begin_run`), `attrs`,
    and, for a device span, `device_s` once resolved."""

    __slots__ = ("name", "start", "end", "id", "parent", "run", "run_kind",
                 "attrs", "device_s", "_device", "_events", "_annotation")

    def __init__(self, name: str, attrs: dict, device: bool = False):
        self.name, self.attrs, self._device = name, attrs, device
        self.id = next(_ids)
        self.run, self.run_kind = _run
        self.start = self.end = self.parent = self.device_s = None
        self._events = self._annotation = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def device_seconds(self) -> Optional[float]:
        """The device seconds between the span's two events, once the card
        has passed the second; None before that or without events."""
        events = self._events
        if events is not None and self.end is not None \
                and events[1].query():
            self.device_s = events[0].elapsed_time(events[1]) / 1e3
            self._events = None
        return self.device_s

    def settled_seconds(self) -> float:
        """The span's seconds on the card if it was timed there, else on
        the host.  For a reader that has already waited for the span's
        work: it waits for the span's end event alone, which the card
        reaches right after that work."""
        if self._events is None and self.device_s is None:
            return self.seconds
        events = self._events
        if events is not None:
            events[1].synchronize()
        return self.device_seconds()

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if self._device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        if torch.autograd._profiler_enabled():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end = time.perf_counter()
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
            self._annotation = None
        if self._events is not None:
            self._events[1].record()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _keep(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, {self.seconds:.6f} s, id={self.id}, "
                f"parent={self.parent}, run={self.run}, {self.attrs})")


def _keep(s: Span):
    global _dropped
    with _lock:
        if len(_buffer) == RING:
            _dropped += 1
        _buffer.append(s)
        if s._events is not None:
            _pending.append(s)
            if len(_pending) >= 256:
                _resolve()


def _resolve():
    """Read the device seconds of every pending span the card has passed
    (the caller holds the lock)."""
    _pending[:] = [s for s in _pending if s.device_seconds() is None]


def span(name: str, device: bool = False, **attrs) -> Span:
    """A context manager that records the stretch it encloses as `name`
    with `attrs`, which the body may extend (`with span(...) as s:
    s.attrs[...] = ...`); `device=True` also times it on the card."""
    return Span(name, attrs, device)


def record(name: str, start: float, end: float, **attrs) -> Span:
    """Record a span whose ends, on `time.perf_counter()`, were read
    elsewhere; its parent is the innermost span open on this thread."""
    s = Span(name, attrs)
    stack = _stack()
    s.parent = stack[-1].id if stack else None
    s.start, s.end = start, end
    _keep(s)
    return s


def spans() -> List[Span]:
    """The ring's spans, oldest closed first, with the device seconds of
    every device span the card has passed resolved."""
    with _lock:
        _resolve()
        return list(_buffer)


def children(parent: Span) -> List[Span]:
    """The spans in the ring whose parent is `parent`, oldest closed
    first."""
    with _lock:
        return [s for s in _buffer if s.parent == parent.id]


def dropped() -> int:
    """Spans the ring has dropped, oldest first, since the process began."""
    return _dropped


def begin_run(kind: str) -> int:
    """Start a run of `kind` ("train", "serve"); every span opened or
    recorded after it carries the id returned."""
    global _run
    _run = (next(_run_ids), kind)
    return _run[0]


def newest_run(records: List[Span], kind: str) -> List[Span]:
    """The spans of the newest run of `kind` among `records`."""
    run = max((s.run for s in records if s.run_kind == kind), default=None)
    return [s for s in records if s.run == run] if run is not None else []


def total(records: List[Span], name: str) -> float:
    """The host seconds of the spans named `name` among `records`."""
    return sum(s.seconds for s in records if s.name == name)


class ProfilerTrace:
    """A `torch.profiler` capture (CPU and, on a card, CUDA activities)
    between `start()` and `stop()`, written to `log_dir/trace.json` (open
    it in Perfetto or chrome://tracing)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self) -> str:
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        return path
