"""Spans and counters of the port's host work: a recorder that is off
unless someone is looking.

The recorder is on while a ``torch.profiler`` session is active, or
after :func:`enable` (an operator's switch; :func:`disable` turns it
off). Off, a span site costs one flag check and returns a shared no-op
object: no clock read, no allocation. On, a span records its name (from
the closed table :data:`NAMES`), its start and end on
``time.perf_counter_ns()``, the index of its parent (the innermost span
open on the thread) and a key: a request's ``rid`` or a launch's
sequence number. Under the profiler, a span also opens a record
function of the same name, so it sits in the profiler's timeline, on
the device trace's clock and on the calling thread, where idle gaps can
be attributed to it.

A span is a context manager: it is the parent of the spans opened
inside it on its thread. A call site that may find no work asks
:func:`on` first and opens no span for a call that does none.

Spans live in preallocated typed arrays of :data:`CAPACITY` entries;
past that they are counted in ``dropped`` and not recorded. Counters
are named integers (:data:`COUNTERS`), added with :func:`add`.
:func:`summary` gives count, total and self time a span name (self: the
duration less what its children cover), the counters and ``dropped``;
:func:`reset` clears.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

NAMES = (
    # scheduler (serve/engine.py:Engine) and admission
    "serve.submit", "serve.make_request",
    # text admission (serve/text.py, kernels/ops.py:text_to_words)
    "text.coalesce", "text.geometry", "text.frontend", "text.readback",
    "text.doc_ids",
    # the workload ring (serve/engine.py:StemmerWorkload), a launch each
    "ring.coalesce", "ring.dispatch", "ring.stage", "ring.launch",
    "ring.retire", "ring.wait", "ring.checksum", "ring.scatter",
    # the index driver (index/builder.py, kernels/ops.py:build_root_index)
    "index.build", "index.vocab", "index.upload", "index.compute",
    "index.readback", "index.merge",
)
COUNTERS = ("index.words", "index.copy_bytes")
CAPACITY = 1 << 20

_IDS = {name: i for i, name in enumerate(NAMES)}
_OPEN = -1          # the end of a span not closed yet

# Whether a torch.profiler session is active: the Python flag where the
# installed torch has it (a global read), else the C one. Tracing must
# never go quiet because a torch release renamed both.
if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        return _autograd_profiler._is_profiler_enabled
elif hasattr(torch._C._autograd, "_profiler_enabled"):
    _profiling = torch._C._autograd._profiler_enabled
else:
    raise ImportError("this torch has neither"
                      " torch.autograd.profiler._is_profiler_enabled nor"
                      " torch._C._autograd._profiler_enabled: the tracing"
                      " recorder could not tell when a profiler is active")

# the profiler's record function: the fast one where it exists
_RecordFunction = getattr(getattr(torch._C, "_profiler", None),
                          "_RecordFunctionFast",
                          _autograd_profiler.record_function)


class Span(NamedTuple):
    """One closed span as :func:`records` returns it."""

    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int          # index of the parent span, -1 for none
    key: int             # rid, launch sequence number, or -1


class Recorder:
    """Spans in preallocated arrays, counters in a dict. The process's
    recorder is :data:`RECORDER`; a test may make its own."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.name = np.empty(capacity, np.int16)
        self.start = np.empty(capacity, np.int64)
        self.end = np.empty(capacity, np.int64)
        self.parent = np.empty(capacity, np.int32)
        self.key = np.empty(capacity, np.int64)
        self._lock = threading.Lock()
        self.generation = 0
        self.reset()

    def reset(self) -> None:
        """Forget every span and counter. Spans open across a reset are
        not recorded."""
        with self._lock:
            self.n = 0               # slots taken
            self.dropped = 0         # spans past capacity
            self.counters = dict.fromkeys(COUNTERS, 0)
            self.generation += 1
            self._local = threading.local()

    def stack(self) -> list:
        """The indices of the spans open on this thread, innermost last."""
        local = self._local
        try:
            return local.stack
        except AttributeError:
            local.stack = []
            return local.stack

    def open(self, name: str, key: int | None) -> int:
        """Stamp a span's start and take a slot for it under the thread's
        innermost open span; -1 once the arrays are full. The stamp comes
        first, so that the slot's writes (a page's first touch among
        them) fall inside the span, as they fall inside the profiler's
        event of it."""
        t = time.perf_counter_ns()
        name_id = _IDS[name]
        stack = self.stack()
        with self._lock:
            i = self.n
            if i >= self.capacity:
                self.dropped += 1
                return -1
            self.n = i + 1
        self.name[i] = name_id
        self.key[i] = -1 if key is None else key
        self.parent[i] = stack[-1] if stack else -1
        self.end[i] = _OPEN
        self.start[i] = t
        return i

    def close(self, i: int) -> None:
        self.end[i] = time.perf_counter_ns()

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def _closed(self):
        n = self.n
        name, start, end = self.name[:n], self.start[:n], self.end[:n]
        return end != _OPEN, name, start, end

    def summary(self) -> dict:
        """{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
        {name: n}, "dropped": n}, over the closed spans."""
        ok, name, start, end = self._closed()
        dur = end - start
        # each child's overlap with its parent's interval is the
        # parent's time that is not its own
        parent = self.parent[:self.n]
        child = np.flatnonzero(ok & (parent >= 0))
        p = parent[child]
        child, p = child[ok[p]], p[ok[p]]
        cover = (np.minimum(end[child], end[p])
                 - np.maximum(start[child], start[p])).clip(min=0)
        own = dur - np.bincount(p, weights=cover, minlength=dur.size)
        ids = name[ok].astype(np.int64)
        count = np.bincount(ids, minlength=len(NAMES))
        total = np.bincount(ids, weights=dur[ok], minlength=len(NAMES))
        selft = np.bincount(ids, weights=own[ok], minlength=len(NAMES))
        spans = {NAMES[j]: {"count": int(count[j]),
                            "total_s": float(total[j]) * 1e-9,
                            "self_s": float(selft[j]) * 1e-9}
                 for j in np.flatnonzero(count)}
        return {"spans": spans, "counters": dict(self.counters),
                "dropped": self.dropped}

    def records(self) -> list[Span]:
        """Every closed span, in opening order."""
        ok, name, start, end = self._closed()
        return [Span(int(i), NAMES[name[i]], int(start[i]), int(end[i]),
                     int(self.parent[i]), int(self.key[i]))
                for i in np.flatnonzero(ok)]


RECORDER = Recorder()
_enabled = False


def _off_enter():
    return _OFF


def _off_exit(exc_type, exc, tb):
    return None


class _Off:
    """What a span site gets while the recorder is off: one shared
    object that does nothing. Its ``with`` methods are static, so that
    entering it binds no method object: the site allocates nothing."""

    __slots__ = ()
    __enter__ = staticmethod(_off_enter)
    __exit__ = staticmethod(_off_exit)


_OFF = _Off()


class _Span:
    __slots__ = ("name", "key", "i", "gen", "rf")

    def __init__(self, name: str, key: int | None):
        self.name, self.key = name, key

    # Between the record function's stamps and the recorder's only the
    # recorder's bookkeeping runs, which allocates no object the garbage
    # collector tracks: the two agree on a span's length to a few
    # microseconds.
    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = _RecordFunction(self.name)
            self.rf.__enter__()
        rec = RECORDER
        self.gen = rec.generation
        self.i = rec.open(self.name, self.key)
        rec.stack().append(self.i)
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = RECORDER
        current = rec.generation == self.gen
        if current:
            if self.i >= 0:
                rec.close(self.i)
            rec.stack().pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return None


def on() -> bool:
    """Whether the recorder is on: a profiler is active, or :func:`enable`
    was called."""
    return _enabled or _profiling()


def span(name: str, key: int | None = None):
    """A span around a ``with`` block."""
    if not (_enabled or _profiling()):
        return _OFF
    return _Span(name, key)


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while the recorder is on."""
    if _enabled or _profiling():
        RECORDER.add(name, n)


def enable() -> None:
    """Record spans and counters until :func:`disable`, profiler or not."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    RECORDER.reset()


def summary() -> dict:
    return RECORDER.summary()


def records() -> list[Span]:
    return RECORDER.records()
