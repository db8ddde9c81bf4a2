"""Spans of the steps inside the program's entries, taken while a
``torch.profiler`` session runs.

A span records its name, its start and end on ``time.perf_counter_ns``,
the thread, the id of the call it belongs to (shared by every span of one
call: a span opened with none open on its thread starts a call), its
parent's id and, where asked (``cpu=True``), the thread's CPU time inside
it (``time.thread_time_ns``).  The CPU clock is a system call: on an
H100's host a read took 3.9 us from one thread and 20 us from each of 8
at once, against 0.11 us for the wall clock, so a span reads it only
where a reading needs it.

Each span is also an annotation of the profiler (what
``torch.profiler.record_function(name)`` makes), so a session that
records the thread's host events exports it as a ``user_annotation`` on
the clock of the card's kernels and copies (the ``tpu.profile`` stage
traces, say).  It is made through torch's binding that keeps the GIL:
``record_function`` itself goes through the dispatcher, which hands the
GIL to any waiting thread at its start and at its end, and a thread that
hands it over waits to get it back behind the other callers.

The gate is torch's own process-wide flag of a running profiler session.
It reads the same whatever the session records: a session of the card's
events alone records spans too.  The per-thread flag
(``torch.autograd._profiler_enabled``) reads False in threads that a
session started elsewhere does record, so it cannot gate them.  With no
session an entry pays one check a call: :func:`active`, then :func:`off`
for its steps, which hands back one shared context that does nothing.

Records go to a buffer per thread (no lock a span); :func:`spans`
returns them all and :func:`reset` drops them.  Attributes that cost
work to find can be left to :func:`spans`, which adds them when it reads
the span (``_Open.later``), off the path that the span times.  Nothing is written: the
profiler's trace is the export.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time

import torch.autograd.profiler as _profiler
from torch._C._autograd import (
    _record_function_with_args_enter as _annotate,
    _record_function_with_args_exit as _annotate_end)


@dataclasses.dataclass(frozen=True, slots=True)
class Span:
    name: str
    start_ns: int       # time.perf_counter_ns()
    end_ns: int
    cpu_ns: int | None  # the thread's CPU time inside it, where asked
    thread: int         # threading.get_ident()
    call: int           # shared by every span of one call
    id: int
    parent: int | None  # the enclosing span's id on the same thread
    attrs: dict


_ids = itertools.count(1)
_calls = itertools.count(1)
_local = threading.local()
_buffers: list[tuple[threading.Thread, list[Span]]] = []
_buffers_lock = threading.Lock()
_LATER = "_later"   # the attributes a span leaves to spans()


def active() -> bool:
    """Whether a ``torch.profiler`` session is running in this process."""
    return _profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


OFF = _Off()


def off(name: str, cpu: bool = False, **attrs) -> _Off:
    """The step of an entry that found no session: does nothing."""
    return OFF


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "attrs", "cpu", "id", "parent", "call",
                 "annotation", "t0", "c0")

    def __init__(self, name: str, cpu: bool, attrs: dict):
        self.name = name
        self.cpu = cpu
        self.attrs = attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.buffer = []
            with _buffers_lock:
                _buffers.append((threading.current_thread(), _local.buffer))
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up else None
        self.call = up.call if up else next(_calls)
        stack.append(self)
        self.annotation = _annotate(self.name)
        self.c0 = time.thread_time_ns() if self.cpu else 0
        self.t0 = time.perf_counter_ns()
        return self

    def later(self, attrs) -> None:
        """Add ``attrs()`` (a dict) to the span's attributes when
        :func:`spans` reads it, and not now."""
        self.attrs.setdefault(_LATER, []).append(attrs)

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        cpu = time.thread_time_ns() - self.c0 if self.cpu else None
        _annotate_end(self.annotation)
        _local.stack.pop()
        _local.buffer.append(Span(
            self.name, self.t0, t1, cpu, threading.get_ident(),
            self.call, self.id, self.parent, self.attrs))
        return False


def span(name: str, cpu: bool = False, **attrs):
    """A context that records the span ``name`` (with ``attrs``, and the
    thread's CPU time where ``cpu``) while a profiler session runs, and
    does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Open(name, cpu, attrs)


def spans() -> list[Span]:
    """Every recorded span of every thread, by start, each with the
    attributes that it left for now (``_Open.later``)."""
    with _buffers_lock:
        buffers = [b for _, b in _buffers]
    out = sorted((s for b in buffers for s in list(b)),
                 key=lambda s: (s.start_ns, s.id))
    for s in out:
        for attrs in s.attrs.pop(_LATER, ()):
            s.attrs.update(attrs())
    return out


def reset() -> None:
    """Drop every recorded span (call it with no span open), and the
    buffers of threads that have ended."""
    with _buffers_lock:
        for _, b in _buffers:
            b.clear()
        _buffers[:] = [(t, b) for t, b in _buffers if t.is_alive()]
