"""Spans of the program's own host work, on the profiler's clock.

``with span(name, **attrs) as s:`` marks one stretch of host work at a
layer boundary (``Engine.__call__``, the parameter walk, each block, each
kernel wrapper, ...).  A span records only while a ``torch.profiler`` is
recording (``torch.autograd.profiler._is_profiler_enabled``), so spans are
switched on the way an operator already profiles, and by nothing else.
With no profiler running, ``span`` reads that flag and returns the shared
:data:`OFF` object: no record, no ``record_function``, no clock read.

While recording, a span appends a :class:`Span` to this process's buffer
as it opens and stamps its start and end with ``time.time_ns()``, the clock
the profiler stamps its events with, so the spans line up with the device
operations of the same trace.  A span opened inside another on the same
thread is its child; a span opened with none open starts a call, whose id
every span below it shares (an ``Engine`` call's spans share the id of its
``ivit.call``).  The buffer holds at most :data:`CAPACITY` spans and counts
those it drops; :func:`spans` reads it, :func:`clear` empties it.  Nothing
is written anywhere.

A span enters no ``torch.profiler.record_function``: on an H100 (torch
2.11, CUDA 12.8) the profiler projects each such range onto the device's
timeline as an event of the device, which a reduction of the trace then
counts among the device's operations, and under a device-only profile the
first one cost about 100 ms.

A span is truthy only while it records, so an attribute that costs work
to compute is set under ``if s: s.set(...)``.  :func:`spanned` makes a
whole function call one span.
"""

from __future__ import annotations

import functools
import threading
import time

from torch.autograd import profiler as _profiler

CAPACITY = 65536

_lock = threading.Lock()
_local = threading.local()        # .stack: the open spans of this thread
_records = []
_state = {"dropped": 0, "calls": 0}


class Span:
    """One recorded span: ``name``, ``start_ns`` / ``end_ns`` (``time.time_ns``;
    ``end_ns`` None while open), ``parent`` (its index in :func:`spans`, None
    for a call's root), ``call`` (the id of the call it belongs to) and
    ``attrs``."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "attrs")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = self.parent = self.call = None

    def __bool__(self):
        return True

    def __repr__(self):
        return (f"Span({self.name!r}, start_ns={self.start_ns}, end_ns={self.end_ns}, "
                f"parent={self.parent}, call={self.call}, attrs={self.attrs})")

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            if len(_records) >= CAPACITY:
                _state["dropped"] += 1
                return OFF
            if stack:
                self.parent, self.call = stack[-1][1], stack[-1][0].call
            else:
                self.call = _state["calls"]
                _state["calls"] += 1
            stack.append((self, len(_records)))
            _records.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.call is None:          # dropped: never opened
            return False
        self.end_ns = time.time_ns()
        _local.stack.pop()
        return False


class _Off:
    """What :func:`span` returns while nothing records: falsy, and every
    method a no-op."""

    __slots__ = ()

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


OFF = _Off()


def span(name, **attrs):
    """A context manager that records ``name`` while a profiler records
    (:class:`Span`), else :data:`OFF`."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return Span(name, attrs)


def spanned(name):
    """A decorator: each call of the function is the span ``name``.  The
    wrapper keeps the function's name, docstring and attributes
    (``functools.wraps``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with Span(name, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def spans():
    """The recorded spans, in the order they opened."""
    with _lock:
        return list(_records)


def dropped():
    """Spans not recorded because the buffer was full."""
    return _state["dropped"]


def clear():
    """Empty the buffer and the drop count (call ids keep counting).  Spans
    open at the time keep their indices, which then name nothing."""
    with _lock:
        _records.clear()
        _state["dropped"] = 0
