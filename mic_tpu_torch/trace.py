"""Spans and counters of the port's own phases, kept in memory.

A span is one phase of the program (a plan's staging, a run's launches,
an assemble), never one strip or one image: strips and images are
counted instead.  The decode plan (``tpu/strips.py``), the library
loader (``_build.py``) and the host encoder record them; a caller reads
them with :func:`take`.

    from mic_tpu_torch import trace
    trace.enable()
    plan = MicwDecodePlan(blobs, "cuda:0")            # plan.stage and its parts
    with trace.request(7):                            # spans inside carry request 7
        plan.assemble_device(plan.run())
    spans, counts = trace.take()
    trace.disable()

Off (the default), :func:`span` and :func:`request` return one shared
no-op context and :func:`count` returns at once: nothing is recorded.
There is no environment variable, flag or exporter.

Time is ``time.perf_counter_ns()``.  :func:`enable` stores one anchor,
``time.time_ns() - time.perf_counter_ns()``: a span's start plus
:func:`anchor_ns` lies on the clock of ``time.time_ns()``, the base of
torch.profiler's trace (kineto's ``trace_start_ns()``), so spans and the
card's records can be laid side by side.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

__all__ = ["Span", "anchor_ns", "count", "counters", "disable", "enable", "request", "span",
           "take"]


class Span(NamedTuple):
    """One recorded span: ``request`` is the id of the request it ran in
    (None outside one), ``parent`` the id of the span it ran inside (0 at
    the top of its thread), ``start`` and ``end`` ``perf_counter_ns``."""

    name: str
    request: object
    id: int
    parent: int
    start: int
    end: int
    attrs: dict


_on = False
_anchor = 0
_spans: list[Span] = []
_counts: dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()  # per thread: the open spans' ids, the current request
_lock = threading.Lock()  # over the records and counters, which every thread adds to


class _Off:
    """The no-op context of :func:`span` and :func:`request` when off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.request = None
    return stack


class _Open:
    """An open span; records itself when it closes."""

    __slots__ = ("name", "attrs", "rid", "sid", "parent", "t0", "prev")

    def __init__(self, name, attrs, rid=None):
        self.name, self.attrs, self.rid = name, attrs, rid

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else 0
        self.sid = next(_ids)
        stack.append(self.sid)
        self.prev = _local.request
        if self.rid is not None:  # a request span: it and its children carry the id
            _local.request = self.rid
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        record = Span(self.name, _local.request, self.sid, self.parent, self.t0, t1, self.attrs)
        with _lock:
            _spans.append(record)
        _local.request = self.prev
        return False


def enable() -> None:
    """Record from now on, with a fresh anchor to the wall clock."""
    global _on, _anchor
    _anchor = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable() -> None:
    """Record nothing more; what was recorded stays for :func:`take`."""
    global _on
    _on = False


def anchor_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()`` at the last :func:`enable`."""
    return _anchor


def span(name: str, **attrs):
    """A context that records one span named ``name`` with ``attrs``."""
    if not _on:
        return _OFF
    return _Open(name, attrs)


def request(rid):
    """A context around one request: a span named ``request`` whose id and
    whose children's ``request`` is ``rid``."""
    if not _on:
        return _OFF
    return _Open("request", {}, rid)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """A snapshot of the counters recorded since the last :func:`take`.
    Launches are not among them: each kernel wrapper counts its own in
    ``.launches``, and a ``run.<kernel>`` span carries its plan's."""
    with _lock:
        return dict(_counts)


def take() -> tuple[list[Span], dict[str, int]]:
    """The spans and counters recorded since the last call, cleared."""
    global _spans
    with _lock:
        spans, counts = _spans, dict(_counts)
        _spans = []
        _counts.clear()
    return spans, counts
