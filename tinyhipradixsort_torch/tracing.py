"""Spans, instants and counters of the port's own work, recorded only when
a caller asks.

``with tracing.record() as rec:`` records every span the port opens in
the thread that entered it; at the block's end ``rec.spans``,
``rec.instants``, ``rec.counts`` and ``rec.memory`` hold what it saw.
``with tracing.observe(fn):`` also calls ``fn(event, name, attrs)`` at
each span's ``"begin"`` (before its clock is read) and ``"end"`` (after),
and at each ``"instant"``: a tool can record a CUDA event at a span's
edge there, outside the span's own time.

A span (:class:`Span`) holds its name, the call it belongs to, its id and
its parent's, its start and end, and a few small attributes (``n``,
``words``, ``pass``, ``shift``, ``width``, ``route``, ``engine``;
``counting.sort``'s ``key_bytes``, ``payload_bytes``, ``idx_bytes``, the
element size of its offsets, 4 or 8, and ``passes``). A
span entered ``as s`` while recording takes more attributes in ``s.attrs``
until it ends, for what is known only inside it. A span opened while no span is
open is the root of a new call: the public ``sort_keys``, ``sort_pairs``
and ``sort_indices`` (an engine called directly roots its own call). The
layer of a span follows its name: the root is the API's; ``launch.*`` is
the host side of one kernel launch (argument packing and the ctypes call,
each also counted as ``launches``); every other span is an engine's
(``bitonic.*``, ``counting.*``, ``argsort.*``, ``cuda_lib.build``).
:func:`split` divides each call's time among the three, and
:func:`paths_at` names what the host was inside at given times. The
counting engine's counters a call: ``counting.pad_copies`` and
``counting.pad_bytes`` (the arrays its staging copied, and the bytes it
wrote into those copies; neither where rows are whole tiles, aligned and
contiguous), ``counting.passes``, ``counting.moved_bytes`` and
``rank_scatter.overlapped``.

The clock is ``time.perf_counter_ns()``: ``perf_counter``'s, which the
benchmark (``sortbench``) stamps each call with and on which it places the
device trace's operations, so spans and device operations share one clock
without a second alignment.

Off (no record), :func:`span` returns one shared no-op context manager
after a single ``is None`` test: it reads no clock and records nothing;
:func:`event`, :func:`count` and :func:`on` return after the same test
(a counter whose argument costs work is guarded by :func:`on`). Nothing turns
recording on but :func:`record` and :func:`observe`: no environment
variable, no option. The recorder is one per process and follows one
thread; spans opened in other threads are not recorded.

While recording, a ``gc.callbacks`` hook adds a ``gc`` span for each
collection (attribute ``gen``). It is no span's child, so it does not
reduce the self time of the span it interrupts, and :func:`paths_at`
names a time inside it ``gc`` first. The record also keeps the change of
``torch.cuda.memory_stats()``'s :data:`MEMORY_STATS` over its block in
``rec.memory`` (None where CUDA is not initialised): ``cudaMalloc`` and
``cudaFree`` calls, and the allocator's synchronisations of every stream.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import itertools
import threading
import time
from typing import NamedTuple

import torch

#: ``torch.cuda.memory_stats()`` keys whose change over a record it keeps
MEMORY_STATS = ("num_device_alloc", "num_device_free", "num_sync_all_streams")


class Span(NamedTuple):
    """One span; times in ``perf_counter`` nanoseconds. ``call`` and
    ``parent`` are None for a ``gc`` span outside any call, and ``parent``
    for a call's root and every ``gc`` span."""
    name: str
    call: int | None
    id: int
    parent: int | None
    start: int
    end: int
    attrs: dict


class Instant(NamedTuple):
    """One instant (a route decision) inside span ``parent`` of ``call``."""
    name: str
    call: int | None
    parent: int | None
    t: int
    attrs: dict


class Recording:
    """What one :func:`record` saw: ``spans`` in the order they ended,
    ``instants`` in order, ``counts`` ``{(call, name): total}`` (call None
    outside any call) and ``memory`` (see the module docstring).

    During the block ``spans`` and ``instants`` hold flat tuples, their
    fields followed by the attributes' keys and values in turn, which the
    garbage collector stops tracking at their first collection (a tuple
    that holds a container, or an instance of a tuple subclass, stays
    tracked, so every full collection would walk the whole record and come
    more often); at the block's end they become :class:`Span` and
    :class:`Instant`."""

    def __init__(self):
        self.spans: list[Span] = []
        self.instants: list[Instant] = []
        self.counts: dict = {}
        self.memory: dict | None = None
        self.observers: list = []
        self._thread = threading.get_ident()
        self._open: list[int] = []  # ids of the open spans, innermost last
        self._next_id = itertools.count(1).__next__  # safe from gc hooks
        self._calls = 0
        self._gc_start = None

    def _call(self):
        return self._calls if self._open else None

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = time.perf_counter_ns()
        elif self._gc_start is not None:
            self.spans.append(("gc", self._call(), self._next_id(), None,
                               self._gc_start, time.perf_counter_ns(),
                               "gen", info["generation"]))
            self._gc_start = None


def _flat(attrs: dict) -> list:
    return [x for kv in attrs.items() for x in kv]


def _unflat(kind, t: tuple):
    """A :class:`Span` or :class:`Instant` from its flat tuple."""
    k = len(kind._fields) - 1
    return kind(*t[:k], dict(zip(t[k::2], t[k + 1::2])))


class _Off:
    """The span every call gets while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
#: the recording in progress, or None
_REC: Recording | None = None


class _On:
    """A span being recorded."""
    __slots__ = ("rec", "name", "attrs", "id", "parent", "start")

    def __init__(self, rec: Recording, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        if rec._open:
            self.parent = rec._open[-1]
        else:
            self.parent = None
            rec._calls += 1
        self.id = rec._next_id()
        rec._open.append(self.id)
        for fn in rec.observers:
            fn("begin", self.name, self.attrs)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = self.rec
        rec.spans.append((self.name, rec._calls, self.id, self.parent,
                          self.start, end, *_flat(self.attrs)))
        rec._open.pop()
        for fn in rec.observers:
            fn("end", self.name, self.attrs)
        return False


def span(name: str, **attrs):
    """A context manager around one piece of work (see the module
    docstring); the shared no-op one while nothing records."""
    rec = _REC
    if rec is None:
        return _OFF
    if threading.get_ident() != rec._thread:
        return _OFF
    return _On(rec, name, attrs)


def event(name: str, **attrs) -> None:
    """Record an instant (a route decision) inside the open span."""
    rec = _REC
    if rec is None or threading.get_ident() != rec._thread:
        return
    rec.instants.append((name, rec._call(),
                         rec._open[-1] if rec._open else None,
                         time.perf_counter_ns(), *_flat(attrs)))
    for fn in rec.observers:
        fn("instant", name, attrs)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the open call's counter ``name``."""
    rec = _REC
    if rec is None or threading.get_ident() != rec._thread:
        return
    key = (rec._call(), name)
    rec.counts[key] = rec.counts.get(key, 0) + k


def on() -> bool:
    """Whether this thread records: guards a counter whose ``k`` costs
    work to compute, so that off it costs the same one test."""
    rec = _REC
    return rec is not None and threading.get_ident() == rec._thread


def _memory_stats():
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats()
    return {k: stats.get(k) for k in MEMORY_STATS}


@contextlib.contextmanager
def record():
    """Record the port's spans over the block; yields the
    :class:`Recording`, complete once the block has ended. One at a time."""
    global _REC
    if _REC is not None:
        raise RuntimeError("tracing.record() is already recording")
    rec = Recording()
    before = _memory_stats()
    gc.callbacks.append(rec._gc)
    _REC = rec
    try:
        yield rec
    finally:
        _REC = None
        gc.callbacks.remove(rec._gc)
        rec.spans = [_unflat(Span, t) for t in rec.spans]
        rec.instants = [_unflat(Instant, t) for t in rec.instants]
        after = _memory_stats()
        if after is not None:
            rec.memory = {k: None if v is None else
                          v - ((before or {}).get(k) or 0)
                          for k, v in after.items()}


@contextlib.contextmanager
def observe(fn):
    """Call ``fn(event, name, attrs)`` at each span's begin and end and at
    each instant over the block, inside the record in progress or a new
    one; yields that :class:`Recording`."""
    with (record() if _REC is None else contextlib.nullcontext(_REC)) as rec:
        rec.observers.append(fn)
        try:
            yield rec
        finally:
            rec.observers.remove(fn)


def split(spans) -> dict:
    """Each call's time by layer, in ns: ``{call: {"api", "engines",
    "kernels"}}``. ``api`` is the root span's time not covered by its
    children; ``engines`` the engine spans' time not covered by their
    children; ``kernels`` the ``launch.*`` spans' whole time (a span
    inside a launch, such as a first call's build, counts in it). ``gc``
    spans are no one's children and count nowhere. The three sum to the
    root span's duration."""
    by_id = {s.id: s for s in spans if s.name != "gc"}
    below = {}  # id -> time its children cover
    for s in by_id.values():
        if s.parent is not None:
            below[s.parent] = below.get(s.parent, 0) + s.end - s.start
    of = {}  # id -> layer, or None inside a launch
    out = {}
    for s in sorted(by_id.values(), key=lambda s: s.id):  # parents first
        if of.get(s.parent, "engines") in (None, "kernels"):
            of[s.id] = None
            continue
        lay = of[s.id] = ("api" if s.parent is None else "kernels"
                          if s.name.startswith("launch.") else "engines")
        own = s.end - s.start
        if lay != "kernels":
            own -= below.get(s.id, 0)
        layers = out.setdefault(s.call, {"api": 0, "engines": 0,
                                         "kernels": 0})
        layers[lay] += own
    return out


def paths_at(spans, times) -> list:
    """For each time (ns), the names from the root down to the innermost
    span open then, joined by ``" > "`` (``"sort_keys > bitonic.sort_words
    > launch.bitonic_sweep"``); ``"gc"`` inside a collection; None where
    no span was open."""
    order = sorted(spans, key=lambda s: (s.start, s.id))
    starts = [s.start for s in order]
    by_id = {s.id: s for s in spans}
    out = []
    for t in times:
        found = None
        # the innermost span open at t is the latest begun of those open
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            s = order[i]
            if s.end > t:
                found = s
                break
            if s.parent is None and s.name != "gc":
                break  # a call that ended before t: no earlier span is open
        if found is None or found.name == "gc":
            out.append(None if found is None else "gc")
            continue
        names = []
        while found is not None:
            names.append(found.name)
            found = by_id.get(found.parent)
        out.append(" > ".join(reversed(names)))
    return out
