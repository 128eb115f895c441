"""Spans and counters of the port's own work, on the host's clock.

``span(name, **attrs)`` times one stretch of the program with
``time.perf_counter_ns`` and keeps its name, its id, the span it ran inside
and the call it belongs to. Counters are attributes of the span in which
their work happens (``sp.set(filled=...)``); there is no separate registry.

``root(name, **attrs)`` opens a call: every span opened inside it, on the
same thread, carries the root's id. The root also keeps one pair of clocks,
``(perf_counter_ns, time_ns)`` read together as it opens, so a reader can
put the call's spans on another clock of the Unix epoch (a profiler's
trace, for one).

Finished spans go to one bounded buffer per process, oldest out first,
with a count of what it dropped; ``calls(k)`` returns the spans of the last
``k`` calls and, for each, how many of them the buffer lost. Each thread
keeps its own stack of open spans; appends are made under a lock.

The recorder is on by default. :func:`disable` turns each span into one
flag check; :func:`timed` spans still time themselves then (their duration
is a result of the program), but record nothing. Nothing here touches the
device or emits a profiler range.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional

#: finished spans kept per process (a call of the outer engine records one
#: span per chunk, replay, fetch and build: a few hundred)
CAPACITY = 1 << 15


class Record(NamedTuple):
    """One finished span."""
    name: str
    id: int
    parent: Optional[int]     # the span it ran inside, None at the top
    call: Optional[int]       # the id of its call's root, None outside calls
    t0_ns: int                # time.perf_counter_ns() at open
    t1_ns: int                # ... and at close
    attrs: Dict[str, Any]
    thread: int

    @property
    def ns(self) -> int:
        return self.t1_ns - self.t0_ns


class Call(NamedTuple):
    """A call's root and the spans inside it, in the order they closed."""
    root: Record
    spans: List[Record]
    lost: int                 # spans of the call the buffer dropped


_on = True
_lock = threading.Lock()
_buf: deque = deque(maxlen=CAPACITY)
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """An open span; a context manager. ``ns`` and ``seconds`` hold its
    duration once closed."""

    __slots__ = ("name", "attrs", "record", "is_root", "id", "parent",
                 "root_span", "count", "t0_ns", "t1_ns")

    def __init__(self, name: str, attrs: Dict[str, Any], record: bool = True,
                 is_root: bool = False):
        self.name, self.attrs = name, attrs
        self.record, self.is_root = record, is_root
        self.id = self.parent = self.root_span = None
        self.count = 0          # a root's spans, itself included
        self.t0_ns = self.t1_ns = 0

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        if self.record:
            stack = _stack()
            outer = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent = outer.id if outer is not None else None
            self.root_span = (self if self.is_root else
                              outer.root_span if outer is not None else None)
            stack.append(self)
            if self.is_root:
                self.attrs["clock"] = (time.perf_counter_ns(), time.time_ns())
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = time.perf_counter_ns()
        if self.record:
            _stack().pop()
            _finish(self)
        return False

    @property
    def ns(self) -> int:
        return self.t1_ns - self.t0_ns

    @property
    def seconds(self) -> float:
        return self.ns * 1e-9


class _Off:
    """What :func:`span` and :func:`root` return while disabled."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


_OFF = _Off()


def _finish(sp: Span) -> None:
    global _dropped
    root = sp.root_span
    rec = Record(sp.name, sp.id, sp.parent,
                 root.id if root is not None else None, sp.t0_ns, sp.t1_ns,
                 sp.attrs, threading.get_ident())
    with _lock:
        if root is not None:
            root.count += 1
            if root is sp:
                sp.attrs["spans"] = sp.count
        if len(_buf) == _buf.maxlen:
            _dropped += 1
        _buf.append(rec)


def span(name: str, **attrs: Any):
    """A span of ``name`` with ``attrs`` (a context manager)."""
    if not _on:
        return _OFF
    return Span(name, attrs)


def timed(name: str, **attrs: Any) -> Span:
    """A span whose duration the program uses: it times itself even while
    the recorder is disabled, and then records nothing."""
    return Span(name, attrs, record=_on)


def root(name: str, **attrs: Any):
    """The root span of a call; ``attrs`` gains the clock pair."""
    if not _on:
        return _OFF
    return Span(name, attrs, is_root=True)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def dropped() -> int:
    """Spans the bounded buffer has dropped since the last :func:`reset`."""
    return _dropped


def records() -> List[Record]:
    """Every kept span, in the order they closed."""
    with _lock:
        return list(_buf)


def reset(capacity: int = CAPACITY) -> None:
    """Empty the buffer and set its bound."""
    global _buf, _dropped
    with _lock:
        _buf = deque(maxlen=capacity)
        _dropped = 0


def calls(k: int) -> List[Call]:
    """The last ``k`` calls whose roots the buffer still holds, oldest
    first."""
    recs = records()
    roots = [r for r in recs if r.call == r.id][-k:] if k > 0 else []
    inside: Dict[int, List[Record]] = {r.id: [] for r in roots}
    for r in recs:
        if r.call in inside and r.call != r.id:
            inside[r.call].append(r)
    return [Call(r, inside[r.id], r.attrs["spans"] - 1 - len(inside[r.id]))
            for r in roots]
