"""The port's own spans (``repro_torch.obs``), for the readers under
``metrics/``: the window's calls, and their spans on the profiler's clock.

The window's calls are the last ``len(run.calls)`` call roots the recorder
holds (the warm-up call and anything built outside a call fall outside
them). They are taken once, by a reader's ``measure(run)`` right after the
window, and kept in ``run.extra``. A program without the recorder, a call
root missing, or a call that lost spans to the recorder's bound gives None,
and every reader then finds nothing.

A span's times are ``time.perf_counter_ns`` readings; its call's root keeps
one pair ``(perf_counter_ns, time_ns)``. The profiler's events are
microseconds from the trace's start, ``trace_start_ns()`` on the Unix
epoch, so ``to_trace_us`` moves a span onto that timebase.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

KEY = "port_calls"

Interval = Tuple[float, float]


def recorder():
    """The port's span recorder, or None where the program has none."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs


def take(run) -> None:
    """Keep the window's calls in ``run.extra`` (once)."""
    if KEY in run.extra:
        return
    obs = recorder()
    calls = obs.calls(len(run.calls)) if obs is not None and run.calls \
        else []
    ok = len(calls) == len(run.calls) > 0 and not any(c.lost for c in calls)
    run.extra[KEY] = calls if ok else None


def window_calls(run) -> Optional[list]:
    take(run)
    return run.extra[KEY]


def named(calls, name: str) -> List[list]:
    """Each call's spans of ``name``."""
    return [[s for s in c.spans if s.name == name] for c in calls]


def mean_ms(calls, name: str) -> Optional[float]:
    """The mean over the calls of each call's summed ``name`` spans, in
    milliseconds; None where no call has one."""
    per = named(calls, name)
    if not any(per):
        return None
    return sum(s.ns for spans in per for s in spans) * 1e-6 / len(per)


# ------------------------------------------------ the profiler's timebase

def trace_start_ns(prof) -> Optional[int]:
    """The trace's start on the Unix epoch, from a finished
    ``torch.profiler.profile``."""
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is None:
        return None
    if hasattr(res, "trace_start_ns"):
        return int(res.trace_start_ns())
    if hasattr(res, "trace_start_us"):
        return int(res.trace_start_us()) * 1000
    return None


def to_trace_us(t_ns: int, clock: Sequence[int], start_ns: int) -> float:
    """A ``perf_counter_ns`` reading as microseconds from the trace's
    start, by the call root's clock pair."""
    perf0, epoch0 = clock
    return (t_ns - perf0 + epoch0 - start_ns) * 1e-3


def span_intervals(calls, start_ns: int) -> List[Tuple[float, float, str]]:
    """(start us, end us, name) of the calls' spans, roots left out, on the
    trace's timebase."""
    out = []
    for c in calls:
        clock = c.root.attrs["clock"]
        for s in c.spans:
            out.append((to_trace_us(s.t0_ns, clock, start_ns),
                        to_trace_us(s.t1_ns, clock, start_ns), s.name))
    return out


# --------------------------------------------------------------- intervals

def union(intervals: Sequence[Interval], lo: float, hi: float
          ) -> List[Interval]:
    """The union of ``intervals`` clipped to [lo, hi], sorted, disjoint."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(disjoint: Sequence[Interval]) -> float:
    return sum(b - a for a, b in disjoint)


def gaps(disjoint: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """[lo, hi] less a sorted, disjoint union."""
    out, at = [], lo
    for a, b in disjoint:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def overlap(x: Sequence[Interval], y: Sequence[Interval]) -> float:
    """The length two sorted, disjoint unions share."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            total += b - a
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_by_span(idle: Sequence[Interval],
                 spans: Sequence[Tuple[float, float, str]], lo: float,
                 hi: float) -> Dict[str, float]:
    """Microseconds of ``idle`` under each span name (a stretch under a
    span and its parent counts for both)."""
    names: Dict[str, List[Interval]] = {}
    for a, b, name in spans:
        names.setdefault(name, []).append((a, b))
    return {name: overlap(idle, union(iv, lo, hi))
            for name, iv in names.items()}
