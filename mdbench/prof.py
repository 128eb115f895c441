"""Profiler helpers: a bounded, profiled stretch of the window, the card's
busy time in it, kernel time by name, and the longest idle gaps.

``device_busy``, ``kernel_table`` and the CUDA-event timer are copies of the
smoke run's helpers (``chip_smoke.py``: ``device_busy``, ``log_kernels``,
``time_ms``), frozen here.

The stretch is started and stopped on the main thread by SIGALRM, so it can
open and close in the middle of a call: a Python signal handler runs on the
main thread between two bytecodes, where the program's own Python is. A
handler that lands while a CUDA graph is being captured tries again 0.25 s
later, so the profiler never starts or stops inside a capture.
"""

from __future__ import annotations

import signal
import time
from typing import Dict, List, Optional, Tuple

import torch


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def dev_us(e) -> float:
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0))


class Stretch:
    """Profiles the stretch from ``start_s`` after :meth:`arm` for
    ``seconds``, or until :meth:`finish`, whichever comes first."""

    RETRY_S = 0.25

    def __init__(self, start_s: float, seconds: float):
        self.start_s = float(start_s)
        self.seconds = float(seconds)
        self.prof = None
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self._old = None

    @staticmethod
    def warm() -> None:
        """Initialise the profiler once, in set-up (CUPTI's first start is
        slow)."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(8, device="cuda").add_(1)
            torch.cuda.synchronize()

    def arm(self) -> None:
        self._old = signal.signal(signal.SIGALRM, self._on_alarm)
        if self.start_s <= 0.0:
            self._start()
        else:
            signal.setitimer(signal.ITIMER_REAL, self.start_s)

    def _on_alarm(self, signum, frame) -> None:
        if torch.cuda.is_current_stream_capturing():
            signal.setitimer(signal.ITIMER_REAL, self.RETRY_S)
        elif self.prof is None:
            self._start()
        else:
            self._stop()

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()
        signal.setitimer(signal.ITIMER_REAL, self.seconds)

    def _stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def finish(self) -> None:
        """Stop the stretch if it is still open (the window closed first)."""
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, self._old or signal.SIG_DFL)
        if self.prof is not None and self.t1 is None:
            self._stop()

    @property
    def window_s(self) -> float:
        if self.t0 is None or self.t1 is None:
            return 0.0
        return self.t1 - self.t0


def device_intervals(prof) -> List[Tuple[float, float, str]]:
    """(start us, end us, name) of every kernel, copy and fill on the card."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if _is_device(e))


def device_busy(spans: List[Tuple[float, float, str]]) -> float:
    """Microseconds in which at least one device row ran: the union."""
    if not spans:
        return 0.0
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for a, b, _ in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo = a
        hi = max(hi, b)
    return busy + hi - lo


def kernel_table(prof) -> List[Tuple[str, float, int]]:
    """(name, device seconds, count) of each device row kind, largest
    first."""
    rows = [(e.key, dev_us(e) * 1e-6, e.count) for e in prof.key_averages()
            if _is_device(e) and dev_us(e) > 0]
    return sorted(rows, key=lambda r: -r[1])


def idle_gaps(prof, spans: List[Tuple[float, float, str]], top: int = 10
              ) -> List[Tuple[str, float]]:
    """The ``top`` longest gaps between device rows, each named by the host
    op that overlapped it most (``host: <op>``), in seconds."""
    gaps = []
    if spans:
        hi = spans[0][1]
        for a, b, _ in spans[1:]:
            if a > hi:
                gaps.append((hi, a))
            hi = max(hi, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:top]
    host = [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if not _is_device(e)]
    out = []
    for lo, hi in gaps:
        best, name = 0.0, "no host op recorded"
        for a, b, n in host:
            ov = min(b, hi) - max(a, lo)
            if ov > best:
                best, name = ov, n
        out.append((f"host: {name}"[:120], (hi - lo) * 1e-6))
    return out


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after one call to warm up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def summary(prof) -> Dict:
    """Everything the readers take from one profiled stretch."""
    spans = device_intervals(prof)
    table = kernel_table(prof)
    return {"spans": spans, "busy_us": device_busy(spans), "kernels": table,
            "idle_gaps": idle_gaps(prof, spans),
            "device_s": sum(t for _, t, _ in table)}
