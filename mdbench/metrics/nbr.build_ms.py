"""Milliseconds a call in host-side neighbour builds: the ``nbr.build``
spans (each attempt, escalations included, up to its flag on the host),
summed per call, the mean over the window's calls."""

from mdbench import spans

measure = spans.take


def read(run):
    calls = spans.window_calls(run)
    return spans.mean_ms(calls, "nbr.build") if calls else None
