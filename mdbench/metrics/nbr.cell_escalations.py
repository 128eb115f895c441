"""Escalations a call at which a cell bin overflowed: host-side
``nbr.build`` attempts whose ``bin_excess`` is above 0, the mean over the
window's calls. Each grows every capacity, type sections included."""

from mdbench import spans

measure = spans.take


def read(run):
    calls = spans.window_calls(run)
    per = spans.named(calls, "nbr.build") if calls else []
    if not any(per):
        return None
    return sum(1 for builds in per for b in builds
               if (b.attrs["bin_excess"] or 0) > 0) / len(per)
