"""Escalations a call at which a type section overflowed: host-side
``nbr.build`` attempts whose ``section_excess`` is above 0, the mean over
the window's calls. Each grows every capacity, the cell bins included."""

from mdbench import spans

measure = spans.take


def read(run):
    calls = spans.window_calls(run)
    per = spans.named(calls, "nbr.build") if calls else []
    if not any(per):
        return None
    return sum(1 for builds in per for b in builds
               if b.attrs["section_excess"] > 0) / len(per)
