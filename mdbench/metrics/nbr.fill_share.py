"""Share of the neighbour list's slots that hold a neighbour: the filled
slots over atoms x slots of each host-side build the port accepted
(``nbr.build`` spans with the flag at or below 0), summed over the window's
calls. The rest is padding that every per-slot pass still runs over."""

from mdbench import spans

measure = spans.take


def read(run):
    calls = spans.window_calls(run)
    if not calls:
        return None
    filled = slots = 0
    for builds in spans.named(calls, "nbr.build"):
        for b in builds:
            if b.attrs["overflow"] <= 0:
                filled += b.attrs["filled"]
                slots += b.attrs["atoms"] * sum(b.attrs["sel"])
    return 100.0 * filled / slots if slots else None
