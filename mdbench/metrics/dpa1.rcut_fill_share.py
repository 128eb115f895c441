"""Share of the model's own section that holds a neighbour: the pairs within
rcut over atoms x the section's slots, counted on the compaction at each
host-side build that the port accepted (``model.section`` spans with no
excess), summed over the window's calls. The rest is padding that every
per-slot and per-pair pass of the attention still runs over."""

from mdbench import spans

measure = spans.take


def read(run):
    calls = spans.window_calls(run)
    if not calls:
        return None
    live = slots = 0
    for counts in spans.named(calls, "model.section"):
        for c in counts:
            if c.attrs["excess"] <= 0:
                live += c.attrs["live"]
                slots += c.attrs["atoms"] * c.attrs["slots"]
    return 100.0 * live / slots if slots else None
