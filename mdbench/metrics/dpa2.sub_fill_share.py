"""Share of DPA-2's repformer section (the 4 A one, taken from the repinit
section every step) that holds a neighbour: its pairs within
repformer_rcut over atoms x its slots, counted at each host-side build
that the port accepted (``model.section`` spans of section "repformer"
with no excess), summed over the window's calls. The rest is padding that
every per-slot and per-pair pass of the six layers still runs over."""

from mdbench import spans

SECTION = "repformer"


def measure(run):
    spans.take(run)


def read(run):
    calls = spans.window_calls(run)
    if not calls:
        return None
    live = slots = 0
    for counts in spans.named(calls, "model.section"):
        for c in counts:
            if c.attrs.get("section") == SECTION and c.attrs["excess"] <= 0:
                live += c.attrs["live"]
                slots += c.attrs["atoms"] * c.attrs["slots"]
    return 100.0 * live / slots if slots else None
