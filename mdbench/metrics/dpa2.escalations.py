"""Escalations a call of DPA-2's model sections, either of them
(``model.escalate`` spans: at a host build, or a segment or chunk run
again after the thermo showed pairs that did not fit), the mean over the
window's calls."""

from mdbench import spans


def measure(run):
    spans.take(run)


def read(run):
    calls = spans.window_calls(run)
    if not calls or not any(spans.named(calls, "model.section")):
        return None
    per = spans.named(calls, "model.escalate")
    return sum(len(e) for e in per) / len(per)
