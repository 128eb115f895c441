"""Escalations a call of the model's own section (``model.escalate`` spans:
at a host build, or a segment or chunk run again after the thermo showed
pairs within rcut that did not fit), the mean over the window's calls."""

from mdbench import spans

measure = spans.take


def read(run):
    calls = spans.window_calls(run)
    if not calls or not any(spans.named(calls, "model.section")):
        return None
    per = spans.named(calls, "model.escalate")
    return sum(len(e) for e in per) / len(per)
