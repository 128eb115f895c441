"""Milliseconds of each call's first energy-and-forces evaluation, up to
the device's finish (the ``model.first_force`` span), the mean over the
window's calls. Beside ``model.force_ms``: the same evaluation inside a
user's call."""

from mdbench import spans

measure = spans.take


def read(run):
    calls = spans.window_calls(run)
    return spans.mean_ms(calls, "model.first_force") if calls else None
