"""Milliseconds of one eager energy-and-forces evaluation of the whole
system, at the last call's final positions and escalated slot layout, by
CUDA events (one call to warm up, then the mean of three)."""

from mdbench import prof

REPS = 3


def measure(run):
    if run.device.type != "cuda" or not hasattr(run.entry, "force_eval"):
        return
    fn = run.entry.force_eval(run.calls[-1])
    run.extra["force_ms"] = prof.time_ms(fn, REPS)


def read(run):
    return run.extra.get("force_ms")
