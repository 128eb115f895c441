"""Milliseconds of one eager DPA-1 energy-and-forces evaluation of the
whole system (the port's ``dpa1.force`` span: the compaction of the list
into the model's section, the model forward and backward, the force and
virial reduction), at the last call's final positions, list and section,
by CUDA events (one call to warm up, then the mean of three)."""

from mdbench import prof

REPS = 3


def measure(run):
    if run.device.type != "cuda" or not hasattr(run.entry, "attention_eval"):
        return
    fn = run.entry.force_eval(run.calls[-1])
    run.extra["dpa1_force_ms"] = prof.time_ms(fn, REPS)


def read(run):
    return run.extra.get("dpa1_force_ms")
