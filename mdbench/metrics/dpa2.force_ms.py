"""Milliseconds of one eager DPA-2 energy-and-forces evaluation of the
whole system (the port's ``dpa2.force`` span: both sections compacted from
the list, repinit, the repformer layers, the fitting, the backward and the
force and virial reduction), at the last call's final positions, list and
sections, by CUDA events (one call to warm up, then the mean of three)."""

from mdbench import prof

REPS = 3


def measure(run):
    if run.device.type != "cuda" or not hasattr(run.entry, "repformer_eval"):
        return
    fn = run.entry.force_eval(run.calls[-1])
    run.extra["dpa2_force_ms"] = prof.time_ms(fn, REPS)


def read(run):
    return run.extra.get("dpa2_force_ms")
