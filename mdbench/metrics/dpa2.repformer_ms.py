"""Milliseconds of DPA-2's repformer layers alone (the port's
``dpa2.repformer`` span), forward and the backward that the forces take
(to the first g1 and to the second section's pair vectors), on the g1 and
the sections of the last call's final layout, by CUDA events (one call to
warm up, then the mean of three). Over ``dpa2.force_ms``: the layers' part
of an evaluation."""

from mdbench import prof

REPS = 3


def measure(run):
    if run.device.type != "cuda" or not hasattr(run.entry, "repformer_eval"):
        return
    fn = run.entry.repformer_eval(run.calls[-1])
    run.extra["dpa2_repformer_ms"] = prof.time_ms(fn, REPS)


def read(run):
    return run.extra.get("dpa2_repformer_ms")
