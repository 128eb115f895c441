"""Milliseconds of DPA-1's attention layers alone (the port's
``dpa1.attention`` span), forward and the backward that the forces take
(to G0 and to the gates w_j w_k and w_j w_k r^_j . r^_k), on the G0 and the
section of the last call's final layout, by CUDA events (one call to warm
up, then the mean of three). Beside ``dpa1.force_ms``: the attention's part
of an evaluation."""

from mdbench import prof

REPS = 3


def measure(run):
    if run.device.type != "cuda" or not hasattr(run.entry, "attention_eval"):
        return
    fn = run.entry.attention_eval(run.calls[-1])
    run.extra["dpa1_attn_ms"] = prof.time_ms(fn, REPS)


def read(run):
    return run.extra.get("dpa1_attn_ms")
