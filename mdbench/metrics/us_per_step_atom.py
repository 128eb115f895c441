"""Microseconds per step per atom (the paper's unit): the window's wall
clock, to the last call's synchronize, over the steps x atoms of all its
calls. Each call pays its own first neighbour build, escalation and, on the
outer engine, capture, as a user's run of that length does."""


def read(run):
    work = run.steps * run.atoms * len(run.calls)
    return run.window_s * 1e6 / work if work else None
