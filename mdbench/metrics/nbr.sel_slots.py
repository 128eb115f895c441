"""Neighbour slots per atom after escalation (``MDResult.sel`` summed over
the types): the width that every per-slot pass of the model runs over."""


def read(run):
    if not run.calls or not run.calls[-1].sel:
        return None
    return float(sum(run.calls[-1].sel))
