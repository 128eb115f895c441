"""Share of the profiled stretch's device time spent in the force scatter:
``index_add_``'s kernels (``indexFuncLargeIndex`` / ``indexFuncSmallIndex``,
atomics on the card)."""

NAMES = ("indexFuncLargeIndex", "indexFuncSmallIndex")


def read(run):
    p = run.profile
    if not p or p["device_s"] <= 0:
        return None
    scatter = sum(t for name, t, _ in p["kernels"]
                  if any(n in name for n in NAMES))
    if scatter <= 0:
        return None
    return 100.0 * scatter / p["device_s"]
