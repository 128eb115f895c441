"""``dp_fused_bwd``'s share of its roofline: the least time of its work
(``mdbench/cost.py``: live-slot bytes read once at 3.35 TB/s, or its
operations at 67 TFLOP/s, whichever is larger), with the pairs within rcut
that the reference counted as the live slots, over the mean profiled time
of a launch. A force evaluation launches it once per neighbour-type
section, over all atoms at that section's escalated width; on bricks
(several cards) over the brick's atom capacity, with the brick's share of
the live pairs (its atoms' share of the system's)."""

from mdbench import cost

KERNEL = "::bwd_kernel("
NAME = "dp_fused_bwd"


def read(run):
    p = run.profile
    if not p or run.check is None or not run.calls:
        return None
    found = [(t, n) for name, t, n in p["kernels"] if KERNEL in name]
    launches = sum(n for _, n in found)
    seconds = sum(t for t, _ in found)
    if launches == 0 or seconds <= 0:
        return None
    cfg = run.cell.config
    sel = run.calls[-1].sel
    k, m = int(cfg["cheb_order"]), int(cfg["embed_widths"][-1])
    rows = run.extra.get("kernel_rows", run.atoms)
    share = run.extra.get("profiled_atoms", run.atoms) / run.atoms
    per_eval = sum(cost.kernel_bound_s(live * share, rows, int(n), k, m)[NAME][0]
                   for live, n in zip(run.check.live_pairs, sel))
    return 100.0 * per_eval * launches / len(sel) / seconds
