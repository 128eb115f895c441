"""The force-and-virial reduction's share of its roofline: the least time of
its work (``mdbench/cost.py``, ``force_virial_bound_s``: the nlist of the
filled slots and one -1 a section, the live slots' dE/dr_ij and r_ij and
the forces, each byte once at 3.35 TB/s), with the pairs within rcut that
the reference counted as the live slots and those within rcut + skin as
the filled ones, over the mean profiled time of one evaluation: both
kernels' time over the launches of ``prod_force_virial_kernel``. A force
evaluation launches it once, over all atoms and every section at the
escalated widths; on bricks (several cards) over the brick's atom
capacity, with the brick's share of the pairs (its atoms' share of the
system's)."""

from mdbench import cost

KERNEL = "prod_force_virial_kernel"
FINISH = "prod_force_finish_kernel"


def read(run):
    p = run.profile
    if (not p or run.check is None or run.check.filled_pairs is None
            or not run.calls):
        return None
    launches = sum(n for name, _, n in p["kernels"] if KERNEL in name)
    seconds = sum(t for name, t, _ in p["kernels"]
                  if KERNEL in name or FINISH in name)
    if launches == 0 or seconds <= 0:
        return None
    rows = run.extra.get("kernel_rows", run.atoms)
    share = run.extra.get("profiled_atoms", run.atoms) / run.atoms
    live = sum(run.check.live_pairs) * share
    filled = run.check.filled_pairs * share
    bound_s, _ = cost.force_virial_bound_s(live, filled, rows,
                                           len(run.calls[-1].sel), rows)
    return 100.0 * bound_s * launches / seconds
