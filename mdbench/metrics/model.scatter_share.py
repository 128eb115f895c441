"""Share of the profiled stretch's device time spent in the force-and-virial
reduction: the kernels of ``kernels/dp_fused/csrc/prod_force_virial.cu``
(``prod_force_virial_kernel``, which scatters each slot's dE/dr_ij onto its
neighbour and its centre and sums the virial, and
``prod_force_finish_kernel``, which sums the blocks' virials and writes the
forces). Nothing where neither ran."""

NAMES = ("prod_force_virial_kernel", "prod_force_finish_kernel")


def read(run):
    p = run.profile
    if not p or p["device_s"] <= 0:
        return None
    scatter = sum(t for name, t, _ in p["kernels"]
                  if any(n in name for n in NAMES))
    if scatter <= 0:
        return None
    return 100.0 * scatter / p["device_s"]
