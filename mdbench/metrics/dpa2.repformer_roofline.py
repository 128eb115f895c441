"""DPA-2's repformer layers' share of their roofline: the least time of
their work, forward and backward over the live slots of the repformers'
list only (the family's ``repformer_cost``: its operations at 67 TFLOP/s
or its bytes, each read or written once, at 3.35 TB/s, whichever is
larger), over ``dpa2.repformer_ms``. The live slots are counted by the
benchmark's own brute-force table at the last call's final positions:
sum_i n_i and sum_i n_i^2, n_i atom i's neighbours within
repformer_rcut."""

import torch

from mdbench import cost
from mdbench.reference.shared import neighbor_table


def measure(run):
    if not run.calls or "dpa2_sub_pairs" in run.extra:
        return
    dev = run.device
    pos = torch.as_tensor(run.calls[-1].pos, dtype=torch.float32, device=dev)
    box = torch.as_tensor(run.box, dtype=torch.float32, device=dev)
    rc = float(run.cell.config["repformer_rcut"])
    n = (neighbor_table(pos, box, rc) >= 0).sum(dim=1).double()
    run.extra["dpa2_sub_pairs"] = (float(n.sum()), float((n * n).sum()))


def read(run):
    ms = run.extra.get("dpa2_repformer_ms")
    pairs = run.extra.get("dpa2_sub_pairs")
    if not ms or pairs is None:
        return None
    nbytes, ops = run.cell.family.repformer_cost(run.cell.config, run.atoms,
                                                 *pairs)
    bound_s, _ = cost.bound_s(nbytes, ops)
    return 100.0 * bound_s / (ms * 1e-3)
