"""DPA-1's attention layers' share of their roofline: the least time of
their work, forward and backward over the live slots only (the family's
``attention_cost``: its operations at 67 TFLOP/s or its bytes, each read
or written once, at 3.35 TB/s, whichever is larger), over ``dpa1.attn_ms``.
The live slots are counted by the benchmark's own brute-force table at the
last call's final positions: sum_i n_i and sum_i n_i^2, n_i atom i's
neighbours within rcut."""

import torch

from mdbench import cost
from mdbench.reference.shared import neighbor_table


def measure(run):
    if not run.calls or not hasattr(run.entry, "attention_eval"):
        return
    dev = run.device
    pos = torch.as_tensor(run.calls[-1].pos, dtype=torch.float32, device=dev)
    box = torch.as_tensor(run.box, dtype=torch.float32, device=dev)
    n = (neighbor_table(pos, box, float(run.cell.config["rcut"])) >= 0) \
        .sum(dim=1).double()
    run.extra["dpa1_pairs"] = (float(n.sum()), float((n * n).sum()))


def read(run):
    ms, pairs = run.extra.get("dpa1_attn_ms"), run.extra.get("dpa1_pairs")
    if not ms or pairs is None:
        return None
    nbytes, ops = run.cell.family.attention_cost(run.cell.config, *pairs)
    bound_s, _ = cost.bound_s(nbytes, ops)
    return 100.0 * bound_s / (ms * 1e-3)
