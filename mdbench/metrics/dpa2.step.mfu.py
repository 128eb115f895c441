"""The whole DPA-2 step's share of the card's float32 peak: the family's
count of one energy-and-forces evaluation (``reference/dpa2.py``:
``force_eval_flops``, forward and backward over the pairs within rcut
that the reference counted, and over the pairs within repformer_rcut and
their pairs of slots that the benchmark's own table counts at the last
call's final positions) times the evaluations of the window's calls
(steps + 1 a call), over the window's wall time, over 67 TFLOP/s a
card."""

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
    pairs = run.extra.get("dpa2_sub_pairs")
    if not run.calls or run.window_s <= 0 or run.check is None \
            or pairs is None:
        return None
    flops = run.cell.family.force_eval_flops(
        run.cell.config, run.atoms, sum(run.check.live_pairs), *pairs)
    evals = len(run.calls) * (run.steps + 1)
    cards = run.extra.get("cards", 1)
    return 100.0 * flops * evals / run.window_s / (cost.PEAK_FP32_FLOPS
                                                    * cards)
