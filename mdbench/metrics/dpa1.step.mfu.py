"""The whole DPA-1 step's share of the card's float32 peak: the family's
count of one energy-and-forces evaluation (``reference/dpa1.py``:
``force_eval_flops``, forward and backward over the pairs within rcut that
the reference counted, the attention's pairs of slots bounded below from
that total) times the evaluations of the window's calls (steps + 1 a call),
over the window's wall time, over 67 TFLOP/s a card."""

from mdbench import cost


def read(run):
    if not run.calls or run.window_s <= 0 or run.check is None:
        return None
    flops = run.cell.family.force_eval_flops(run.cell.config, run.atoms,
                                             sum(run.check.live_pairs))
    evals = len(run.calls) * (run.steps + 1)
    cards = run.extra.get("cards", 1)
    return 100.0 * flops * evals / run.window_s / (cost.PEAK_FP32_FLOPS
                                                    * cards)
