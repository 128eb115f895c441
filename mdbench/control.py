#!/usr/bin/env python3
"""Reads the control of a cell's comparison: the plain reference computed
one precision below the configuration's (TF32 matmuls), put in the port's
place, against the reference in float32.

    python3 mdbench/control.py --workload cu.weak.1card --seeds 11,12,13

For each seed: the system and weights that a benchmark run with that seed
makes, the start of its first call, the reference followed for the
traffic's ``follow_steps`` in float32 and in TF32, and the numbers of
``mdbench/check.py`` with the TF32 run as the candidate (``pe_end`` at the
TF32 run's last positions), held to the limits of ``limits/<cell>.json``
as a run's are. One JSON line per seed with its verdict, ``correct``, and
each number beside its limit; the exit code is 1 where any seed's verdict
is ``correct``. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from mdbench import check, inputs, manifest  # noqa: E402
from mdbench.record import Run  # noqa: E402


def control_outcome(cell: manifest.Cell, seed: int, device: str):
    """The cell's check with the control as the candidate: every number it
    reads, and the :class:`check.Outcome` of those held to the cell's
    limits, whose ``correct`` has to come out false."""
    dev = torch.device(device)
    run = Run(cell=cell, seed=seed, seconds=0.0, trace=False, device=dev)
    run.pos0, run.typ, run.box = inputs.system(cell.traffic["system"],
                                               cell.base)
    run.weights = inputs.weights(
        cell.config, int(cell.config["model_seed"]), dev,
        inputs.env_scale(cell.config, run.pos0, run.typ, run.box, dev),
        cell.base)
    call = inputs.call_seed(seed, 0)
    model, typ, box, mass = check.reference_inputs(run)
    want = check.follow(run, model, typ, box, mass, call)
    low = check.reference_inputs(run, precision="tf32")[0]
    got = check.follow(run, low, typ, box, mass, call)
    whole = len(want.pe) == run.steps
    pos = got.pos.cpu().numpy()
    numbers = check.compare(got.pe, got.ke, pos if whole else None,
                            got.vel.cpu().numpy() if whole else None, want,
                            run.atoms, run.box)
    numbers["pe_end"], _ = check.end_energy_gap(model, got.pe[-1], pos, typ,
                                                box, dev)
    out = check.Outcome.held(numbers, cell.limits)
    out.failed = 0 if out.correct else 1
    return numbers, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = manifest.load(args.workload)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    verdicts = []
    for s in args.seeds.split(","):
        numbers, out = control_outcome(cell, int(s), args.device)
        verdicts.append(out.correct)
        print(json.dumps({"workload": cell.name, "seed": int(s),
                          "control": numbers, "correct": out.correct,
                          "checks": out.line()}), flush=True)
    # the control has to fail the comparison on every seed
    return 1 if any(verdicts) else 0


if __name__ == "__main__":
    sys.exit(main())
