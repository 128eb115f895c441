#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once.

    python3 mdbench/run.py --workload cu.weak.1card --seed 7 --seconds 10 \\
        --trace 0

From the root of a checkout. Set-up makes the system, the weights (on the
card, from the configuration's ``model_seed``: one model, as deployed) and
the port's Chebyshev table, builds the port's kernels (cached under
``build/dp_fused/`` in the checkout) and runs one short warm-up call at the
cell's shapes. The window then repeats whole
calls of the port's entry until ``--seconds`` have passed; it closes at the
end of the call in which they ran out. Each call starts from the cell's
system with velocities drawn from the seed and the call's index.

After the window: the peak memory is read, the port's state is freed and
the plain reference of the configuration's model family
(``mdbench/reference/<family>.py``) checks one call drawn from the seed
(see ``mdbench/check.py``). With ``--trace 0`` the last line of
standard output carries the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, read from a bounded profiled stretch of the window.
Each number compared, beside its limit, ends standard error and the line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from mdbench import check, inputs, manifest, prof  # noqa: E402
from mdbench.record import CallRecord, Run  # noqa: E402

#: top-level module names that the run may never load: JAX and the JAX
#: package that the port was made from (compared whole: the port's own name
#: begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi(query: str) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return " | ".join(out.stdout.strip().splitlines())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def log_call(i: int, rec: CallRecord, every: int) -> None:
    log(f"call {i}: seed {rec.seed}, sel {list(rec.sel)}, escalations "
        f"{rec.escalations}, host syncs {rec.host_syncs}, graph captures "
        f"{rec.graph_captures}, replays {rec.graph_replays}, capture "
        f"{rec.capture_s:.3f} s, port's loop {rec.wall_s:.3f} s")
    for t in list(range(every - 1, len(rec.pe), every)) or [len(rec.pe) - 1]:
        log(f"  step {t + 1:6d}  pe {rec.pe[t]:+.6f}  ke {rec.ke[t]:.6f}  "
            f"etot {rec.pe[t] + rec.ke[t]:+.6f} eV")


def _agree_done(done: bool, world: int) -> bool:
    """Rank 0's decision, the same on every rank."""
    if world == 1:
        return done
    import torch.distributed as dist
    flag = [done]
    dist.broadcast_object_list(flag, src=0)
    return bool(flag[0])


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             rank: int = 0, world: int = 1) -> Optional[Dict]:
    """One run of ``cell`` on this process's card; returns the result
    line's object on rank 0 (None on the other ranks of a multi-card
    cell)."""
    t_start = T_START if t_start is None else t_start
    lead = rank == 0
    say = log if lead else (lambda msg: None)
    dev = torch.device(device)
    run = Run(cell=cell, seed=int(seed), seconds=float(seconds),
              trace=bool(trace), device=dev)
    run.extra["cards"] = world
    traffic = cell.traffic
    if dev.type == "cuda":
        say(f"card: {nvidia_smi('name,power.limit,clocks.max.sm')}; "
            f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} visible")

    # ------------------------------------------------------------ set-up
    stages = [("imports and the card", time.perf_counter())]
    run.pos0, run.typ, run.box = inputs.system(traffic["system"], cell.base)
    run.weights = inputs.weights(
        cell.config, int(cell.config["model_seed"]), dev,
        inputs.env_scale(cell.config, run.pos0, run.typ, run.box, dev),
        cell.base)
    _sync(dev)
    if lead:
        log(f"weights digest {inputs.weights_digest(run.weights)}")
    stages.append(("system and weights", time.perf_counter()))
    run.entry = manifest.entry_class(traffic["entry"], cell.base)(run)
    _sync(dev)
    stages.append(("entry (kernels, table)", time.perf_counter()))
    every = max(1, run.steps // 10)
    warm = run.entry.call(inputs.call_seed(run.seed, -1),
                          int(traffic["warmup_steps"]))
    if lead:
        log_call(-1, warm, max(1, len(warm.pe)))
    if run.trace:
        prof.Stretch.warm()
    _sync(dev)
    run.setup_s = time.perf_counter() - t_start
    stages.append(("warm-up call", t_start + run.setup_s))
    marks = [t_start] + [t for _, t in stages]
    say(f"{cell.name}: {run.atoms} atoms, set-up {run.setup_s:.3f} s ("
        + ", ".join(f"{name} {marks[i + 1] - marks[i]:.3f} s"
                    for i, (name, _) in enumerate(stages)) + ")")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # ------------------------------------------------------------ window
    if run.trace:
        t = traffic["trace"]
        run.stretch = prof.Stretch(t["start_s"], t["seconds"])
    t0 = time.perf_counter()
    if run.stretch is not None:
        run.stretch.arm()
    try:
        while True:
            run.calls.append(run.entry.call(
                inputs.call_seed(run.seed, len(run.calls)), run.steps))
            if _agree_done(time.perf_counter() - t0 >= run.seconds, world):
                break
        _sync(dev)
        run.window_s = time.perf_counter() - t0
    finally:
        if run.stretch is not None:
            run.stretch.finish()
    if dev.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    if hasattr(run.entry, "gather"):
        run.entry.gather(run.calls)
    if world > 1:
        fullest(run)
    if hasattr(run.entry, "kernel_rows"):
        run.extra["kernel_rows"] = run.entry.kernel_rows
    if lead:
        for i, rec in enumerate(run.calls):
            log_call(i, rec, every)
    say(f"window {run.window_s:.3f} s, {len(run.calls)} calls of "
        f"{run.steps} steps; peak {run.memory_peak_bytes} B")
    if dev.type == "cuda":
        say(f"card after the window: "
            f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    if run.trace:
        run.profile = prof.summary(run.stretch.prof)
        busy_s, window_s = run.profile["busy_us"] * 1e-6, run.stretch.window_s
        if world > 1:
            import torch.distributed as dist
            every = [None] * world
            dist.all_gather_object(every, (busy_s, window_s))
            busy_s = sum(b for b, _ in every) / world
            window_s = sum(w for _, w in every) / world
        run.extra["busy_s"], run.extra["trace_window_s"] = busy_s, window_s
        say(f"profiled stretch {window_s:.3f} s, device busy {busy_s:.3f} s"
            f" (the mean over {world} card(s))")
        if lead:
            for name, sec, count in run.profile["kernels"][:12]:
                log(f"  {sec * 1e3:10.3f} ms {count:7d}x  {name[:100]}")
            for m in cell.per_layer:
                if hasattr(m.module, "measure"):
                    m.module.measure(run)

    # ------------------------------------------- free the port, then check
    run.entry.release()
    run.entry = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not lead:
        return None
    t_check = time.perf_counter()
    run.check = check.run_check(run)
    log(f"check {time.perf_counter() - t_check:.3f} s (the reference: its "
        f"table, the sampled call's steps, every call's end energy)")

    metrics = {}
    for m in (cell.per_layer if run.trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {found}")
    result = {"correct": run.check.correct, "attempted": len(run.calls),
              "failed": run.check.failed, "metrics": metrics,
              "device": device_line(run, world)}
    if run.trace:
        result["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s, _ in
                           run.profile["kernels"][:10]],
            "idle_gaps": [[n, s] for n, s in run.profile["idle_gaps"][:10]]}
    result["checks"] = run.check.line()
    return result


def fullest(run: Run) -> None:
    """The fullest card's peak and the atoms it held (rank 0's run takes
    them)."""
    import torch.distributed as dist
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (run.memory_peak_bytes,
                                   int(getattr(run.entry, "owned", 0))))
    peak, owned = max(every)
    run.memory_peak_bytes = peak
    run.extra["atoms_on_card"] = owned
    run.extra["profiled_atoms"] = every[0][1]


def device_line(run: Run, world: int = 1) -> Dict:
    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": world,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
           "count": world,
           "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace:
        out["busy_s"] = run.extra["busy_s"]
        out["window_s"] = run.extra["trace_window_s"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and does "
              "not run on the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    if cell.chips > 1:
        from mdbench import ranks
        result = ranks.launch(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", cell.chips,
                              t_start=T_START)
    else:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    for line in check.stderr_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
