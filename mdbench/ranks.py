"""Runs a multi-card cell: one process and one card a rank, as the paper
deploys it. This process is rank 0; it starts the others (``spawn``), they
meet over TCP on a free port of this host (``env://``), and it waits for
every one of them before it returns."""

from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
from pathlib import Path
from typing import Callable, Dict, Optional

JOIN_S = 120.0
#: how long a rank waits for the others at the rendezvous and in a
#: collective before it gives up
WAIT_S = 300.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, workload: str, seed: int,
              seconds: float, trace: bool, device: str,
              benchmark: Optional[str] = None, base: Optional[str] = None,
              t_start: Optional[float] = None) -> Optional[Dict]:
    import torch
    import torch.distributed as dist

    from mdbench import manifest, run

    if device == "cuda":
        torch.cuda.set_device(rank)
        dev = f"cuda:{rank}"
    else:
        dev = "cpu"
    dist.init_process_group(backend="nccl" if device == "cuda" else "gloo",
                            init_method="env://", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=WAIT_S))
    try:
        cell = manifest.load(workload, Path(benchmark) if benchmark else None,
                             Path(base) if base else manifest.HERE)
        return run.run_cell(cell, seed, seconds, trace, device=dev,
                            t_start=t_start, rank=rank, world=world)
    finally:
        from repro_torch.md import domain
        domain.release_graphs()     # NCCL waits for them otherwise
        dist.destroy_process_group()


def launch(workload: str, seed: int, seconds: float, trace: bool,
           device: str, world: int, benchmark: Optional[str] = None,
           base: Optional[str] = None, t_start: Optional[float] = None,
           target: Callable = rank_main) -> Optional[Dict]:
    """Rank 0's result; ``t_start`` is when this process started (its
    set-up is counted from there). ``target`` runs each rank (tests give
    one that breaks the port first)."""
    os.environ["MASTER_ADDR"] = "localhost"
    os.environ["MASTER_PORT"] = str(_free_port())
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, workload, seed, seconds, trace,
                               device, benchmark, base))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        result = target(0, world, workload, seed, seconds, trace, device,
                        benchmark, base, t_start)
    finally:
        for p in procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.terminate()
                p.join(10.0)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank's process ended with {bad}")
    return result
