#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card
    python3 chip_smoke.py --phases 10c   # phases 1, 3 and 10 (c) alone

Phases; any failure exits non-zero before the result line:
  1. the card's name and power limit (nvidia-smi); build the dp_fused CUDA
     kernels from ``src/repro_torch/kernels/dp_fused/csrc`` and print the
     build time and nvcc's register/shared-memory report.
  2. each kernel against its plain version (``ref.py``, run in 4,096-row
     chunks) at the copper slice's shapes, K=32, M=128, on env/s rows of a
     32,000-atom copper configuration: 4,096 rows at N=512 and at the
     escalated N, then all 32,000 rows at the escalated N, the shape the
     main path runs; then water's two neighbor sections after escalation,
     all 41,472 rows of water_box(6,6,6) at full WATER_DP width. Zeros past
     each count; ragged counts with NaN poison past each count (those slots
     must never be read). Times: kernel, plain version, bound and share of
     the bound at each shape, and the cuBLAS-backed composition that
     materialises G (the yardstick; whole on the 4,096 rows, in 4,096-row
     chunks summed at the main path's and water's shapes; it is several
     calls, so the JSON line's ``library_ms`` is null). The JSON line
     reports the main path's shape. Then the force-and-virial reduction
     (``kernels/dp_fused/force.py``) at the benchmark cells' shapes (the
     main path's escalated lists of 123,008 and 864 copper atoms and of
     155,520 water atoms, random dE/dr_ij): one line each with the kernel,
     the plain version (mask, index_add_, row sum, einsum), index_add_
     alone and the byte bound. Then DPA-1's gated attention kernels
     (``kernels/dp_fused/attention.py``) at dpa1.h2o.1card's shape (24,000
     atoms x 120 slots x 128 features, ~70% of each row live): forward and
     backward against the plain version, kernel and plain ms and the bound.
  3. the main path: ``Simulation.run`` of the paper's copper protocol (NVE,
     330 K, 99 steps, rebuild every 50 with a 2 A skin) on fcc_copper(20,20,20)
     = 32,000 atoms at full COPPER_DP width, impl="cheb_pallas", engine
     "scan", weights random from a seed and Chebyshev-tabulated. Both kernels
     and the force reduction must launch >= 100 times (once each per force
     evaluation), the thermo must be finite and |d etot| per atom <= 1e-4
     eV. A profile of three force evaluations splits the device time by
     kernel.
  4. one energy_forces on fcc_copper(10,10,10): cheb_pallas against cheb on
     the card (energy rtol 1e-5, forces atol 5e-5).
  5. the main path through engine="outer": each segment (on-device rebuild
     + steps) captured once as a CUDA graph and replayed. Launches counted
     from what ran (>= 100 each), host syncs, captures and replays, drift,
     and the thermo rows and final positions against phase 3's scan run
     (rtol 1e-5, 1e-4 A by minimum image, velocities 1e-5 A/fs). One
     segment replayed under the profiler, and the rebuild alone captured
     and timed: its share of a segment.
  6. water_box(6,6,6) = 41,472 atoms at full WATER_DP width, cheb_pallas,
     Langevin at 330 K, engine "outer", 99 steps: each kernel launches on
     both neighbor sections (>= 200 each), the temperature stays finite and
     within 25% of 330 K; the final sel is printed.
  7. the quintic rung against mlp and cheb_pallas at full COPPER_DP width on
     fcc_copper(10,10,10), with each rung's peak memory (energy rtol 1e-4,
     forces atol 5e-5 of max(1, max|F|)).
  8. npt_scr (Langevin + stochastic cell rescale) on fcc_copper(10,10,10)
     at full COPPER_DP width, engine "outer", 99 steps: the box moves and
     the thermo stays finite.
  9. LJ on fcc_copper(20,20,20) and fcc_copper(10,10,10), scan against
     outer: the engine-overhead case (the force evaluation is cheap),
     us/step/atom of both and a profile of one force evaluation.
 10. distributed copper on the one card (``md/domain.py`` under
     ``LocalComm``: one thread and CUDA stream per rank), fcc_copper(20,20,20)
     at full COPPER_DP width, cheb_pallas, NVE. (a) 2x2x2 bricks, model
     axis 1: one step at jittered positions against the single-process port
     (PE 1e-4 + 1e-5 |E|, forces 1e-5 max(1, max|F|), virial 2e-3 relative:
     the reference harness's tolerances), then the 99-step protocol from
     phase 3's velocities, eager (the oracle) and through the captured
     outer program (each segment length recorded once as a CUDA graph of
     all 8 ranks, each segment one replay): atoms constant, drift <= 1e-4
     eV/atom, thermo rows against phase 3's at rtol 1e-5, the captured run
     against the eager one (thermo rtol 1e-5, positions 1e-4 A by minimum
     image); launches 8 x 100 eager, 8 x (100 + one warm-up step a
     capture) captured; (b) 4 slabs x 2 model shards, the kernels on
     neighbor-slot slices: the same one-step parity, then 10 steps eager
     and captured (against each other and (a)). Each kernel held against
     ref.py at the shape each path gives it; launch counts per path,
     us/step/atom, capture seconds, replays, peak memory, the graph pool's
     bytes, the sweeps' share of the device time, the card's busy share
     and the host's launch calls, eager and during a replay
     (torch.profiler). (c) with two or more cards, ``DistComm`` over NCCL,
     one process and one card a rank (spawned; (2, 2) x 1 in atoms and
     (2,) x 2 in slots on four cards, (2,) x 1 on two): the 99-step
     protocol eager, then with each process recording its own rank's
     segments as CUDA graphs: captured against eager (thermo rtol 1e-6,
     positions 1e-4 A by minimum image), both against LocalComm's
     thread-ranks of the same grid on card 0 and phase 3 (rtol 1e-5),
     atoms constant, drift <= 1e-4 eV/atom; launches 100 eager and 102
     captured a process, us/step/atom, capture seconds, the graph pool,
     rank 0's busy share and host launch calls eager and in a replay.
     With one card it prints why it did not run.
 11. DP training at full COPPER_DP width (``repro_torch.train``, the
     ``mlp`` rung, which launches no kernel): teacher data on 16 jittered
     fcc_copper(5,5,5) = 500-atom configurations, the student (seed 0)
     after fit_env_stats, 100 AdamW steps of minibatch 4 through the loss's
     double backward: loss and grad_norm finite every step, rmse_f at the
     last log below the first; ms/step (median after the first 5),
     configurations/s, peak memory. One step at minibatch 1 on the card
     (index_add_'s deterministic version) against the CPU (every leaf's
     gradient rtol 1e-4, atol 1e-5 max|g|; loss and grad_norm rtol 1e-5). save_async + restore onto the card:
     leaves bit for bit, 5 more steps from both at loss rtol 1e-6. The
     trained student tabulated: quintic dE/dF printed; cheb_pallas through
     the kernels against mlp on 2 held-out configurations (energy rtol
     1e-5, forces atol 5e-5 max(1, max|F|)), each kernel held against
     ref.py at that shape (path "train_check"); a profile of two steps by
     kind of kernel and the device's busy share.

 12. the dry run (``repro_torch.launch.md_dryrun``) of the paper's cells
     cu, cu_strong and h2o x all four rungs, rank (0, 0) of the 16 x 16
     grid, 2-step segments: a fake CUDA trace per row (memory, the cell
     list's share, FLOPs, bytes, collective bytes, the roofline terms
     against the H100). Each row whose estimate fits under 70% of the
     card's memory runs for real on the card (``run_rank``: the rank's
     brick as a periodic lattice block whose halo is its own far faces):
     its peak memory above the allocation before it must be 0.75-1.25x the
     estimate, energies finite, atoms kept, no overflow flag (a neighbour
     overflow escalates sel once, as the drivers do, and the estimate is
     traced again at that sel); ms/step against the roofline's bound. The
     kernels at the cheb_pallas runs' shapes against ref.py and timed
     (path "dryrun").
 13. LM serving (``repro_torch.launch.serve_lm.serve``: prefill, then greedy
     decode through ``make_serve_step``), 4 requests of prompt 256 + 32
     decode steps, weights from seed 0 drawn on the card: qwen3-1.7b and
     granite-moe-1b-a400m at full CONFIG, served in bf16 as published and
     timed, then checked: (a) f32 decode == teacher-forced forward (rtol
     1e-3, atol 1e-3 x max|logit|), (b) the bf16 decode adds no error of its
     own (mean and 99.9th-percentile distance from the f32 forward within
     1.25x the bf16 forward's; the reference's rtol 0.08 / atol 0.05
     printed), (c) finite logits and the cache at 288; granite's checks
     route drop-free and (b) replays the forward's routing. xlstm-125m,
     whisper-base (1,500 stub frames) and recurrentgemma-9b (full width, 3
     of 38 layers) in f32 with (a) and (c). Prefill and decode times, peak
     memory, the decode step's byte bound, a profile of one qwen3 decode
     step; dp_fused launches (0) under path "lm_serve".
 14. LM training (``repro_torch.launch.train``): (a) the main path,
     ``train_loop`` of qwen3-1.7b at full CONFIG, 10 steps of 2 x 4096
     tokens (train_4k's sequence, its global batch 256 cut to 2), bf16 on
     f32 masters, remat on: finite losses and grad norms, step 10, every
     leaf moved; ms/step over steps 3-10, tokens/s, the model FLOP share
     against 989 TFLOP/s dense bf16, peak memory, a profile of one step.
     (b) qwen3 cut to 2 layers in f32, 1 x 512 tokens: every leaf's
     gradient on the card against the CPU and remat on against off
     (1e-4 x max|g|); what each AdamW update allocates. (c)
     granite-moe-1b-a400m at full CONFIG, 3 steps of 2 x 4096: moe_aux > 0
     and a gradient on the router and every expert. (d) xlstm-125m,
     whisper-base and recurrentgemma-9b (3 of 38 layers) at full width, 2
     steps of 2 x 512: finite losses. (e) whisper-base checkpoint resume
     through ``train_loop``, bit for bit under deterministic algorithms.
     dp_fused launches (0) under path "lm_train".
 15. LM sharding (``repro_torch.sharding``): (a) ``train_loop`` of
     qwen3-1.7b at full width, 4 of 28 layers, 2 x 512 tokens, on 4 ranks
     of the one card (threads of torch's threaded process group, a 2 x 2
     (data, model) grid: FSDP x TP) against one rank from the same seed:
     6 bf16 steps within 5e-3, 3 f32 steps within 1e-4, the gathered init
     bit for bit, every gradient in its parameter's placements, the step-3
     checkpoint written on (2, 2) continued on (1, 4) within 2e-2. (b) the
     LM dry run (``launch.dryrun``) on fake CUDA tensors over a fake
     process group: qwen3-1.7b's train_4k, prefill_32k and decode_32k on
     16 x 16 and 2 x 16 x 16, and glm4-9b, qwen2-72b, granite-3-8b and
     llava-next-34b train_4k on 16 x 16, traced at 2 and 3 layers and
     carried to full depth, in 6 processes started after (a)'s timed
     steps: peak, FLOPs, bytes, collective bytes by kind,
     the roofline on the H100, trace seconds. (c) the qwen3 rows under 70%
     of the card run for real at full depth (the fake group stands in for
     the other ranks: the time is the rank's compute alone): real peak
     over the estimate in [0.75, 1.25], ms against bound_time. dp_fused
     launches (0) under path "lm_dist".
 16. LM sharding of the MoE, ssm, hybrid and encdec families: (a)
     ``train_loop`` of granite-moe-1b-a400m at full width (32 experts
     top-8, expert-parallel over the model axis), 4 of 24 layers, 2 x 512
     tokens, on 4 thread-ranks (2 x 2) against one rank: 3 f32 steps
     within 1e-4, 6 bf16 steps within 5e-3 with the single rank's
     routing replayed in the sharded run (bf16 router near-ties flip
     between free runs; the flips are printed), the gathered init bit for
     bit, every gradient in its parameter's placements, 16 experts a
     rank, moe_aux > 0, a gradient on every expert; (b) xlstm-125m,
     whisper-base and recurrentgemma-9b (8 of 12 and 3 of 38 layers),
     f32, 2 steps of
     2 x 512 within 1e-4 of one rank (xlstm's first-step gradient and its
     second step held against a one-rank run in another summation
     order), then sharded prefill + 4 decode steps within 1e-4 x
     max|logit|; (c) the dry run of their 17 cells on 16 x 16 (fake CUDA
     tensors, 2 + 3 units, 6 processes started after (a)'s timed steps);
     (d) 5 of those rows for real (real
     peak over estimate in [0.75, 1.25], ms against bound_time). dp_fused
     launches (0) under path "lm_dist_families".

Prints the kernels' JSON line (``launches`` of the main path, phase 3, and
``launches_by_path`` of every path), then ``{"ok": true, "device": {...}}``
last.
TF32 is off for matmuls and cuDNN throughout: every product is FP32.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/dp_fused/csrc/dp_fused.cu"
REPLACES = {"dp_fused_fwd": "src/repro/kernels/dp_fused/dp_fused.py:145",
            "dp_fused_bwd": "src/repro/kernels/dp_fused/dp_fused.py:182"}
SEED = 0
SAMPLE_ATOMS = 4096
MAIN_NX = 20         # fcc_copper(20,20,20) = 32,000 atoms: the main path
SMALL_NX = 10        # fcc_copper(10,10,10) = 4,000 atoms
WATER_NX = 6         # water_box(6,6,6) = 41,472 atoms


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name, got, want, rtol, scale_atol):
    """allclose with atol scaled by the largest |want|: f32 sums in another
    order than the plain version, over hundreds of slots."""
    atol = scale_atol * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, rtol=rtol, atol=atol)
    log(f"  {name}: max_abs_err {err:.3e} (atol {atol:.2e}, rtol {rtol:g})"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


# ------------------------------------------------------------------ phase 1

def phase_card_and_build():
    from repro_torch.kernels.dp_fused import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    kl = build.load()
    log(f"[1] built {kl.path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kl.seconds:.2f} s)")
    for line in kl.log.splitlines():
        if "Function properties" in line or "Used" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")


# ------------------------------------------------------------------ phase 2

def copper_rows(cfg, params, dev):
    """env/s of all atoms of a jittered 32,000-atom copper box, built with
    the main path's neighbor search and escalation."""
    from repro_torch.core import descriptor, dp_model
    from repro_torch.md import lattice, neighbors, stepper

    pos, typ, box = lattice.fcc_copper(*[MAIN_NX] * 3)
    rng = np.random.default_rng(SEED)
    pos = np.mod(pos + rng.normal(0.0, 0.05, pos.shape), box)
    pos_t = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    typ_t = torch.as_tensor(typ, dtype=torch.int64, device=dev)
    nspec = neighbors.NeighborSpec(rcut_nbr=cfg.rcut + 2.0, sel=cfg.sel)
    bld = stepper.build_neighbors_escalating(cfg, nspec, box, pos_t, typ_t)
    with torch.no_grad():
        rij, nmask = dp_model.gather_rij(pos_t, bld.nlist,
                                         stepper.pack_box(box, dev))
        env, s = descriptor.env_matrix(rij, nmask, cfg.rcut_smth, cfg.rcut)
        env, s = descriptor.normalize_env(env, s, typ_t, params["dstd"])
        del rij, nmask
    return env, s, bld.spec.sel[0]


def library_fwd(s, env, c, lo, hi):
    """T through cuBLAS with G materialised: basis, GEMM, batched GEMM."""
    from repro_torch.core import tabulation
    g = tabulation.cheb_eval({"coeffs": c, "lower": lo, "upper": hi}, s)
    return torch.bmm(env.transpose(1, 2), g)


def library_bwd(s, env, c, dt, lo, hi):
    """ds, denv through cuBLAS with G and G' materialised."""
    from repro_torch.kernels.dp_fused import ref
    u_raw = (2.0 * s - lo - hi) / (hi - lo)
    basis, dbasis = ref.cheb_basis_pair(u_raw.clamp(-1.0, 1.0), c.shape[0])
    g, gp = basis @ c, dbasis @ c
    denv = torch.bmm(g, dt.transpose(1, 2))
    w = torch.bmm(env, dt)
    ds = (w * gp).sum(-1) * (2.0 / (hi - lo)) * (u_raw.abs() < 1.0)
    return ds, denv


def bounds(live: int, a: int, n: int, k: int, m: int):
    """Least time (ms) for each kernel's work on these inputs: the bytes
    and FP32 operations of ``ops.kernel_cost`` (each input byte read once,
    live slots only; each output byte written once; the factored
    algorithm's operations, which the dry run's FLOP counter also uses)
    against the H100's data-sheet peaks (``roofline.HW_H100``)."""
    from repro_torch.analysis.roofline import HW_H100
    from repro_torch.kernels.dp_fused import ops

    out = {}
    for name, (b, f) in ops.kernel_cost(live, a, n, k, m).items():
        t_b = b / HW_H100.hbm_bw * 1e3
        t_f = f / HW_H100.peak_flops * 1e3
        out[name] = (max(t_b, t_f), "bytes" if t_b >= t_f else "operations")
    return out


def by_rows(fn, *xs):
    """``fn`` over SAMPLE_ATOMS-row chunks of ``xs``, outputs concatenated:
    the plain contracts work row by row, and a chunk's G and G' fit."""
    parts = [fn(*(x[i:i + SAMPLE_ATOMS] for x in xs))
             for i in range(0, xs[0].shape[0], SAMPLE_ATOMS)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def kernel_case(label, s, env, c, lo, hi, dev, gen, sample, chunked_lib):
    """Both kernels against the plain version on one (s, env) block: the
    values, zeros past each count, ragged counts with NaN poison past each
    count, and times against the bound. ``sample``: time the cuBLAS
    composition whole; ``chunked_lib``: time it in SAMPLE_ATOMS-row chunks,
    summed (it materialises G, which does not fit whole at the main path's
    shape)."""
    from repro_torch.kernels.dp_fused import ops, ref

    a, n = s.shape
    k, m = c.shape

    def plain_fwd(s, env, counts):
        return by_rows(lambda *x: ref.fused_fwd_ref(*x[:2], c, x[2], lo, hi),
                       s, env, counts)

    def plain_bwd(s, env, counts, dt):
        return by_rows(lambda *x: ref.fused_bwd_ref(*x[:2], c, *x[2:], lo, hi),
                       s, env, counts, dt)

    counts = ops.live_counts(s)
    live = int(counts.sum())
    dt = torch.randn((a, 4, m), generator=gen, device=dev)
    log(f"[2] {label}: A={a} N={n} K={k} M={m}: live slots {live} "
        f"({live / (a * n):.1%}), max count {int(counts.max())}")
    err_f = check_close("fwd", ops.fused_fwd(s, env, c, counts, lo, hi),
                        plain_fwd(s, env, counts), 1e-4, 1e-5)
    ds, denv = ops.fused_bwd(s, env, c, counts, dt, lo, hi)
    ds_r, denv_r = plain_bwd(s, env, counts, dt)
    err_b = max(check_close("bwd ds", ds, ds_r, 3e-4, 3e-5),
                check_close("bwd denv", denv, denv_r, 3e-4, 3e-5))
    past = torch.arange(n, device=dev)[None, :] >= counts[:, None]
    if bool(ds[past].any()) or bool(denv[past].any()):
        raise AssertionError("gradients past the count are not zero")
    del ds, denv, ds_r, denv_r

    # ragged counts, NaN poison past each count
    cut = (counts.float() * torch.rand(a, generator=gen, device=dev)).int()
    past = torch.arange(n, device=dev)[None, :] >= cut[:, None]
    s_c = torch.where(past, 0.0, s)
    env_c = torch.where(past[..., None], 0.0, env)
    s_p = torch.where(past, float("nan"), s)
    env_p = torch.where(past[..., None], float("nan"), env)
    check_close("ragged+poison fwd", ops.fused_fwd(s_p, env_p, c, cut, lo, hi),
                plain_fwd(s_c, env_c, cut), 1e-4, 1e-5)
    ds_p, denv_p = ops.fused_bwd(s_p, env_p, c, cut, dt, lo, hi)
    ds_c, denv_c = plain_bwd(s_c, env_c, cut, dt)
    check_close("ragged+poison ds", ds_p, ds_c, 3e-4, 3e-5)
    check_close("ragged+poison denv", denv_p, denv_c, 3e-4, 3e-5)
    if bool(ds_p[past].any()) or bool(denv_p[past].any()):
        raise AssertionError("gradients past the count are not zero")
    del s_c, env_c, s_p, env_p, ds_p, denv_p, ds_c, denv_c, past

    # the plain version runs in row chunks: 2 timed calls past the sample
    reps = 5 if sample else 2
    lib = {"dp_fused_fwd": lambda: library_fwd(s, env, c, lo, hi),
           "dp_fused_bwd": lambda: library_bwd(s, env, c, dt, lo, hi)}
    if chunked_lib:
        lib = {"dp_fused_fwd": lambda: by_rows(
                   lambda s_, e_: library_fwd(s_, e_, c, lo, hi), s, env),
               "dp_fused_bwd": lambda: by_rows(
                   lambda s_, e_, d_: library_bwd(s_, e_, c, d_, lo, hi),
                   s, env, dt)}
    t = {
        "dp_fused_fwd": (
            time_ms(lambda: ops.fused_fwd(s, env, c, counts, lo, hi), 20),
            time_ms(lambda: plain_fwd(s, env, counts), reps), err_f),
        "dp_fused_bwd": (
            time_ms(lambda: ops.fused_bwd(s, env, c, counts, dt, lo, hi), 20),
            time_ms(lambda: plain_bwd(s, env, counts, dt), reps), err_b),
    }
    bnd = bounds(live, a, n, k, m)
    results = {}
    for name, (ms, plain_ms, err) in t.items():
        lib_ms = (time_ms(lib[name], reps) if sample or chunked_lib
                  else None)
        lib_txt = "not timed" if lib_ms is None else (
            f"{lib_ms:.4f} ms" + (f" ({SAMPLE_ATOMS}-row chunks, summed)"
                                  if chunked_lib else ""))
        log(f"  {name}: kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
            f"cuBLAS composition {lib_txt} | bound {bnd[name][0]:.4f}"
            f" ms ({bnd[name][1]}) | {bnd[name][0] / ms:.1%} of bound")
        # no single PyTorch call computes this function, so the
        # composition is printed above but library_ms stays null
        results[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[name][0],
            "bound_by": bnd[name][1], "library_ms": None}
    return results


def water_rows(cfg, dev):
    """env/s of every atom of water_box(6,6,6) = 41,472 atoms at full
    WATER_DP width, with the main path's neighbor search and escalation, and
    the tabulated params (one Chebyshev table per neighbor type)."""
    from repro_torch.core import descriptor, dp_model
    from repro_torch.md import lattice, neighbors, stepper

    params = dp_model.tabulate_model(dp_model.init_dp_params(
        torch.Generator().manual_seed(SEED), cfg, device=dev), cfg, "cheb")
    pos, typ, box = lattice.water_box(*[WATER_NX] * 3, seed=SEED)
    pos_t = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    typ_t = torch.as_tensor(typ, dtype=torch.int64, device=dev)
    nspec = neighbors.NeighborSpec(rcut_nbr=cfg.rcut + 2.0, sel=cfg.sel)
    bld = stepper.build_neighbors_escalating(cfg, nspec, box, pos_t, typ_t)
    with torch.no_grad():
        rij, nmask = dp_model.gather_rij(pos_t, bld.nlist,
                                         stepper.pack_box(box, dev))
        env, s = descriptor.env_matrix(rij, nmask, cfg.rcut_smth, cfg.rcut)
        env, s = descriptor.normalize_env(env, s, typ_t, params["dstd"])
    return env, s, bld.cfg_run, params


def phase_kernels(cfg, wcfg, params, dev):
    lo, hi = cfg.table_lower, cfg.table_upper
    c = params["table"]["nets"]["0"]["coeffs"]
    env_all, s_all, n_esc = copper_rows(cfg, params, dev)
    n_all = s_all.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    main = None
    # the sample at N=512 and at the escalated N, then every row of the box
    # at the escalated N: the shape the main path gives the kernels
    for a, n in sorted({(SAMPLE_ATOMS, min(512, n_esc)),
                        (SAMPLE_ATOMS, n_esc), (n_all, n_esc)}):
        out = kernel_case("copper", s_all[:a, :n].contiguous(),
                          env_all[:a, :n].contiguous(), c, lo, hi, dev, gen,
                          sample=a == SAMPLE_ATOMS,
                          chunked_lib=a == n_all)
        if a == n_all:
            main = out
        torch.cuda.empty_cache()
    del env_all, s_all
    torch.cuda.empty_cache()

    # water's two neighbor sections after escalation: strided views of the
    # (A, sel_O + sel_H) rows, made dense as the wrapper makes them
    env_w, s_w, cfg_w, params_w = water_rows(wcfg, dev)
    for t, (a0, a1) in enumerate(cfg_w.sel_sections()):
        kernel_case(f"water section {cfg_w.type_map[t]}",
                    s_w[:, a0:a1].contiguous(),
                    env_w[:, a0:a1].contiguous(),
                    params_w["table"]["nets"][str(t)]["coeffs"],
                    cfg_w.table_lower, cfg_w.table_upper, dev, gen,
                    sample=False, chunked_lib=True)
    del env_w, s_w
    torch.cuda.empty_cache()
    force_cases(cfg, wcfg, dev)
    attention_case(dev)
    torch.cuda.empty_cache()
    return main


def force_case(label, cfg, pos, typ, box, dev, gen):
    """The force-and-virial reduction at a cell's shape: the main path's
    neighbour list of this box (escalated), random dE/dr_ij on its live
    slots, the kernel against the plain version (mask, index_add_, row sum,
    einsum) and timed against its byte bound, beside the plain version and
    the ``index_add_`` call alone, the one PyTorch call of the composition
    (PERF.md's ``library_ms``)."""
    from repro_torch.analysis.roofline import HW_H100
    from repro_torch.core import dp_model
    from repro_torch.kernels.dp_fused import force
    from repro_torch.md import neighbors, stepper

    pos_t = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    typ_t = torch.as_tensor(typ, dtype=torch.int64, device=dev)
    nspec = neighbors.NeighborSpec(rcut_nbr=cfg.rcut + 2.0, sel=cfg.sel)
    nlist = stepper.build_neighbors_escalating(cfg, nspec, box, pos_t,
                                               typ_t).nlist
    with torch.no_grad():
        rij, nmask = dp_model.gather_rij(pos_t, nlist,
                                         stepper.pack_box(box, dev))
    de = torch.randn(rij.shape, generator=gen, device=dev) * nmask[..., None]
    a, n = nlist.shape
    live = int(nmask.sum())
    f, w = force.prod_force_virial(de, rij, nlist, a)
    f_r, w_r = force.prod_force_virial_ref(de, rij, nlist, a)
    log(f"[2] force reduction, {label}: A={a} S={n}, live slots {live} "
        f"({live / (a * n):.1%})")
    check_close("forces", f, f_r, 1e-4, 1e-5)
    check_close("virial", w, w_r, 1e-4, 1e-5)
    j = nlist.clamp(min=0).reshape(-1)
    neg = -de.reshape(-1, 3)
    ms = time_ms(lambda: force.prod_force_virial(de, rij, nlist, a), 20)
    plain_ms = time_ms(lambda: force.prod_force_virial_ref(de, rij, nlist, a),
                       3)
    lib_ms = time_ms(lambda: torch.zeros_like(pos_t).index_add_(0, j, neg), 3)
    # nlist read whole, de and rij on live slots, f written once
    bound = (a * n * 8 + live * 24 + a * 12) / HW_H100.hbm_bw * 1e3
    log(f"  prod_force_virial: kernel {ms:.4f} ms | plain {plain_ms:.4f} ms "
        f"| index_add_ alone {lib_ms:.4f} ms | bound {bound:.4f} ms (bytes)"
        f" | {bound / ms:.1%} of bound")


def force_cases(cfg, wcfg, dev):
    """The force reduction at the benchmark cells' shapes: cu.weak's
    123,008 copper atoms (one 1320-slot section after escalation), water's
    155,520 atoms (two sections) and cu.strong's 864 copper atoms."""
    from repro_torch.md import lattice

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    for label, (c, (pos, typ, box)) in {
            "cu.weak": (cfg, lattice.fcc_copper(31, 31, 32)),
            "water": (wcfg, lattice.water_box(9, 9, 10, seed=SEED)),
            "cu.strong": (cfg, lattice.fcc_copper(6, 6, 6))}.items():
        pos = np.mod(pos + rng.normal(0.0, 0.05, pos.shape), box)
        force_case(label, c, pos, typ, box, dev, gen)
        torch.cuda.empty_cache()


def attention_inputs(a, s, d, dev, gen):
    """q, k, v, ww, gate, pad as ``dpa1.attention_layer`` gets them, and a
    cotangent of O: each row's first n slots live, n drawn in [0.6 S,
    0.8 S] (dpa1.h2o.1card reads 70.2% live), q, k, v L2-normalised, w in
    (0, 1] and unit vectors on live slots, 0 on padded ones."""
    from repro_torch.core import dpa1

    n = torch.randint(int(0.6 * s), int(0.8 * s) + 1, (a, 1), generator=gen,
                      device=dev)
    live = torch.arange(s, device=dev) < n

    def unit(*shape):
        return torch.nn.functional.normalize(
            torch.randn(shape, generator=gen, device=dev), dim=-1)

    q, k, v = unit(a, s, d) * d ** -0.5, unit(a, s, d), unit(a, s, d)
    w = torch.where(live, 0.05 + 0.95 * torch.rand((a, s), generator=gen,
                                                   device=dev), 0.0)
    r = unit(a, s, 3) * live[..., None]
    ww = w[:, :, None] * w[:, None, :]
    gate = ww * torch.matmul(r, r.transpose(1, 2))
    pad = torch.where(live, -dpa1.SHIFT, dpa1.MASKED - dpa1.SHIFT)[:, None]
    dout = torch.randn((a, s, d), generator=gen, device=dev)
    return (q, k, v, ww, gate, pad), dout, live


def attention_case(dev):
    """DPA-1's gated attention kernels (``kernels/dp_fused/attention.py``)
    at dpa1.h2o.1card's shape, 24,000 atoms x 120 slots x 128 features:
    forward and backward against the plain version (the same algorithm in
    torch ops, float32), each timed against its bound (``attention.
    kernel_cost``: live slots and pairs, outputs whole, at the H100's
    peaks) beside the plain version. No one PyTorch call computes the gated
    softmax, so there is no library time."""
    from repro_torch.analysis.roofline import HW_H100
    from repro_torch.core import dpa1
    from repro_torch.kernels.dp_fused import attention

    a, s, d = 24000, 120, 128
    inputs, dout, live = attention_inputs(
        a, s, d, dev, torch.Generator(device=dev).manual_seed(SEED))
    n = live.sum(dim=1).double()
    pairs, pairs_sq = float(n.sum()), float((n * n).sum())
    log(f"[2] DPA-1 attention: A={a} S={s} D={d}: live slots {pairs:.0f} "
        f"({pairs / (a * s):.1%}), live pairs {pairs_sq:.0f}")
    out, lse = attention.gated_attention_fwd(*inputs, dpa1.SHIFT)
    grads = attention.gated_attention_bwd(*inputs, dpa1.SHIFT, out, lse, dout)
    out_r, lse_r = attention.gated_attention_fwd_ref(*inputs, dpa1.SHIFT)
    grads_r = attention.gated_attention_bwd_ref(*inputs, dpa1.SHIFT, out_r,
                                                lse_r, dout)
    err_f = check_close("O", out, out_r, 1e-4, 2e-5)
    err_b = max(check_close(name, g, w, 1e-4, 2e-5) for name, g, w in zip(
        ("dq", "dk", "dv", "dww", "dgate"), grads, grads_r))
    del out_r, lse_r, grads_r
    t = {"dpa1_attention_fwd": (
             lambda: attention.gated_attention_fwd(*inputs, dpa1.SHIFT),
             lambda: attention.gated_attention_fwd_ref(*inputs, dpa1.SHIFT),
             err_f),
         "dpa1_attention_bwd": (
             lambda: attention.gated_attention_bwd(*inputs, dpa1.SHIFT, out,
                                                   lse, dout),
             lambda: attention.gated_attention_bwd_ref(*inputs, dpa1.SHIFT,
                                                       out, lse, dout),
             err_b)}
    cost = attention.kernel_cost(pairs, pairs_sq, a, s, d)
    for name, (kernel, plain, err) in t.items():
        ms, plain_ms = time_ms(kernel, 10), time_ms(plain, 3)
        nbytes, ops = cost[name]
        t_b, t_f = nbytes / HW_H100.hbm_bw * 1e3, ops / HW_H100.peak_flops * 1e3
        bound = max(t_b, t_f)
        log(f"  {name}: kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
            f"library null | bound {bound:.4f} ms "
            f"({'bytes' if t_b >= t_f else 'operations'}) | "
            f"{bound / ms:.1%} of bound | max_abs_err {err:.3e}")


# ------------------------------------------------------------------ phase 3

def phase_main_path(cfg, params, dev):
    from repro_torch.md import api, lattice

    pos, typ, box = lattice.fcc_copper(*[MAIN_NX] * 3)
    pot = api.make_potential("dp", cfg, impl="cheb_pallas")
    spec = api.SimulationSpec(pot, api.NVE(), steps=99, engine="scan")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = api.Simulation(spec).run(params, pos, typ, box, device=dev)
    total = time.perf_counter() - t0
    launches = read_launches()
    log(f"[3] {res.n_atoms} atoms, {res.steps} steps: "
        f"{res.us_per_step_atom:.6f} us/step/atom (stepping loop "
        f"{res.wall_s:.3f} s; run incl. first build {total:.3f} s)")
    log(f"    final sel {res.sel}, escalations {res.escalations}, host syncs"
        f" {res.host_syncs}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    from repro_torch.kernels.dp_fused import force
    log(f"    launches {launches}, prod_force_virial {force.force_launches}")
    if force.force_launches < 100:
        raise AssertionError(f"prod_force_virial launched "
                             f"{force.force_launches} < 100 times")
    for row in res.thermo:
        log(f"    step {row['step']}: pe {row['pe']:.6f} ke {row['ke']:.6f} "
            f"etot {row['etot']:.6f} T {row['temp']:.3f} K")
    vals = [row[k] for row in res.thermo for k in ("pe", "ke", "etot")]
    if not np.all(np.isfinite(vals)):
        raise AssertionError("non-finite thermo")
    if not (np.all(np.isfinite(res.final_pos))
            and np.all(np.isfinite(res.final_vel))):
        raise AssertionError("non-finite final state")
    etot = [row["etot"] for row in res.thermo]
    drift = (max(etot) - min(etot)) / res.n_atoms
    log(f"    |d etot| per atom {drift:.3e} eV (limit 1e-4)")
    if drift > 1e-4:
        raise AssertionError(f"energy drift {drift:.3e} eV/atom > 1e-4")
    for name, count in launches.items():
        if count < 100:
            raise AssertionError(f"{name} launched {count} < 100 times")
    profile_force_eval(cfg, params, dev, pos, typ, box)
    return launches, res


def profile_force_eval(cfg, params, dev, pos, typ, box):
    """Device time of three force evaluations, split by kernel."""
    from repro_torch.core import dp_model
    from repro_torch.md import neighbors, stepper
    from torch.profiler import ProfilerActivity, profile

    pos_t = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    typ_t = torch.as_tensor(typ, dtype=torch.int64, device=dev)
    box_t = stepper.pack_box(box, dev)
    nspec = neighbors.NeighborSpec(rcut_nbr=cfg.rcut + 2.0, sel=cfg.sel)
    bld = stepper.build_neighbors_escalating(cfg, nspec, box, pos_t, typ_t)
    cfg_run, nlist = bld.cfg_run, bld.nlist

    def evaluate():
        return dp_model.dp_energy_forces(params, cfg_run, pos_t, nlist, typ_t,
                                         box_t, impl="cheb_pallas",
                                         nsel_norm=cfg.nsel)

    evaluate()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            evaluate()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3 * 1e3
    log(f"    profile: one force evaluation {wall:.3f} ms wall")
    log_kernels(prof, 3, "one force evaluation")


# ------------------------------------------------------------------ phase 4

def phase_rungs(cfg, params, dev):
    from repro_torch.core import dp_model
    from repro_torch.md import lattice, neighbors, stepper

    pos, typ, box = lattice.fcc_copper(*[SMALL_NX] * 3)
    rng = np.random.default_rng(SEED + 1)
    pos = np.mod(pos + rng.normal(0.0, 0.05, pos.shape), box)
    pos_t = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    typ_t = torch.as_tensor(typ, dtype=torch.int64, device=dev)
    box_t = stepper.pack_box(box, dev)
    nspec = neighbors.NeighborSpec(rcut_nbr=cfg.rcut + 2.0, sel=cfg.sel)
    bld = stepper.build_neighbors_escalating(cfg, nspec, box, pos_t, typ_t)
    def evaluate(impl):
        return dp_model.dp_energy_forces(params, bld.cfg_run, pos_t, bld.nlist,
                                         typ_t, box_t, impl=impl,
                                         nsel_norm=cfg.nsel)

    out = {impl: evaluate(impl) for impl in ("cheb_pallas", "cheb")}
    wall = {"cheb_pallas": [], "cheb": []}
    for impl in ("cheb_pallas", "cheb", "cheb", "cheb_pallas"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate(impl)
        torch.cuda.synchronize()
        wall[impl].append((time.perf_counter() - t0) * 1e3)
    (e_k, f_k, w_k), (e_c, f_c, w_c) = out["cheb_pallas"], out["cheb"]
    de = abs(float(e_k) - float(e_c))
    df = float((f_k - f_c).abs().max())
    dw = float((w_k - w_c).abs().max())
    log(f"[4] fcc_copper(10,10,10) sel {bld.spec.sel}: E {float(e_k):.6f} vs "
        f"{float(e_c):.6f} (|dE| {de:.3e}), max|dF| {df:.3e} eV/A, "
        f"max|dW| {dw:.3e} eV")
    log(f"    one force evaluation: cheb_pallas "
        f"{', '.join(f'{x:.3f}' for x in wall['cheb_pallas'])} ms, cheb "
        f"{', '.join(f'{x:.3f}' for x in wall['cheb'])} ms")
    # the force reduction's neighbour-side sums are atomics (order varies
    # by run); the rungs also differ in f32 summation order: hence the
    # tolerances
    if not (torch.isfinite(f_k).all() and f_k.shape == pos_t.shape):
        raise AssertionError("bad forces from cheb_pallas")
    if de > 1e-5 * abs(float(e_c)) or df > 5e-5:
        raise AssertionError("cheb_pallas disagrees with cheb")


# ------------------------------------------------------- phases 5-9 helpers

def reset_launches():
    from repro_torch.kernels.dp_fused import force, ops
    ops.fwd_launches = 0
    ops.bwd_launches = 0
    force.force_launches = 0


def read_launches():
    from repro_torch.kernels.dp_fused import ops
    return {"dp_fused_fwd": ops.fwd_launches,
            "dp_fused_bwd": ops.bwd_launches}


def check_thermo_finite(res, what):
    vals = [row[k] for row in res.thermo for k in ("pe", "ke", "etot")]
    if not (np.all(np.isfinite(vals)) and np.all(np.isfinite(res.final_pos))
            and np.all(np.isfinite(res.final_vel))):
        raise AssertionError(f"{what}: non-finite thermo or final state")


def log_run(tag, res):
    log(f"{tag} {res.n_atoms} atoms, {res.steps} steps, engine "
        f"{res.engine}: {res.us_per_step_atom:.6f} us/step/atom (stepping "
        f"loop {res.wall_s:.3f} s, of it warm-up + capture "
        f"{res.capture_s:.3f} s); final sel {res.sel}, escalations "
        f"{res.escalations}, host syncs {res.host_syncs}, graph captures "
        f"{res.graph_captures}, replays {res.graph_replays}")
    for row in res.thermo:
        log(f"    step {row['step']}: pe {row['pe']:.6f} ke {row['ke']:.6f} "
            f"etot {row['etot']:.6f} T {row['temp']:.3f} K "
            f"P {row['press_gpa']:+.4f} GPa V {row['vol']:.3f}")


def min_image(d, box):
    return d - box * np.round(d / box)


# ------------------------------------------------------------------ phase 5

def phase_outer(cfg, params, dev, scan):
    """The main path again through engine="outer": each segment (rebuild +
    steps) captured once as a CUDA graph and replayed. Held against phase
    3's scan run from the same seed: the runs differ only by the order of
    the force reduction's atomics, so the slice's tolerances apply (thermo rtol
    1e-5, positions 1e-4 A by minimum image, velocities 1e-5 A/fs)."""
    from repro_torch.md import api, lattice

    pos, typ, box = lattice.fcc_copper(*[MAIN_NX] * 3)
    pot = api.make_potential("dp", cfg, impl="cheb_pallas")
    spec = api.SimulationSpec(pot, api.NVE(), steps=99, engine="outer")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = api.Simulation(spec).run(params, pos, typ, box, device=dev)
    launches = read_launches()
    log_run("[5] outer:", res)
    log(f"    scan (phase 3) {scan.us_per_step_atom:.6f} us/step/atom, "
        f"outer {res.us_per_step_atom:.6f} (replays only "
        f"{(res.wall_s - res.capture_s) * 1e6 / (99 * res.n_atoms):.6f}); "
        f"host syncs outer {res.host_syncs} vs scan {scan.host_syncs}; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"    launches {launches} (1 initial force evaluation, 1 per "
        f"warm-up step of each of {res.graph_captures} captures, and those "
        f"recorded in a graph times its replays)")
    check_thermo_finite(res, "outer")
    for name, count in launches.items():
        if count < 100:
            raise AssertionError(f"{name} launched {count} < 100 times")
    etot = [row["etot"] for row in res.thermo]
    drift = (max(etot) - min(etot)) / res.n_atoms
    log(f"    |d etot| per atom {drift:.3e} eV (limit 1e-4)")
    if drift > 1e-4:
        raise AssertionError(f"energy drift {drift:.3e} eV/atom > 1e-4")
    worst = 0.0
    for a, b in zip(res.thermo, scan.thermo):
        for k in ("pe", "ke", "etot"):
            worst = max(worst, abs(a[k] - b[k]) / max(abs(b[k]), 1e-30))
    dpos = float(np.abs(min_image(res.final_pos - scan.final_pos,
                                  res.final_box)).max())
    dvel = float(np.abs(res.final_vel - scan.final_vel).max())
    log(f"    against scan: thermo max rel diff {worst:.3e} (rtol 1e-5), "
        f"positions {dpos:.3e} A (1e-4), velocities {dvel:.3e} A/fs (1e-5)")
    if [r["step"] for r in res.thermo] != [r["step"] for r in scan.thermo] \
            or worst > 1e-5 or dpos > 1e-4 or dvel > 1e-5:
        raise AssertionError("outer engine disagrees with the scan engine")
    profile_segment(cfg, params, dev, res)
    return launches


def profile_segment(cfg, params, dev, res):
    """One whole segment (rebuild + 50 steps) replayed under the profiler,
    and the rebuild alone captured and replayed: its share of a segment."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.md import api, lattice, neighbors, stepper

    typ = torch.zeros(res.n_atoms, dtype=torch.int64, device=dev)
    pos = torch.as_tensor(res.final_pos, device=dev)
    vel = torch.as_tensor(res.final_vel, device=dev)
    box = torch.as_tensor(res.final_box, device=dev)
    masses = torch.full((res.n_atoms,), lattice.MASS["Cu"], device=dev)
    bld = stepper.build_neighbors_escalating(
        cfg, neighbors.NeighborSpec(rcut_nbr=cfg.rcut + 2.0, sel=cfg.sel),
        res.final_box, pos, typ)
    spec = bld.spec
    key = stepper.grid_key_for(spec, res.final_box)
    pot = api.make_potential("dp", cfg, impl="cheb_pallas").with_layout(
        spec.sel)
    nbr_fn = stepper._dyn_cell_list_fn(spec, key)
    _, f, _ = pot.energy_forces(params, pos, typ, bld.nlist, box=box)
    carry = stepper.OuterCarry(pos, vel, f, torch.zeros(
        (), dtype=torch.int32, device=dev), (), box, ())
    eng = stepper.md_outer_engine(pot, api.NVE(), spec, key)
    aux = (params, typ, masses, 1.0)
    eng.run(carry, 1, 50, *aux)                  # capture
    seg_ms = time_ms(lambda: eng.run(carry, 1, 50, *aux), 3)

    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        nbr_fn(pos, typ, box)
    torch.cuda.current_stream().wait_stream(side)
    with torch.no_grad(), torch.cuda.graph(graph):
        nbr_fn(pos, typ, box)
    reb_ms = time_ms(graph.replay, 10)
    log(f"    segment (rebuild + 50 steps, one graph replay) {seg_ms:.3f} ms;"
        f" rebuild alone (captured) {reb_ms:.3f} ms = {reb_ms / seg_ms:.2%}"
        f" of a segment")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(carry, 1, 50, *aux)
        torch.cuda.synchronize()
    log_kernels(prof, 1, "segment replay")


def dev_us(e):
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0))


def log_kernels(prof, per, what, top=12):
    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and dev_us(e) > 0), key=lambda e: -dev_us(e))
    if not rows:
        log(f"    profile of {what}: the profiler recorded no device time")
        return
    total = sum(dev_us(e) for e in rows) / per / 1e3
    log(f"    profile of {what}: {total:.3f} ms of kernel time")
    # the twelve largest, and the dp_fused kernels wherever they rank
    fused = [e for e in rows[top:] if "fwd_kernel" in e.key
             or "bwd_kernel" in e.key]
    for e in rows[:top] + fused:
        log(f"      {dev_us(e) / per / 1e3:8.3f} ms  {e.count // per:5d}x  "
            f"{e.key[:90]}")


# ------------------------------------------------------------------ phase 6

def phase_water(cfg, dev):
    """MD on water at full WATER_DP width: two neighbor sections, so each
    force evaluation launches each kernel twice. Langevin at 330 K through
    the outer engine."""
    from repro_torch.core import dp_model
    from repro_torch.md import api, lattice

    pos, typ, box = lattice.water_box(*[WATER_NX] * 3, seed=SEED)
    pot = api.make_potential("dp", cfg, impl="cheb_pallas")
    params = dp_model.tabulate_model(dp_model.init_dp_params(
        torch.Generator().manual_seed(SEED), cfg, device=dev), cfg, "cheb")
    ens = api.NVTLangevin(temp_k=330.0, friction=0.1, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = api.Simulation(api.SimulationSpec(pot, ens, steps=99,
                                            engine="outer")).run(
        params, pos, typ, box, device=dev)
    launches = read_launches()
    log_run("[6] water:", res)
    log(f"    launches {launches}; final sel {res.sel}; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check_thermo_finite(res, "water")
    for name, count in launches.items():
        if count < 200:     # both sections in each of >= 100 evaluations
            raise AssertionError(f"{name} launched {count} < 200 times")
    temp = res.thermo[-1]["temp"]
    if not abs(temp / 330.0 - 1.0) < 0.25:
        raise AssertionError(f"water temperature {temp:.1f} K is not near "
                             f"330 K")
    return launches


# ------------------------------------------------------------------ phase 7

def phase_quintic(cfg, params, dev):
    """The quintic rung (per-Horner-step gathers) against mlp and
    cheb_pallas at full COPPER_DP width, with each rung's peak memory."""
    from repro_torch.core import dp_model
    from repro_torch.md import lattice, neighbors, stepper

    pos, typ, box = lattice.fcc_copper(*[SMALL_NX] * 3)
    rng = np.random.default_rng(SEED + 1)
    pos = np.mod(pos + rng.normal(0.0, 0.05, pos.shape), box)
    pos_t = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    typ_t = torch.as_tensor(typ, dtype=torch.int64, device=dev)
    box_t = stepper.pack_box(box, dev)
    nspec = neighbors.NeighborSpec(rcut_nbr=cfg.rcut + 2.0, sel=cfg.sel)
    bld = stepper.build_neighbors_escalating(cfg, nspec, box, pos_t, typ_t)
    t0 = time.perf_counter()
    p_q = dp_model.tabulate_model(params, cfg, "quintic")
    torch.cuda.synchronize()
    log(f"[7] quintic table built in {time.perf_counter() - t0:.3f} s "
        f"({tuple(p_q['table']['nets']['0']['coeffs'].shape)}); "
        f"fcc_copper(10,10,10) = {len(pos)} atoms, box "
        f"{np.round(box, 3).tolist()} A, sel {bld.spec.sel}")
    out = {}
    for impl, p in (("mlp", params), ("quintic", p_q),
                    ("cheb_pallas", params)):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[impl] = dp_model.dp_energy_forces(p, bld.cfg_run, pos_t,
                                              bld.nlist, typ_t, box_t,
                                              impl=impl, nsel_norm=cfg.nsel)
        torch.cuda.synchronize()
        log(f"    {impl}: E {float(out[impl][0]):.6f} eV, "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms, "
            f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    e_q, f_q, w_q = out["quintic"]
    for ref_impl in ("mlp", "cheb_pallas"):
        e_r, f_r, w_r = out[ref_impl]
        de = abs(float(e_q) - float(e_r)) / abs(float(e_r))
        df = float((f_q - f_r).abs().max())
        dw = float((w_q - w_r).abs().max())
        fmax = max(1.0, float(f_r.abs().max()))
        log(f"    quintic vs {ref_impl}: |dE|/|E| {de:.3e} (1e-4), max|dF| "
            f"{df:.3e} eV/A (5e-5 x {fmax:.2f}), max|dW| {dw:.3e} eV")
        # the tables approximate the net (the ladder's tolerances of the
        # reference's tests), the force reduction sums with atomics
        if not (torch.isfinite(f_q).all() and de <= 1e-4
                and df <= 5e-5 * fmax):
            raise AssertionError(f"quintic disagrees with {ref_impl}")


# ------------------------------------------------------------------ phase 8

def phase_npt(cfg, params, dev):
    """Copper at full width under npt_scr (Langevin + stochastic cell
    rescale) through the outer engine: the box moves inside the graphs."""
    from repro_torch.md import api, lattice

    pos, typ, box = lattice.fcc_copper(*[SMALL_NX] * 3)
    pot = api.make_potential("dp", cfg, impl="cheb_pallas")
    spec = api.SimulationSpec(pot, ensemble="npt_scr", pressure_gpa=0.0,
                              steps=99, engine="outer")
    reset_launches()
    res = api.Simulation(spec).run(params, pos, typ, box, device=dev)
    log_run("[8] npt_scr:", res)
    log(f"    box {np.round(box, 4).tolist()} -> "
        f"{np.round(res.final_box, 4).tolist()} A; launches "
        f"{read_launches()}; grid rebuilds {res.grid_rebuilds}")
    check_thermo_finite(res, "npt")
    if np.allclose(res.final_box, box, rtol=0, atol=1e-6) or \
            not np.all(np.isfinite(res.final_box)):
        raise AssertionError("the box did not move under npt_scr")
    if not np.all(np.isfinite(res.press_gpa_trace())):
        raise AssertionError("non-finite pressure")


# ------------------------------------------------------------------ phase 9

def phase_lj(dev):
    """Copper LJ, scan against outer: the force evaluation is cheap, so the
    engine's own overhead shows where the card's work per step is small.
    At fcc_copper(20,20,20) and at fcc_copper(10,10,10)."""
    from repro_torch.md import api, lattice

    for nx in (MAIN_NX, SMALL_NX):
        pos, typ, box = lattice.fcc_copper(*[nx] * 3)
        res = {}
        for engine in ("scan", "outer"):
            spec = api.SimulationSpec(api.LJPotential(), api.NVE(), steps=99,
                                      engine=engine)
            res[engine] = api.Simulation(spec).run({}, pos, typ, box,
                                                   device=dev)
            log_run(f"[9] lj {engine}:", res[engine])
            check_thermo_finite(res[engine], f"lj {engine}")
        o = res["outer"]
        log(f"    LJ {len(pos)} atoms, us/step/atom: scan "
            f"{res['scan'].us_per_step_atom:.6f}, outer "
            f"{o.us_per_step_atom:.6f} (replays only "
            f"{(o.wall_s - o.capture_s) * 1e6 / (99 * o.n_atoms):.6f})")
        profile_lj_force_eval(dev, pos, typ, box, o.sel)


def profile_lj_force_eval(dev, pos, typ, box, sel):
    """Wall and kernel time of three LJ force evaluations at the run's
    final sel: what a step costs the card when the force is cheap."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.md import api, neighbors, stepper

    lj = api.LJPotential().with_layout(sel)
    pos_t = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    typ_t = torch.as_tensor(typ, dtype=torch.int64, device=dev)
    box_t = stepper.pack_box(box, dev)
    bld = stepper.build_neighbors_escalating(
        lj.layout_cfg(), neighbors.NeighborSpec(rcut_nbr=lj.rcut + 2.0,
                                                sel=sel), box, pos_t, typ_t)
    lj.energy_forces({}, pos_t, typ_t, bld.nlist, box=box_t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            lj.energy_forces({}, pos_t, typ_t, bld.nlist, box=box_t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3 * 1e3
    log(f"    LJ force evaluation (sel {bld.spec.sel}): {wall:.3f} ms wall")
    log_kernels(prof, 3, "one LJ force evaluation", top=6)


# ----------------------------------------------------------------- phase 10

# (topology, model shards, atom / halo capacity): fcc_copper(20,20,20) in 8
# bricks of 4,000 atoms (36.15 A wide), then in 4 slabs of 8,000 atoms split
# over 2 model shards. The capacities hold the lattice's boundary layers at
# rcut_halo = 10 A with a margin for 99 steps of motion; DomainSpec derives
# the cell capacity from them; an overflow flag fails the phase.
DIST_CASES = {
    "a": dict(topology=(2, 2, 2), n_model=1, cap=4400, halo=3400),
    "b": dict(topology=(4,), n_model=2, cap=8800, halo=5600),
}


def brick_rows(pos, spec):
    """Each brick's atoms (indices into ``pos``) in the order
    ``partition_atoms`` puts them into its slots."""
    topo = spec.topo
    rank = np.zeros(len(pos), np.int64)
    for a in topo.axes:
        w = spec.box[a] / topo.shape[a]
        rank += np.clip((pos[:, a] / w).astype(np.int64), 0,
                        topo.shape[a] - 1) * topo.strides[a]
    return [np.nonzero(rank == s)[0] for s in range(spec.n_slabs)]


class RecordRankFwd:
    """Wraps ``ops.fused_fwd`` while a run goes through it and keeps, for
    each of the named ranks, its first call's inputs (that rank's s/env at
    the path's shape). ``LocalComm`` runs rank r = spatial x n_model + model
    on a thread named ``rank{r}``, so the same ranks' inputs are kept in
    every run, whichever thread reaches the kernel first."""

    def __init__(self, ranks):
        import threading

        from repro_torch.kernels.dp_fused import ops
        self.ops, self.orig, self.args = ops, ops.fused_fwd, {}
        self.names = {f"rank{r}": r for r in ranks}
        self.current = threading.current_thread

    def __enter__(self):
        def wrapped(s, env, coeffs, counts, lower, upper):
            r = self.names.get(self.current().name)
            if r is not None and r not in self.args:
                self.args[r] = (s.clone(), env.clone(), coeffs, lower, upper)
            return self.orig(s, env, coeffs, counts, lower, upper)
        self.ops.fused_fwd = wrapped
        return self

    def __exit__(self, *exc):
        self.ops.fused_fwd = self.orig


def dist_setup(cfg, case, box, dev):
    from repro_torch.md import api, comm, domain

    c = DIST_CASES[case]
    spec = domain.DomainSpec.for_topology(
        tuple(box), c["topology"], c["cap"], c["halo"], cfg.rcut + 2.0)
    spec.validate()
    lc = comm.LocalComm(spec.n_slabs, c["n_model"], device=dev)
    pot = api.make_potential("dp", cfg, impl="cheb_pallas")
    return spec, lc, pot


def dist_one_step(cfg, params, dev, case, pos_j, typ, box, ref):
    """One distributed step from rest (dt 1e-3 fs) at the jittered
    positions: PE, carried forces and virial against the single-process
    port at the same positions, at the reference harness's tolerances
    (run_md_dist.py:66,79,89; forces 1e-5 max(1, max|F|) on the card).
    Returns the first kernel call's inputs of every model shard of brick 0
    (ranks 0..n_model-1), by model index, and the launch counts."""
    from repro_torch.md import domain, lattice

    e_ref, f_ref, w_ref = ref
    spec, lc, pot = dist_setup(cfg, case, box, dev)
    state, ovf = domain.partition_atoms(pos_j, np.zeros_like(pos_j), typ, spec)
    if ovf > 0:
        raise AssertionError(f"({case}) brick capacity overflow {ovf}")
    step = domain.make_distributed_md_step(
        cfg, spec, lc, (lattice.MASS["Cu"],), 1e-3, decomp="slots",
        neighbor="cells", potential=pot)
    boxt = torch.as_tensor(np.asarray(box, np.float32), device=dev)
    st = domain.shard_state(state, lc, dev)
    torch.cuda.synchronize()
    reset_launches()
    with RecordRankFwd(range(lc.n_model)) as rec:
        t0 = time.perf_counter()
        (new, _, _, _), th = step(params, st, (), boxt, ())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    flags = {k: int(th[k]) for k in ("halo_overflow", "nbr_overflow",
                                     "geom_overflow")}
    n_ranks = spec.n_slabs * lc.n_model
    log(f"[10{case}] topology {spec.topo.label()} x {lc.n_model} model "
        f"shards (slots, cells), LocalComm {n_ranks} ranks on the card: one "
        f"step {ms:.3f} ms, launches {launches}, flags {flags}, atoms "
        f"{int(th['n_atoms'])}, cell capacity {spec.cell_capacity}")
    if any(v > 0 for v in flags.values()) or int(th["n_atoms"]) != len(pos_j):
        raise AssertionError(f"({case}) overflow or atoms lost: {flags}")
    for name, count in launches.items():
        if count != n_ranks:
            raise AssertionError(f"({case}) {name} launched {count} times, "
                                 f"not once per rank ({n_ranks})")
    de = abs(float(th["pe"]) - e_ref)
    f_tol = 1e-5 * max(1.0, float(f_ref.abs().max()))
    df = 0.0
    for s, rows in enumerate(brick_rows(pos_j, spec)):
        idx = torch.as_tensor(rows, device=dev)
        df = max(df, float((new.force[s, :len(rows)] - f_ref[idx])
                           .abs().max()))
    w = th["stress"] * float(np.prod(box))
    dw = float((w - w_ref).abs().max()) / max(1.0, float(w_ref.abs().max()))
    log(f"    against single process: |dPE| {de:.3e} eV (limit "
        f"{1e-4 + 1e-5 * abs(e_ref):.3e}), max|dF| {df:.3e} eV/A (limit "
        f"{f_tol:.3e}), virial rel {dw:.3e} (limit 2e-3)")
    if not (de < 1e-4 + 1e-5 * abs(e_ref) and df < f_tol and dw < 2e-3):
        raise AssertionError(f"({case}) distributed step disagrees with the "
                             f"single-process port")
    if sorted(rec.args) != list(range(lc.n_model)):
        raise AssertionError(f"({case}) brick 0's model shards did not all "
                             f"reach the forward kernel: {sorted(rec.args)}")
    return rec.args, launches


# CUDA runtime calls that put work on the card, as the profiler names them
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")


def device_busy(prof):
    """(us in which at least one kernel, copy or fill ran on the card, us
    from the first one's start to the last one's end): the union of the
    device rows' intervals, the ranges' device-side rows left out."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and not e.name.startswith("domain."))
    if not spans:
        return 0.0, 0.0
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo = a
        hi = max(hi, b)
    return busy + hi - lo, max(e for _, e in spans) - spans[0][0]


def host_launches(prof):
    return sum(e.count for e in prof.key_averages() if e.key in HOST_LAUNCHES)


def sweep_share(step, params, st, boxt, profile_here=True):
    """Device time under the halo/reverse/migration ranges over all device
    time of two steps, from torch.profiler (all threads); the card's busy
    share of the wall and the host's launch calls a step. Returns the busy
    share and the launch calls a step. Under ``DistComm`` every process
    runs the two steps (they exchange atoms) and rank 0 alone profiles
    them (``profile_here``)."""
    from torch.profiler import ProfilerActivity, profile

    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        cfg = None
    if cfg is None or not profile_here:
        if profile_here:
            log("    sweep share: this torch cannot profile worker threads; "
                "not measured")
        step.run(params, st, 2, (), boxt)
        torch.cuda.synchronize()
        return None, None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=cfg) as prof:
        t0 = time.perf_counter()
        step.run(params, st, 2, (), boxt)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 2 * 1e3
    # the kernels' device rows, without the ranges' device-side rows (those
    # are spans, waits on other ranks included); a range's own device time
    # is that of the kernels its host ops launched
    rows = prof.key_averages()
    on_card = [str(getattr(e, "device_type", "")).endswith("CUDA")
               for e in rows]
    total = sum(dev_us(e) for e, c in zip(rows, on_card)
                if c and not e.key.startswith("domain.")) / 2e3
    ranges = {e.key: (getattr(e, "device_time_total", 0)
                      or getattr(e, "cuda_time_total", 0)) / 2e3
              for e, c in zip(rows, on_card)
              if not c and e.key.startswith("domain.")}
    busy = device_busy(prof)[0] / 2e3 / wall
    calls = host_launches(prof) / 2
    log(f"    eager, profile of 2 steps: {wall:.3f} ms wall a step; the card "
        f"busy {busy:.2%} of it; host launch calls a step {calls:.0f}")
    if not total or not ranges:
        log("    sweep share: the profiler recorded no device time under the "
            "ranges; not measured")
        return busy, calls
    share = sum(ranges.values()) / total
    log(f"    {total:.3f} ms of kernel time a step over all ranks "
        f"({total / wall:.1%} of the wall); under ranges: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in sorted(ranges.items()))
        + f"; sweep share of the kernel time {share:.2%}")
    log_kernels(prof, 2, "two distributed steps", top=8)
    return busy, calls


def dist_kernel_case(label, args, dev):
    s, env, c, lo, hi = args
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return kernel_case(label, s, env, c, lo, hi, dev, gen, sample=True,
                       chunked_lib=False)


def graph_pool_bytes(prog):
    """Bytes of the card's memory held by the graphs' pool (one pool for
    the program's graphs), from the allocator's snapshot."""
    pools = {tuple(g.graph.pool()) for g in prog._graphs.values()}
    segs = torch.cuda.memory_snapshot()
    if not pools or not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(x["total_size"] for x in segs
               if tuple(x["segment_pool_id"]) in pools)


def dist_protocol(prog, params, st0, box_t, steps=99):
    """The copper protocol through ``prog`` (an OuterMDProgram): prime,
    then the chunks of 50-step segments, one thermo fetch and flag check a
    chunk. Thermo per step, the final bricks, times, launches, peak."""
    from repro_torch.md import domain, stepper

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    st = prog.prime(params, st0, box_t)
    torch.cuda.synchronize()
    t_prime = time.perf_counter() - t0
    rows = {"pe": [], "ke": [], "n_atoms": []}
    t0 = time.perf_counter()
    for n_segs, seg_len in stepper.chunk_schedule(steps, 50, 8):
        st, _, _, _, th = prog.run(st, params, n_segs, seg_len, (), box_t)
        thermo = stepper.fetch_thermo(th)
        domain.check_segment_thermo(thermo)
        for k, v in rows.items():
            v.append(thermo[k].reshape(-1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {k: np.concatenate(v).astype(np.float64) for k, v in rows.items()}
    out.update(etot=out["pe"] + out["ke"], wall=wall, t_prime=t_prime,
               launches=read_launches(),
               peak=torch.cuda.max_memory_allocated(),
               state=domain.SlabState(*(x.clone() for x in st)))
    return out


def dist_log_run(tag, run, n, steps):
    log(f"{tag} {run['wall'] * 1e6 / (steps * n):.6f} us/step/atom (loop "
        f"{run['wall']:.3f} s; initial force evaluation "
        f"{run['t_prime']:.3f} s); launches {run['launches']}; "
        f"max_memory_allocated {run['peak'] / 2**30:.3f} GiB")


def dist_against(got, want, box, what):
    """Thermo rows (rtol) and final bricks (positions by minimum image,
    velocities) of two runs of the same protocol; the same slots hold the
    same atoms when migration decided alike."""
    worst = max(float(np.max(np.abs(got[k] - want[k])
                             / np.maximum(np.abs(want[k]), 1e-30)))
                for k in ("pe", "ke", "etot"))
    a, b = got["state"], want["state"]
    same = bool(torch.equal(a.mask, b.mask) and torch.equal(a.typ, b.typ))
    boxt = torch.as_tensor(np.asarray(box, np.float32), device=a.pos.device)
    d = a.pos - b.pos
    dpos = float((d - boxt * torch.round(d / boxt)).abs().max())
    dvel = float((a.vel - b.vel).abs().max())
    log(f"    against {what}: thermo max rel diff {worst:.3e}; same slots "
        f"{same}; positions {dpos:.3e} A, velocities {dvel:.3e} A/fs")
    return worst, same, dpos, dvel


def dist_against_scan(run, scan, n):
    """Atoms constant, drift <= 1e-4 eV/atom and the thermo rows within
    rtol 1e-5 of phase 3's scan run."""
    worst = 0.0
    for row in scan.thermo:
        i = row["step"] - 1
        for k in ("pe", "ke", "etot"):
            worst = max(worst, abs(run[k][i] - row[k])
                        / max(abs(row[k]), 1e-30))
    drift = float(run["etot"].max() - run["etot"].min()) / n
    log(f"    atoms per step {int(run['n_atoms'].min())}.."
        f"{int(run['n_atoms'].max())}; |d etot| per atom {drift:.3e} eV "
        f"(limit 1e-4); against phase 3's scan run: thermo max rel diff "
        f"{worst:.3e} (rtol 1e-5)")
    return bool(np.all(run["n_atoms"] == n) and drift <= 1e-4
                and worst <= 1e-5)


def profile_dist_replay(prog, params, st, box_t, seg_len, profile_here=True):
    """A segment of ``seg_len`` steps captured, replayed, then replayed
    under the profiler: wall, the card's busy share of it, the host's
    launch calls, the kernel rows. (Short: with a 50-step replay, ~125,000
    kernels, the profiler's own processing took most of 30 s.) Returns the
    busy share and the launch calls. Under ``DistComm`` every process
    captures and replays, rank 0 alone profiles (``profile_here``)."""
    from torch.profiler import ProfilerActivity, profile

    prog.run(st, params, 1, seg_len, (), box_t)
    torch.cuda.synchronize()
    if not profile_here:
        prog.run(st, params, 1, seg_len, (), box_t)
        torch.cuda.synchronize()
        return None, None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prog.run(st, params, 1, seg_len, (), box_t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    busy, span = device_busy(prof)
    log(f"    captured, profile of one {seg_len}-step segment replay: "
        f"{wall / 1e3:.3f} ms wall ({wall / 1e3 / seg_len:.3f} ms a step); "
        f"the card busy {busy / wall:.2%} of the wall ({busy / span:.2%} "
        f"of its first-to-last span {span / 1e3:.3f} ms); host launch "
        f"calls in the segment {host_launches(prof)}")
    log_kernels(prof, 1, "a replayed segment", top=8)
    return busy / wall, host_launches(prof)


def phase_distributed(cfg, params, dev, scan):
    """Copper at full COPPER_DP width in bricks on the one card (LocalComm:
    one thread and stream per rank), cheb_pallas, NVE. (a) 2x2x2 bricks:
    one step against the single-process port, then the 99-step protocol
    from phase 3's velocities eager (the oracle) and through the captured
    program (each segment length captured once as a CUDA graph, every
    segment one replay), each held against phase 3's thermo rows at rtol
    1e-5 (atoms constant, drift <= 1e-4 eV/atom) and the captured against
    the eager (positions 1e-4 A by minimum image); (b) 4 slabs x 2 model
    shards, the fused kernels on neighbor-slot slices: the same one-step
    parity, then 10 steps eager and captured. Each kernel is held against
    ref.py at each path's shape."""
    from repro_torch.core import dp_model
    from repro_torch.md import domain, integrator, lattice, neighbors, stepper

    t_phase = time.perf_counter()
    pos, typ, box = lattice.fcc_copper(*[MAIN_NX] * 3)
    rng = np.random.default_rng(SEED)
    pos_j = np.mod(pos + rng.normal(0.0, 0.05, pos.shape), box).astype(
        np.float32)
    pos_t = torch.as_tensor(pos_j, device=dev)
    typ_t = torch.as_tensor(typ, dtype=torch.int64, device=dev)
    box_t = stepper.pack_box(box, dev)
    bld = stepper.build_neighbors_escalating(
        cfg, neighbors.NeighborSpec(rcut_nbr=cfg.rcut + 2.0, sel=cfg.sel),
        box, pos_t, typ_t)
    e_ref, f_ref, w_ref = dp_model.dp_energy_forces(
        params, bld.cfg_run, pos_t, bld.nlist, typ_t, box_t,
        impl="cheb_pallas", nsel_norm=cfg.nsel)
    ref = (float(e_ref), f_ref, w_ref)
    del bld
    torch.cuda.empty_cache()
    kernels, launches = {}, {}

    # -- (a) 2x2x2 bricks: one step, then the 99-step protocol -------------
    args_a, _ = dist_one_step(cfg, params, dev, "a", pos_j, typ, box, ref)
    kernels["a"] = dist_kernel_case(
        f"distributed (a), brick 0: A = {DIST_CASES['a']['cap']}",
        args_a[0], dev)
    del args_a
    torch.cuda.empty_cache()
    spec, lc, pot = dist_setup(cfg, "a", box, dev)
    masses = torch.as_tensor(lattice.masses_for(pot.type_map, typ),
                             dtype=torch.float32, device=dev)
    vel = integrator.init_velocities(torch.Generator().manual_seed(SEED),
                                     masses, 330.0)
    state, _ = domain.partition_atoms(pos.astype(np.float32),
                                      vel.cpu().numpy(), typ, spec)
    st0 = domain.shard_state(state, lc, dev)
    n = len(pos)

    def program(spec, lc, capture):
        return domain.make_outer_md_program(
            cfg, spec, lc, (lattice.MASS["Cu"],), 1.0, decomp="slots",
            neighbor="cells", potential=pot, capture=capture)

    prog = program(spec, lc, False)
    eager = dist_protocol(prog, params, st0, box_t)
    launches["distributed_a"] = eager["launches"]
    dist_log_run("[10a] 99 steps eager (2 segments, migration at each "
                 "start):", eager, n, 99)
    for row in scan.thermo:
        i = row["step"] - 1
        log(f"    step {row['step']}: pe {eager['pe'][i]:.6f} ke "
            f"{eager['ke'][i]:.6f} etot {eager['etot'][i]:.6f} (scan: "
            f"{row['pe']:.6f} {row['ke']:.6f} {row['etot']:.6f})")
    if not dist_against_scan(eager, scan, n):
        raise AssertionError("distributed (a) eager protocol failed")
    for name, count in eager["launches"].items():
        if count != 8 * 100:
            raise AssertionError(f"(a) {name} launched {count} times, not "
                                 f"8 ranks x 100 force evaluations")
    sweep_share(prog.step, params, eager["state"], box_t)
    del prog
    torch.cuda.empty_cache()
    log(f"    (a) eager {time.perf_counter() - t_phase:.1f} s")

    t_sub = time.perf_counter()
    prog = program(spec, lc, True)
    graph = dist_protocol(prog, params, st0, box_t)
    launches["distributed_a_graph"] = graph["launches"]
    dist_log_run("[10a] 99 steps captured (each segment one graph replay):",
                 graph, n, 99)
    pool = graph_pool_bytes(prog)
    log(f"    graph captures {prog.captures} (warm-up + capture "
        f"{prog.capture_s:.3f} s), replays {prog.replays}; replays only "
        f"{(graph['wall'] - prog.capture_s) * 1e6 / (99 * n):.6f} "
        f"us/step/atom; graph pool "
        + ("not measured" if pool is None else
           f"{pool / 2**30:.3f} GiB ({pool / eager['peak']:.2f}x the eager "
           f"run's max_memory_allocated {eager['peak'] / 2**30:.3f} GiB)"))
    ok = dist_against_scan(graph, scan, n)
    worst, same, dpos, dvel = dist_against(graph, eager, box, "the eager run")
    want = 8 * (100 + prog.captures)
    log(f"    launches {graph['launches']}: 8 ranks x (1 initial force "
        f"evaluation + 99 replayed steps + 1 warm-up step of each of "
        f"{prog.captures} captures) = {want}")
    if not (ok and worst <= 1e-5 and same and dpos <= 1e-4):
        raise AssertionError("distributed (a) captured protocol failed")
    for name, count in graph["launches"].items():
        if count != want:
            raise AssertionError(f"(a) captured: {name} launched {count} "
                                 f"times, not {want}")
    profile_dist_replay(prog, params, graph["state"], box_t, 5)
    pe_a10 = eager["pe"][9]
    del prog, eager, graph, st0
    torch.cuda.empty_cache()
    log(f"    (a) captured {time.perf_counter() - t_sub:.1f} s")
    t_sub = time.perf_counter()

    # -- (b) 4 slabs x 2 model shards: the kernels on slot slices ----------
    args_b, launches["distributed_b"] = dist_one_step(
        cfg, params, dev, "b", pos_j, typ, box, ref)
    for m in sorted(args_b):
        kernels[f"b{m}"] = dist_kernel_case(
            f"distributed (b), brick 0, model shard {m}'s slot slice: A = "
            f"{DIST_CASES['b']['cap']}", args_b[m], dev)
    del args_b
    torch.cuda.empty_cache()
    spec, lc, pot = dist_setup(cfg, "b", box, dev)
    state, _ = domain.partition_atoms(pos.astype(np.float32),
                                      vel.cpu().numpy(), typ, spec)
    runs = {}
    for capture in (False, True):
        prog = program(spec, lc, capture)
        runs[capture] = dist_protocol(
            prog, params, domain.shard_state(state, lc, dev), box_t, 10)
        dist_log_run(f"[10b] 10 steps {'captured' if capture else 'eager'}:",
                     runs[capture], n, 10)
        if capture:
            launches["distributed_b_graph"] = runs[True]["launches"]
            replays_us = (runs[True]["wall"] - prog.capture_s) * 1e6
            log(f"    graph captures {prog.captures} (warm-up + capture "
                f"{prog.capture_s:.3f} s), replays {prog.replays}; replays "
                f"only {replays_us / (10 * n):.6f} us/step/atom")
        else:
            sweep_share(prog.step, params, runs[False]["state"], box_t)
        del prog
    pe10 = runs[False]["pe"][-1]
    log(f"    pe at step 10: eager {pe10:.6f}, captured "
        f"{runs[True]['pe'][-1]:.6f}, (a) eager {pe_a10:.6f}")
    if abs(pe10 - pe_a10) > 1e-5 * abs(pe_a10):
        raise AssertionError("(b) trajectory disagrees with (a)")
    worst, same, dpos, _ = dist_against(runs[True], runs[False], box,
                                        "the eager run")
    kept = all(np.all(r["n_atoms"] == n) for r in runs.values())
    if not (kept and worst <= 1e-5 and same and dpos <= 1e-5):
        raise AssertionError("(b) captured run disagrees with the eager run")
    log(f"    (b) {time.perf_counter() - t_sub:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return kernels, launches


# (c): DistComm over NCCL, one process and one card a rank, by the cards
# visible. Capacities derived as (a)'s and (b)'s: atoms 1.1 x a brick's
# share, halo ~1.27 x the largest per-side sweep at rcut_halo = 10 A (a
# (2, 2) brick's y sweep packs 3,437 atoms, a 2-slab's 4,426)
DIST_CARD_CASES = {
    4: [dict(label="(2, 2) x 1 model shard, atoms", topology=(2, 2),
             n_model=1, decomp="atoms", cap=8800, halo=4400),
        dict(label="(2,) x 2 model shards, slots", topology=(2,), n_model=2,
             decomp="slots", cap=17600, halo=5600)],
    2: [dict(label="(2,) x 1 model shard, atoms", topology=(2,), n_model=1,
             decomp="atoms", cap=17600, halo=5600)],
}
DIST_CARD_DEADLINE = 600      # s for one case's processes


def dist_card_program(cfg, spec, comm, case, capture):
    from repro_torch.md import api, domain, lattice

    return domain.make_outer_md_program(
        cfg, spec, comm, (lattice.MASS["Cu"],), 1.0, decomp=case["decomp"],
        neighbor="cells", potential=api.make_potential(
            "dp", cfg, impl="cheb_pallas"), capture=capture)


def dist_card_spec(cfg, case, box):
    from repro_torch.md import domain

    spec = domain.DomainSpec.for_topology(
        tuple(float(b) for b in box), case["topology"], case["cap"],
        case["halo"], cfg.rcut + 2.0)
    spec.validate()
    return spec


def dist_card_worker(rank, case, port, out_dir):
    """Phase 10 (c), one NCCL process on card ``rank``: the 99-step
    protocol on this process's rank of ``case`` from the parent's atoms,
    eager (``capture=False``), then captured (each segment length recorded
    once as a CUDA graph of this rank, NCCL calls included); an eager
    2-step profile and a profiled 5-step replay on rank 0 (every process
    runs them); the whole states gathered. Rank 0 saves the thermo rows,
    the states and every process's numbers."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.core.dp_model import init_dp_params, tabulate_model
    from repro_torch.core.types import COPPER_DP as cfg
    from repro_torch.device import resolve_device
    from repro_torch.md import comm, domain, stepper

    torch.cuda.set_device(rank)
    resolve_device("cuda")               # switches TF32 off, as the parent's
    dev = torch.device("cuda", rank)
    world = int(np.prod(case["topology"])) * case["n_model"]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    lead = rank == 0
    try:
        atoms = np.load(Path(out_dir) / "atoms.npz")
        params = tabulate_model(init_dp_params(
            torch.Generator().manual_seed(SEED), cfg, device=dev), cfg,
            "cheb")
        spec = dist_card_spec(cfg, case, atoms["box"])
        dc = comm.DistComm(spec.n_slabs, case["n_model"])
        state, ovf = domain.partition_atoms(atoms["pos"], atoms["vel"],
                                            atoms["typ"], spec)
        if ovf > 0:
            raise AssertionError(f"brick capacity overflow {ovf}")
        st0 = domain.shard_state(state, dc, dev)
        box_t = stepper.pack_box(atoms["box"], dev)
        runs, mine = {}, {}
        for capture in (False, True):
            prog = dist_card_program(cfg, spec, dc, case, capture)
            run = dist_protocol(prog, params, st0, box_t)
            tag = "captured" if capture else "eager"
            mine[tag] = dict(wall=run["wall"], t_prime=run["t_prime"],
                             launches=run["launches"], peak=run["peak"])
            if capture:
                mine[tag].update(captures=prog.captures,
                                 replays=prog.replays,
                                 capture_s=prog.capture_s,
                                 pool=graph_pool_bytes(prog))
                mine["replay"] = profile_dist_replay(
                    prog, params, run["state"], box_t, 5, profile_here=lead)
            else:
                mine["eager_profile"] = sweep_share(
                    prog.step, params, run["state"], box_t, profile_here=lead)
            runs[tag] = {k: run[k] for k in ("pe", "ke", "etot", "n_atoms")}
            runs[tag]["state"] = domain.gather_state(run["state"], dc)
            del prog, run
            gc.collect()
            torch.cuda.empty_cache()
        every = [None] * world
        dist.all_gather_object(every, mine)
        if lead:
            torch.save(dict(runs=runs, every=every),
                       Path(out_dir) / "result.pt")
    finally:
        domain.release_graphs()   # NCCL waits for live graphs otherwise
        dist.destroy_process_group()


def dist_card_case(cfg, params, dev, scan, case, out_dir, atoms):
    """One case of phase 10 (c): its NCCL processes, then their result held
    against itself, LocalComm on card 0 and phase 3. Returns the launches
    of rank 0 (eager, captured) and the failed checks."""
    import socket

    from repro_torch.md import comm, domain

    world = int(np.prod(case["topology"])) * case["n_model"]
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    log(f"[10c] {case['label']}: {world} NCCL processes, one card each, "
        f"{len(atoms['pos'])} atoms, cheb_pallas, the 99-step protocol "
        f"eager, then each segment length captured once per process")
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        dist_card_worker, args=(case, port, out_dir), nprocs=world,
        join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > DIST_CARD_DEADLINE:
                raise AssertionError(f"(c) {case['label']}: the NCCL "
                                     f"processes did not finish in "
                                     f"{DIST_CARD_DEADLINE} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
    res = torch.load(Path(out_dir) / "result.pt", weights_only=False)
    log(f"    processes done in {time.perf_counter() - t0:.1f} s")
    n, failed = len(atoms["pos"]), []
    on_dev = {tag: dict(r, state=domain.SlabState(
        *(None if x is None else x.to(dev) for x in r["state"])))
        for tag, r in res["runs"].items()}
    eager, graph = on_dev["eager"], on_dev["captured"]
    every = res["every"]
    for tag in ("eager", "captured"):
        walls = [e[tag]["wall"] for e in every]
        log(f"    {tag}: {walls[0] * 1e6 / (99 * n):.6f} us/step/atom (rank "
            f"0's loop {walls[0]:.3f} s, slowest {max(walls):.3f} s; "
            f"initial force evaluation {every[0][tag]['t_prime']:.3f} s); "
            f"launches a process "
            f"{[e[tag]['launches']['dp_fused_fwd'] for e in every]} fwd, "
            f"{[e[tag]['launches']['dp_fused_bwd'] for e in every]} bwd; "
            f"max_memory_allocated rank 0 "
            f"{every[0][tag]['peak'] / 2**30:.3f} GiB")
    g0 = every[0]["captured"]
    caps = [e["captured"]["capture_s"] for e in every]
    pool = g0["pool"]
    log(f"    graph captures {g0['captures']} a process (warm-up + capture "
        f"rank 0 {caps[0]:.3f} s, slowest {max(caps):.3f} s), replays "
        f"{g0['replays']}; replays only "
        f"{(g0['wall'] - caps[0]) * 1e6 / (99 * n):.6f} us/step/atom; graph "
        f"pool rank 0 " + ("not measured" if pool is None else
                           f"{pool / 2**30:.3f} GiB "
                           f"({pool / every[0]['eager']['peak']:.2f}x its "
                           f"eager max_memory_allocated)"))
    busy, calls = every[0]["replay"]
    e_busy, e_calls = every[0]["eager_profile"]
    log(f"    rank 0: eager card busy "
        + ("not measured" if e_busy is None else
           f"{e_busy:.2%}, host launch calls a step {e_calls:.0f}")
        + "; a profiled 5-step replay: card busy "
        + ("not measured" if busy is None else
           f"{busy:.2%}, host launch calls {calls}"))
    want = 100 + g0["captures"]
    for e in every:
        for name in REPLACES:
            if e["eager"]["launches"][name] != 100:
                failed.append(f"eager {name} launches {e['eager']['launches']}")
            if e["captured"]["launches"][name] != want:
                failed.append(f"captured {name} launches "
                              f"{e['captured']['launches']} != {want}")
        if (e["captured"]["captures"], e["captured"]["replays"]) != (2, 2):
            failed.append(f"captures/replays {e['captured']['captures']}/"
                          f"{e['captured']['replays']}")
    box = atoms["box"]
    worst, same, dpos, _ = dist_against(graph, eager, box, "the eager run")
    if not (worst <= 1e-6 and same and dpos <= 1e-4):
        failed.append("captured != eager")
    for tag, run in on_dev.items():
        log(f"    {tag}:")
        if not dist_against_scan(run, scan, n):
            failed.append(f"{tag} against phase 3")
    # the same grid as LocalComm's thread-ranks on card 0
    spec = dist_card_spec(cfg, case, box)
    lc = comm.LocalComm(spec.n_slabs, case["n_model"], device=dev)
    state, _ = domain.partition_atoms(atoms["pos"], atoms["vel"],
                                      atoms["typ"], spec)
    t1 = time.perf_counter()
    local = dist_protocol(dist_card_program(cfg, spec, lc, case, False),
                          params, domain.shard_state(state, lc, dev),
                          torch.as_tensor(np.asarray(box, np.float32),
                                          device=dev))
    log(f"    LocalComm, {spec.n_slabs * case['n_model']} thread-ranks on "
        f"card 0, eager: {local['wall'] * 1e6 / (99 * n):.6f} us/step/atom "
        f"({time.perf_counter() - t1:.1f} s)")
    for tag, run in on_dev.items():
        worst, _, _, _ = dist_against(run, local, box,
                                      f"LocalComm ({tag} DistComm)")
        if worst > 1e-5:
            failed.append(f"{tag} against LocalComm")
    del local
    gc.collect()
    torch.cuda.empty_cache()
    return ({"eager": every[0]["eager"]["launches"],
             "captured": g0["launches"]}, failed)


def phase_dist_cards(cfg, params, dev, scan):
    """Phase 10 (c): with two or more cards, copper at full COPPER_DP
    width over DistComm on NCCL, one process and card a rank, the 99-step
    protocol from phase 3's velocities eager and captured (each process
    records its own rank's segments as CUDA graphs and replays them),
    held: captured against eager (thermo rtol 1e-6, positions 1e-4 A by
    minimum image), both against LocalComm's thread-ranks of the same grid
    on card 0 and phase 3's rows (rtol 1e-5), atoms constant, drift <= 1e-4
    eV/atom. With one card it says so and runs nothing."""
    from repro_torch.md import integrator, lattice

    n_cards = torch.cuda.device_count()
    cases = DIST_CARD_CASES[4 if n_cards >= 4 else 2] if n_cards >= 2 else []
    if not cases:
        log(f"[10c] DistComm over NCCL, captured: needs two or more cards, "
            f"one process each; {n_cards} visible, so not run")
        return {}
    t_phase = time.perf_counter()
    pos, typ, box = lattice.fcc_copper(*[MAIN_NX] * 3)
    masses = torch.as_tensor(lattice.masses_for(("Cu",), typ),
                             dtype=torch.float32, device=dev)
    vel = integrator.init_velocities(torch.Generator().manual_seed(SEED),
                                     masses, 330.0)
    atoms = dict(pos=pos.astype(np.float32), vel=vel.cpu().numpy(), typ=typ,
                 box=np.asarray(box, np.float64))
    launches, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(Path(tmp) / "atoms.npz", **atoms)
        for i, case in enumerate(cases):
            got, bad = dist_card_case(cfg, params, dev, scan, case, tmp,
                                      atoms)
            launches[f"distributed_c{i}"] = got["eager"]
            launches[f"distributed_c{i}_graph"] = got["captured"]
            failed += [f"{case['label']}: {b}" for b in bad]
    log(f"    (c) {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError(f"phase 10 (c) failed: {failed}")
    return launches


# ----------------------------------------------------------------- phase 11

TRAIN_NX = 5         # fcc_copper(5,5,5) = 500 atoms, edge 18.17 A >= 2 rcut
TRAIN_CONFIGS = 16
TRAIN_BATCH = 4
TRAIN_STEPS = 100
TRAIN_LOG_EVERY = 10
# kernel-name fragments of a training step's device time, first match wins
TRAIN_KINDS = (("GEMM", ("gemm", "cutlass", "xmma", "cublas")),
               ("index_add_ / scatter / gather", ("index", "scatter",
                                                  "gather")),
               ("optimizer (foreach)", ("foreach", "multi_tensor")),
               ("tanh and its derivatives", ("tanh",)),
               ("reductions", ("reduce",)))


def kernel_kind(key, kinds):
    """The first kind of ``kinds`` (name, fragments) whose fragment the
    kernel's name holds."""
    low = key.lower()
    for kind, frags in kinds:
        if any(f in low for f in frags):
            return kind
    return "other elementwise"


def time_by_kind(prof, per, kinds):
    """A profile's device time in ms by kind of kernel and its kernel
    launches, each per ``per`` calls; None if it recorded no device time."""
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and dev_us(e) > 0]
    if not rows:
        return None
    by_kind = {}
    for e in rows:
        k = kernel_kind(e.key, kinds)
        by_kind[k] = by_kind.get(k, 0.0) + dev_us(e) / per / 1e3
    return by_kind, sum(e.count for e in rows) // per


def on_device(x, dev):
    from repro_torch.train import tree
    return tree.tree_map(lambda t: t.to(dev), x)


def profile_train_steps(step, state, mb, step_ms):
    """Device time of two training steps by kind of kernel, and the
    device's busy share (kernel time over wall: one stream), of the
    profiled wall and of ``step_ms``, the median step without the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, _ = step(state, mb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 2 * 1e3
    timed = time_by_kind(prof, 2, TRAIN_KINDS)
    if timed is None:
        log("    profile of a training step: the profiler recorded no "
            "device time")
        return
    kinds = timed[0]
    total = sum(kinds.values())
    log(f"    profile of a training step: {total:.3f} ms of kernels; "
        f"device busy {total / wall:.1%} of the profiled wall ({wall:.3f} "
        f"ms), {total / step_ms:.1%} of the median step without the "
        f"profiler ({step_ms:.3f} ms)")
    for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"      {v:8.3f} ms  {v / total:6.1%}  {k}")
    log_kernels(prof, 2, "a training step")


def phase_train(cfg, dev):
    """DP training at full COPPER_DP width: teacher data, 100 AdamW steps
    through the loss's double backward, the card against the CPU, a
    checkpoint round trip, the trained student tabulated and run through
    the kernels, and a profile of a step."""
    from repro_torch.core import descriptor, dp_model
    from repro_torch.train import checkpoint, dp_trainer, tree
    from repro_torch.train.steps import TrainState

    # -- data and student ------------------------------------------------
    gen = torch.Generator().manual_seed(SEED)
    teacher = dp_model.init_dp_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = dp_trainer.teacher_data(cfg, teacher, n_configs=TRAIN_CONFIGS,
                                   supercell=(TRAIN_NX,) * 3, jitter=0.12,
                                   seed=SEED, device=dev)
    torch.cuda.synchronize()
    na = data.rij.shape[1]
    live = float(data.nmask.float().mean())
    log(f"[11] teacher data: {TRAIN_CONFIGS} configurations of {na} atoms, "
        f"sel {cfg.sel}, {live:.1%} of the slots live; labelled in "
        f"{time.perf_counter() - t0:.3f} s; E_ref "
        f"{float(data.e_ref.min()):.4f}..{float(data.e_ref.max()):.4f} eV, "
        f"max|F_ref| {float(data.f_ref.abs().max()):.4e} eV/A")
    loss_cfg = dp_trainer.DPLossConfig()
    opt = dp_trainer.make_optimizer(loss_cfg)
    student = dp_trainer.fit_env_stats(
        dp_model.init_dp_params(gen, cfg, device=dev), cfg, data)
    state = TrainState(student, opt.init(student),
                       torch.zeros((), dtype=torch.int32, device=dev))
    step = dp_trainer.make_dp_train_step(cfg, loss_cfg, opt)
    n_weights = sum(t.numel() for t in tree.leaves(student))
    log(f"    student: {n_weights} weights in {len(tree.leaves(student))} "
        f"leaves (dstd and ebias trained); dstd "
        f"{student['dstd'].cpu().numpy().round(5).tolist()}")

    # -- 100 steps -------------------------------------------------------
    rng = np.random.default_rng(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times, rows = [], []
    for it in range(TRAIN_STEPS):
        mb = dp_trainer.minibatch(data, rng.integers(0, TRAIN_CONFIGS,
                                                     TRAIN_BATCH))
        t0 = time.perf_counter()
        state, m = step(state, mb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        # a NaN in any gradient makes the global norm NaN
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"step {it + 1}: loss {loss}, grad_norm "
                                 f"{gnorm}")
        if (it + 1) % TRAIN_LOG_EVERY == 0 or it == 0:
            row = {k: float(v) for k, v in m.items()}
            rows.append(row)
            log(f"    step {it + 1:4d}: loss {row['loss']:.6e} rmse_E/atom "
                f"{row['rmse_e_atom']:.6e} rmse_F {row['rmse_f']:.6e} "
                f"grad_norm {row['grad_norm']:.6e}")
    ms = float(np.median(times[5:]))
    log(f"    {TRAIN_STEPS} steps of {TRAIN_BATCH} configurations: "
        f"{ms:.3f} ms/step (median of steps 6-{TRAIN_STEPS}; first step "
        f"{times[0]:.3f} ms), {TRAIN_BATCH / ms * 1e3:.2f} configurations/s;"
        f" max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, of it "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB "
        f"above what was allocated before the first step")
    if not rows[-1]["rmse_f"] < rows[0]["rmse_f"]:
        raise AssertionError("rmse_f did not fall over training")

    # -- the card against the CPU, batch 1 -------------------------------
    # The card's atomic index_add_ sums in an order that changes from run to
    # run; two card evaluations of this near-cancelling loss (step 100) were
    # seen 1.2e-5 apart on an H100. The comparison runs index_add_'s
    # deterministic version on the card, as the continuation below does, so
    # it sees the card's arithmetic against the CPU's, not that noise.
    mb = dp_trainer.minibatch(data, np.array([0]))
    state_c, mb_c = on_device(state, "cpu"), on_device(mb, "cpu")
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss_g, _, g_g = step.loss_and_grads(state.params, mb, state.step)
        t0 = time.perf_counter()
        loss_c, _, g_c = step.loss_and_grads(state_c.params, mb_c,
                                             state_c.step)
        t_cpu = time.perf_counter() - t0
        _, m_g = step(state, mb)
        _, m_c = step(state_c, mb_c)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    worst = 0.0
    for path, g, c in zip(tree.flatten_with_paths(g_g)[1],
                          tree.leaves(g_g), tree.leaves(g_c)):
        g = g.cpu()
        atol = 1e-5 * float(c.abs().max())
        err = float((g - c).abs().max())
        worst = max(worst, err / max(float(c.abs().max()), 1e-30))
        if not (torch.isfinite(g).all()
                and torch.allclose(g, c, rtol=1e-4, atol=atol)):
            raise AssertionError(f"gradient {path}: card and CPU disagree "
                                 f"(max abs err {err:.3e}, atol {atol:.3e})")
    rel = {k: abs(float(m_g[k]) - float(m_c[k])) / abs(float(m_c[k]))
           for k in ("loss", "grad_norm")}
    rel["loss_and_grads loss"] = abs(float(loss_g) - float(loss_c)) / abs(
        float(loss_c))
    log(f"    card vs CPU, one step at batch 1 ({na} atoms; CPU "
        f"differentiation {t_cpu:.2f} s): gradients of all "
        f"{len(tree.leaves(g_c))} leaves within rtol 1e-4, atol 1e-5 "
        f"max|g| (largest |dg| / max|g| {worst:.3e}); rel. diff "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) + " (1e-5)")
    if max(rel.values()) > 1e-5:
        raise AssertionError("loss or grad_norm: card and CPU disagree")
    del state_c, mb_c, g_c, g_g

    # -- checkpoint: save_async from the card, restore onto it -----------
    ckpt_root = ROOT / "build"
    ckpt_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ckpt_root) as ckpt_dir:
        t0 = time.perf_counter()
        handle = checkpoint.save_async(ckpt_dir, TRAIN_STEPS, state)
        t_snap = time.perf_counter() - t0
        path = handle.wait()
        t_save = time.perf_counter() - t0
        restored, at = checkpoint.restore(ckpt_dir, state)
        size = sum(f.stat().st_size for f in Path(path).iterdir())
    saved, paths = tree.flatten_with_paths(state)
    for path_, a, b in zip(paths, saved, tree.leaves(restored)):
        if not (b.device == a.device and b.dtype == a.dtype
                and torch.equal(a, b)):
            raise AssertionError(f"restored leaf {path_} differs")
    losses = {"live": [], "restored": []}
    rng_b = np.random.default_rng(SEED + 1)
    mbs = [dp_trainer.minibatch(data, rng_b.integers(0, TRAIN_CONFIGS,
                                                     TRAIN_BATCH))
           for _ in range(5)]
    # index_add_ sums with atomics, in an order that changes between runs:
    # at step 100 the loss (~1e-7) is a near-cancelling sum of squared force
    # residuals, and on an H100 that order alone moved it by 8.2e-7
    # relative. The continuation runs index_add_'s deterministic version,
    # so what the comparison sees is the checkpoint.
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, st in (("live", state), ("restored", restored)):
            for b in mbs:
                st, m = step(st, b)
                losses[name].append(float(m["loss"]))
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    worst = max(abs(a - b) / abs(a) for a, b in zip(losses["live"],
                                                     losses["restored"]))
    same = losses["live"] == losses["restored"]
    log(f"    checkpoint at step {at}: {len(tree.leaves(state))} leaves, "
        f"{size / 2**20:.2f} MiB; snapshot {t_snap * 1e3:.1f} ms, written "
        f"after {t_save * 1e3:.1f} ms; restored leaves equal bit for bit; 5 "
        f"more steps (deterministic index_add_): losses live "
        f"{losses['live']}, restored {losses['restored']} (max rel diff "
        f"{worst:.3e}, rtol 1e-6; equal bit for bit: {same})")
    if worst > 1e-6:
        raise AssertionError("training from the restored checkpoint diverges")
    del restored

    # -- the trained model compressed, through the kernels ---------------
    params = state.params
    held = dp_trainer.teacher_data(cfg, params, n_configs=2,
                                   supercell=(TRAIN_NX,) * 3, seed=99,
                                   device=dev)
    e0, f0 = held.e_ref, held.f_ref
    p_q = dp_model.tabulate_model(params, cfg, "quintic")
    e1, f1 = dp_trainer.batch_energy_forces(p_q, cfg, held, impl="quintic")
    log(f"    tabulated-vs-trained (quintic): dE "
        f"{float((e1 - e0).abs().max()):.2e} eV, dF "
        f"{float((f1 - f0).abs().max()):.2e} eV/A")
    p_c = dp_model.tabulate_model(params, cfg, "cheb")
    reset_launches()
    e2, f2 = dp_trainer.batch_energy_forces(p_c, cfg, held,
                                            impl="cheb_pallas")
    torch.cuda.synchronize()
    launches = read_launches()
    de = float(((e2 - e0).abs() / e0.abs()).max())
    df = float((f2 - f0).abs().max())
    fmax = max(1.0, float(f0.abs().max()))
    log(f"    cheb_pallas (trained student) vs mlp on 2 held-out "
        f"configurations: |dE|/|E| {de:.3e} (1e-5), max|dF| {df:.3e} eV/A "
        f"(5e-5 x {fmax:.2f}); launches {launches}")
    if not (torch.isfinite(f2).all() and de <= 1e-5 and df <= 5e-5 * fmax):
        raise AssertionError("the trained student's cheb_pallas disagrees "
                             "with mlp")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the trained "
                                 f"model")
    # each kernel against its plain version at the shape this path gives it
    with torch.no_grad():
        env, s = descriptor.env_matrix(held.rij, held.nmask, cfg.rcut_smth,
                                       cfg.rcut)
        env, s = descriptor.normalize_env(env, s, held.atype, params["dstd"])
    dist_kernel_case(f"trained student, {held.rij.shape[0]} held-out "
                     f"configurations", (s.reshape(-1, s.shape[-1]),
                                         env.reshape(-1, s.shape[-1], 4),
                                         p_c["table"]["nets"]["0"]["coeffs"],
                                         cfg.table_lower, cfg.table_upper),
                     dev)
    del env, s, held, p_q, p_c

    profile_train_steps(step, state, dp_trainer.minibatch(
        data, np.arange(TRAIN_BATCH)), ms)
    return launches



# ----------------------------------------------------------------- phase 12

DRYRUN_SEG = 2       # steps of a traced and of a real segment
DRYRUN_FIT = 0.70    # real runs for estimates under this share of the card
DRYRUN_BAND = (0.75, 1.25)   # real peak / estimated peak


class RecordCalls:
    """Wraps ``ops.fused_fwd`` while a run goes through it and keeps the
    inputs of calls ``first .. first + count - 1`` (0-based; one per
    neighbour section), cloned, so the kernels can be timed at the shapes
    the run gave them. Calls before ``first`` (a measured run's) keep
    nothing, so they allocate nothing extra."""

    def __init__(self, first, count):
        from repro_torch.kernels.dp_fused import ops
        self.ops, self.orig = ops, ops.fused_fwd
        self.first, self.count, self.calls, self.args = first, count, 0, []

    def __enter__(self):
        def wrapped(s, env, coeffs, counts, lower, upper):
            if self.first <= self.calls < self.first + self.count:
                self.args.append((s.clone(), env.clone(), coeffs, lower,
                                  upper))
            self.calls += 1
            return self.orig(s, env, coeffs, counts, lower, upper)
        self.ops.fused_fwd = wrapped
        return self

    def __exit__(self, *exc):
        self.ops.fused_fwd = self.orig


def log_dryrun_row(row):
    log(f"  {row['cell']}: atoms/chip {row['atoms_per_chip']}, centers "
        f"{row['centers']} x sel {row['sel']}, mem {row['mem_GiB']:.3f} GiB "
        f"(args {row['arg_bytes'] / 2**30:.3f}, cell list "
        f"{row['cell_list_GiB']:.3f}), FLOPs {row['flops/chip']:.4e} (kernels "
        f"{row['kernel_flops/chip']:.4e}), bytes {row['bytes/chip']:.4e}, "
        f"collective {row['coll_bytes/chip']:.4e} B; t_compute "
        f"{row['t_compute'] * 1e3:.3f} ms, t_memory {row['t_memory'] * 1e3:.3f}"
        f" ms, t_collective {(row['t_ici'] + row['t_dcn']) * 1e3:.4f} ms -> "
        f"{row['dominant']}; trace {row['t_compile_s']} s")


def phase_dryrun(dev):
    """``repro_torch.launch.md_dryrun`` on the card: every cell (cu,
    cu_strong, h2o) x rung on the 16 x 16 grid as a fake CUDA trace of rank
    (0, 0)'s segment of DRYRUN_SEG steps, each row printed. Every row whose
    estimate fits under DRYRUN_FIT of the card runs for real
    (``md_dryrun.run_rank``: the rank's brick as a periodic block of the
    lattice whose halo is its own far faces), and its peak memory above
    what was allocated before it must lie within DRYRUN_BAND of the
    estimate; a neighbour overflow escalates sel as the drivers do, and the
    estimate is traced again at the escalated sel. Step time against the
    roofline's bound; the kernels held against ref.py and timed at the
    cheb_pallas runs' shapes."""
    from repro_torch.launch import md_dryrun, mesh
    from repro_torch.md import stepper

    total = torch.cuda.get_device_properties(0).total_memory
    # the real runs allocate tens of GiB in blocks of many sizes after the
    # earlier phases' allocations: grow segments in place instead of
    # splitting cached blocks, or the allocator fragments past the card
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    log(f"[12] dry run of rank (0, 0) on the 16 x 16 grid, {DRYRUN_SEG}-step "
        f"segments; card total_memory {total} B ({total / 2**30:.3f} GiB); "
        f"real runs below {DRYRUN_FIT:.0%} of it")
    grid = mesh.make_production_mesh(multi_pod=False)
    kernels, misses, launches = {}, [], {"dp_fused_fwd": 0,
                                         "dp_fused_bwd": 0}
    for name, cell in md_dryrun.CELLS.items():
        sel = None                     # escalated once a real run needs it
        for impl in md_dryrun.IMPLS:
            def estimate(sel):
                row = md_dryrun.lower_md_cell(
                    cell, impl, grid, False, verbose=False,
                    segment_len=DRYRUN_SEG, device="cuda", sel=sel)
                if row["status"] != "ok":
                    raise AssertionError(f"dry run of {name}/{impl} failed: "
                                         f"{row['error']}")
                log_dryrun_row(row)
                fits = row["mem_GiB"] * 2**30 <= DRYRUN_FIT * total
                if not fits:
                    log(f"    not run: the estimate exceeds {DRYRUN_FIT:.0%}"
                        f" of the card")
                return row, fits

            est, fits = estimate(None)
            if sel is not None:
                est, fits = estimate(sel)
            if not fits:
                continue
            rank = md_dryrun.rank_config(cell, impl, grid, False, sel=sel)
            n_sec = len(rank.cfg.sel)
            reset_launches()
            try:
                with RecordCalls(DRYRUN_SEG * n_sec, n_sec) as rec:
                    out = md_dryrun.run_rank(rank, DRYRUN_SEG, device=dev)
            except RuntimeError as e:
                if "nbr_overflow" not in str(e) or sel is not None:
                    raise
                sel = tuple(stepper.EscalationPolicy().grow(x)
                            for x in rank.cfg.sel)
                log(f"    real run: {e}; sel {tuple(rank.cfg.sel)} -> {sel}, "
                    f"as the drivers escalate")
                est, fits = estimate(sel)
                if not fits:
                    continue
                rank = md_dryrun.rank_config(cell, impl, grid, False, sel=sel)
                reset_launches()
                with RecordCalls(DRYRUN_SEG * n_sec, n_sec) as rec:
                    out = md_dryrun.run_rank(rank, DRYRUN_SEG, device=dev)
            got = read_launches()
            est_peak = est["mem_GiB"] * 2**30
            ratio = out["peak_bytes"] / est_peak
            bound = est["bound_time"] / est["steps"] * 1e3
            pe = out["pe"]
            log(f"    real run: {out['atoms']} atoms (box "
                f"{tuple(round(b, 3) for b in out['box'])}), "
                f"max_memory_allocated above the allocation at the reset "
                f"({out['base_bytes']} B) {out['peak_bytes']} B = "
                f"{out['peak_bytes'] / 2**30:.3f} GiB, "
                f"estimate {est_peak / 2**30:.3f} GiB, ratio {ratio:.4f} "
                f"(band {DRYRUN_BAND}); ms/step {out['ms_per_step']:.3f} "
                f"(first run {out['ms_per_step_first']:.3f}) vs bound_time "
                f"{bound:.3f} ms/step ({bound / out['ms_per_step']:.2%} of "
                f"it); pe {pe}; atoms per step {out['n_atoms']}; launches "
                f"{got}")
            if not (np.all(np.isfinite(pe))
                    and all(n == out["atoms"] for n in out["n_atoms"])):
                raise AssertionError(f"{est['cell']}: non-finite energy or "
                                     f"atoms lost")
            if not DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1]:
                misses.append((est["cell"], ratio))
            if impl == "cheb_pallas":
                for k_ in launches:
                    if got[k_] < 1:
                        raise AssertionError(f"{est['cell']}: {k_} was not "
                                             f"launched")
                    launches[k_] += got[k_]
                for t, args in enumerate(rec.args):
                    label = f"dry-run rank {name}, section {t}"
                    kernels[f"{name}{t}"] = kernel_case(
                        label, *args, dev,
                        torch.Generator(device=dev).manual_seed(SEED),
                        sample=False, chunked_lib=True)
                del rec
            torch.cuda.empty_cache()
    if misses:
        raise AssertionError(f"real peak / estimate outside {DRYRUN_BAND}: "
                             f"{misses}")
    return kernels, launches

# ----------------------------------------------------------------- phase 13

LM_BATCH = 4
LM_PROMPT = 256
LM_STEPS = 32        # decode steps: the cache ends at LM_PROMPT + LM_STEPS
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_TOL = 1e-3       # check (a): rtol, and atol as a share of max|logit|
BF16_TOL = (0.08, 0.05)      # the reference's rtol, atol (test_lm_consistency)
BF16_RATIO = 1.25    # check (b): decode's error at most this x the forward's
BF16_QUANTILE = 0.999        # ... in mean and at this quantile
# leaves that compute in f32 (never cast to the compute dtype)
LM_F32_LEAVES = ("router", "shared_gate", "w_rgate", "w_igate", "r_zifo",
                 "lam")
LM_KINDS = (("GEMM", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
            ("casts and copies", ("copy", "cast", "convert")),
            ("reductions, softmax", ("reduce", "softmax")),
            ("index / scatter / sort", ("index", "scatter", "gather",
                                        "sort", "radix")))


def lm_decode_bytes(cfg, params, batch):
    """(weight bytes read, cast bytes) of one reference-faithful decode
    step: every f32 master leaf read once, but of an untied embedding
    table only the batch's rows (and of whisper's position table one row);
    each leaf of two or more dimensions that is cast to a bf16 compute
    dtype writes its copy and the product reads it (2 + 2 bytes an
    element). MoE decode runs every expert's (capacity-padded) buffer, so
    every expert's weights count."""
    from repro_torch.train import tree

    tied = cfg.tie_embeddings or cfg.family in ("hybrid", "encdec")
    weight = cast = 0
    for t, path in zip(*tree.flatten_with_paths(params)):
        n = t.numel()
        if path == "embed" and not tied:
            n = batch * t.shape[1]
        elif path == "pos_dec":
            n = t.shape[1]
        weight += n * t.element_size()
        if (cfg.dtype != cfg.param_dtype and t.dim() >= 2
                and path.split("/")[-1] not in LM_F32_LEAVES
                and path != "pos_dec" and not (path == "embed" and not tied)):
            cast += n * 4
    return weight, cast


class RoutingTape:
    """Records the experts the port's MoE router picks, layer by layer and
    position by position, or replays a recording: a replayed call routes
    each token to the recorded experts, with gates from its own router
    probabilities. Calls cycle through the layers in order; each advances
    its layer's position by its sequence length (a forward: the whole
    sequence; a prefill: the prompt; a decode step: one token)."""

    def __init__(self, n_layers, replay=None):
        self.n_layers, self.replay = n_layers, replay
        self.ids = [[] for _ in range(n_layers)]
        self.pos = [0] * n_layers
        self.calls = 0

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.route

        def route(p, cfg, x):
            layer = self.calls % self.n_layers
            self.calls += 1
            gates, ids, aux = self.orig(p, cfg, x)
            if self.replay is None:
                self.ids[layer].append(ids)
                return gates, ids, aux
            start = self.pos[layer]
            self.pos[layer] += x.shape[1]
            ids = self.replay[layer][:, start:start + x.shape[1]]
            gates = torch.softmax(x.float() @ p["router"], dim=-1).gather(
                -1, ids)
            return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), \
                ids, aux

        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig

    def recorded(self):
        return [torch.cat(calls, dim=1) for calls in self.ids]


def lm_teacher_forced(api, params, seq, p_len, frames=None):
    """The forward over ``seq``: the logits at position p_len - 1 on."""
    kw = {} if frames is None else {"frames": frames}
    with torch.inference_mode():
        logits, _ = api.forward(params, tokens=seq, **kw)
    return logits[:, p_len - 1:].float()


def lm_decode_along(api, params, seq, p_len):
    """prefill of seq[:, :p_len], then a decode step for each later token of
    ``seq`` (fed, not sampled): the logits at position p_len - 1 on."""
    with torch.inference_mode():
        logits, cache = api.prefill(params, seq[:, :p_len], seq.shape[1])
        out = [logits]
        for t in range(p_len, seq.shape[1]):
            logits, cache = api.decode_step(params, seq[:, t:t + 1], cache)
            out.append(logits)
    return torch.stack(out, dim=1).float()


def lm_serve_pass(tag, api, params, prompts, frames=None, base=0):
    """One serving pass (prompt + LM_STEPS greedy decode steps) with its
    numbers; peak memory above ``base`` (what earlier phases left
    allocated). Check (c): every logit finite, the cache at P + LM_STEPS.
    Returns the result and the token sequence the decode steps were fed
    (the prompt, then every sampled token but the last)."""
    from repro_torch.launch.serve_lm import serve

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = serve(api, params, prompts, LM_STEPS, frames, keep_logits=True)
    peak = torch.cuda.max_memory_allocated() - base
    b, p_len = prompts.shape
    length = int(res.cache.length)
    finite = all(bool(torch.isfinite(t).all()) for t in res.logits)
    log(f"    {tag}: prefill {res.prefill_ms:.3f} ms ("
        f"{b * p_len / res.prefill_ms * 1e3:.1f} tokens/s), decode "
        f"{res.ms_per_token:.3f} ms/token at batch {b} ("
        f"{b / res.ms_per_token * 1e3:.1f} tokens/s), peak "
        f"{peak / 2**30:.3f} GiB, cache length {length}")
    if length != p_len + LM_STEPS or not finite:
        raise AssertionError(f"{tag}: (c) cache length {length} or "
                             f"non-finite logits")
    return res, torch.cat([prompts, res.tokens[:, :-1]], dim=1)


def lm_bound(tag, cfg, params, res):
    weight, cast = lm_decode_bytes(cfg, params, LM_BATCH)
    bound = (weight + cast) / HBM_BYTES_PER_S * 1e3
    log(f"    {tag} decode byte bound: {weight / 1e9:.3f} GB of weights + "
        f"{cast / 1e9:.3f} GB of casts over {HBM_BYTES_PER_S / 1e12:.2f} TB/s"
        f" = {bound:.3f} ms; measured {res.ms_per_token:.3f} ms/token "
        f"({bound / res.ms_per_token:.1%} of the bound)")


def lm_check_f32(tag, got, want):
    """Check (a): rtol 1e-3, atol 1e-3 x max|logit|."""
    atol = F32_TOL * float(want.abs().max())
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= atol + F32_TOL * want.abs()).all())
    log(f"    {tag}: max_abs_err {float(err.max()):.4e} (max|logit| "
        f"{float(want.abs().max()):.3f}, rtol {F32_TOL:g}, atol {atol:.3e})"
        f" {'ok' if ok else 'FAIL'}")
    return ok


def _quantile(x, q):
    """The q-quantile of |x|'s elements (torch.quantile takes at most 2^24)."""
    flat = x.flatten()
    k = max(1, int(round((1 - q) * flat.numel())))
    return float(flat.topk(k).values[-1])


def lm_check_bf16(got16, want16, want32):
    """Check (b): the bf16 decode logits against the bf16 teacher-forced
    forward at the reference's tolerance (printed), and held to this: the
    decode adds no error of its own, its mean and 99.9th-percentile
    distance from the f32 forward over the same tokens at most BF16_RATIO
    x the bf16 forward's. At 28 layers 1e-5 of qwen3's logits fall outside
    the reference's 2-layer tolerance (none at 2 layers) while both bf16
    paths sit equally far from f32; the maximum over millions of logits
    varies between runs (MoE: atomics), so it is printed, not held
    (PERF.md §6)."""
    rtol, atol = BF16_TOL
    err = (got16 - want16).abs()
    outside = float((err > atol + rtol * want16.abs()).float().mean())
    d_dec, d_fwd = (got16 - want32).abs(), (want16 - want32).abs()
    q_dec, q_fwd = (_quantile(d, BF16_QUANTILE) for d in (d_dec, d_fwd))
    ok = (bool(torch.isfinite(got16).all())
          and float(d_dec.mean()) <= BF16_RATIO * float(d_fwd.mean())
          and q_dec <= BF16_RATIO * q_fwd)
    log(f"    (b) bf16 decode vs bf16 forward: max_abs_err "
        f"{float(err.max()):.4e}, mean {float(err.mean()):.4e}, "
        f"{outside:.3e} of the logits outside rtol {rtol:g} / atol {atol:g}"
        f"; distance from the f32 forward, decode against forward: mean "
        f"{float(d_dec.mean()):.4e} / {float(d_fwd.mean()):.4e}, "
        f"{BF16_QUANTILE:.1%} quantile {q_dec:.4e} / {q_fwd:.4e}, max "
        f"{float(d_dec.max()):.4e} / {float(d_fwd.max()):.4e} (ratio limit "
        f"{BF16_RATIO:g}) {'ok' if ok else 'FAIL'}")
    return ok


def profile_lm_decode(api, params, res):
    """Device time of one decode step by kind of kernel, its launches and
    the device's busy share of the profiled wall. The step rewrites the
    cache's last position (the cache is full)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.steps import make_serve_step

    step = make_serve_step(api)
    tok = res.tokens[:, -1:]
    cache = res.cache._replace(length=res.cache.length - 1)
    step(params, tok, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, tok, cache)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    timed = time_by_kind(prof, 1, LM_KINDS)
    if timed is None:
        log("    profile of a decode step: the profiler recorded no device "
            "time")
        return
    kinds, launches = timed
    total = sum(kinds.values())
    log(f"    profile of one decode step: {total:.3f} ms of kernels in "
        f"{launches} launches; device busy {total / wall:.1%} of the "
        f"profiled wall ({wall:.3f} ms)")
    for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"      {v:8.3f} ms  {v / total:6.1%}  {k}")
    log_kernels(prof, 1, "a decode step", top=8)


def phase_lm_serve(dev):
    """The LM zoo served on the card (``repro_torch.launch.serve_lm.serve``:
    prefill, then greedy decode through ``make_serve_step``), batch 4,
    prompt 256, 32 decode steps, weights from seed 0 drawn on the card.
    qwen3-1.7b and granite-moe-1b-a400m at their full CONFIG, served in
    bf16 as published (granite-moe at capacity factor 1.25) and timed;
    then (a) in f32 (TF32 off) the prefill's last logits and every step's
    equal the teacher-forced forward over the same tokens at rtol 1e-3,
    atol 1e-3 x max|logit|; (b) the bf16 decode against the bf16 forward
    (``lm_check_bf16``); (c) every logit finite, the cache at 256 + 32.
    granite-moe's checks route drop-free (capacity_factor = n_experts /
    top_k) and (b) replays the bf16 forward's routing in the decode and in
    the f32 forward (``RoutingTape``): top-8-of-32 decisions flip between
    the two bf16 computations. Then one f32 serving pass with (a) and (c)
    for xlstm-125m, whisper-base (1,500 stub frames) and recurrentgemma-9b
    at full width, depth cut to one rrl period; xlstm's (a) runs with its
    sLSTM recurrent matrices at std 1/sqrt(head dim), its error at the
    reference's init (chaotic) printed beside. Times, peak memory, the
    decode step's byte bound, a profile of one qwen3 decode step."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.serve_lm import serve
    from repro_torch.models import build
    from repro_torch.train import tree

    torch.cuda.empty_cache()
    reset_launches()
    t_phase = time.perf_counter()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev)
    log(f"[13] LM serving: batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"{LM_STEPS} greedy decode steps; weights from seed {SEED} drawn on "
        f"the card; peak memory above the {base / 2**30:.3f} GiB that "
        f"earlier phases left allocated")
    failures = []

    def prompts_for(cfg):
        return torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                             generator=gen.manual_seed(SEED + 1), device=dev)

    def init(arch, cfg):
        t0 = time.perf_counter()
        params = build(cfg).init(gen.manual_seed(SEED), device=dev)
        torch.cuda.synchronize()
        n_par = sum(t.numel() for t in tree.leaves(params))
        log(f"  {arch}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
            f"{cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab}; {n_par} "
            f"parameters ({n_par * 4 / 1e9:.3f} GB f32), init "
            f"{time.perf_counter() - t0:.2f} s")
        return params

    # -- dense and MoE at full width: timed bf16, then (a), (b), (c) -----
    for arch in ("qwen3-1.7b", "granite-moe-1b-a400m"):
        cfg = configs.get(arch)
        params = init(arch, cfg)
        prompts = prompts_for(cfg)
        published = build(cfg)
        serve(published, params, prompts, 2)      # warm-up: library handles
        res, seq = lm_serve_pass(
            "bf16 serving" + (f", capacity factor {cfg.moe.capacity_factor}"
                              if cfg.family == "moe" else ""),
            published, params, prompts, base=base)
        lm_bound("bf16", cfg, params, res)
        moe_cfg = cfg.family == "moe"
        if moe_cfg:
            m = cfg.moe
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                m, capacity_factor=m.n_experts / m.top_k))
            log(f"    checks route drop-free: capacity_factor {m.n_experts}"
                f" / {m.top_k} = {cfg.moe.capacity_factor:g}")
        api16 = build(cfg)
        api32 = build(dataclasses.replace(cfg, dtype="float32"))
        res32, seq32 = lm_serve_pass("f32 serving", api32, params, prompts,
                                     base=base)
        lm_bound("f32", api32.cfg, params, res32)
        if not lm_check_f32("(a) f32 decode vs teacher-forced forward",
                            torch.stack(res32.logits, dim=1).float(),
                            lm_teacher_forced(api32, params, seq32,
                                              LM_PROMPT)):
            failures.append(f"{arch} (a)")
        del res32, seq32
        if moe_cfg:
            res16, seq = lm_serve_pass("bf16 serving, drop-free", api16,
                                       params, prompts, base=base)
            with RoutingTape(cfg.n_layers) as served_tape:
                lm_decode_along(api16, params, seq, LM_PROMPT)
            with RoutingTape(cfg.n_layers) as tape:
                want16 = lm_teacher_forced(api16, params, seq, LM_PROMPT)
            flips = sum(int((a.sort(-1).values != b.sort(-1).values)
                            .any(-1).sum()) for a, b in zip(
                served_tape.recorded(), tape.recorded()))
            total = sum(int(t[..., 0].numel()) for t in tape.recorded())
            log(f"    routing: {flips} of {total} token-layer decisions "
                f"differ between the bf16 decode and the bf16 forward; (b) "
                f"replays the forward's")
            with RoutingTape(cfg.n_layers, tape.recorded()):
                got16 = lm_decode_along(api16, params, seq, LM_PROMPT)
            with RoutingTape(cfg.n_layers, tape.recorded()):
                want32 = lm_teacher_forced(api32, params, seq, LM_PROMPT)
            del res16
        else:
            got16 = torch.stack(res.logits, dim=1).float()
            want16 = lm_teacher_forced(api16, params, seq, LM_PROMPT)
            want32 = lm_teacher_forced(api32, params, seq, LM_PROMPT)
        if not lm_check_bf16(got16, want16, want32):
            failures.append(f"{arch} (b)")
        del got16, want16, want32
        if not moe_cfg:
            profile_lm_decode(published, params, res)
        del res, params
        torch.cuda.empty_cache()

    # -- the other families: one f32 serving pass each, (a) and (c) ------
    rg = configs.get("recurrentgemma-9b")
    log(f"  reduced: recurrentgemma-9b n_layers {rg.n_layers} -> "
        f"{len(rg.hybrid_pattern)} (one {rg.hybrid_pattern} period), every "
        f"width in full")
    for arch, cfg in (
            ("xlstm-125m", configs.get("xlstm-125m")),
            ("whisper-base", configs.get("whisper-base")),
            ("recurrentgemma-9b", dataclasses.replace(
                rg, n_layers=len(rg.hybrid_pattern)))):
        cfg = dataclasses.replace(cfg, dtype="float32")
        api = build(cfg)
        params = init(arch + " (f32, prompt fed token by token)", cfg)
        frames = None
        if cfg.family == "encdec":
            frames = torch.randn((LM_BATCH, cfg.n_audio_frames, cfg.d_model),
                                 generator=gen.manual_seed(SEED + 2),
                                 device=dev)
        prompts = prompts_for(cfg)
        res, seq = lm_serve_pass("f32 serving", api, params, prompts, frames,
                                 base)
        lm_bound("f32", cfg, params, res)
        got = torch.stack(res.logits, dim=1).float()
        want = lm_teacher_forced(api, params, seq, LM_PROMPT, frames)
        if cfg.family == "ssm":
            err = float((got - want).abs().max())
            log(f"    at the reference's init: decode vs forward max_abs_err"
                f" {err:.4e} (max|logit| {float(want.abs().max()):.3f}): the"
                f" sLSTM recurrence, r_zifo at std 1/sqrt(4), is chaotic at "
                f"head dim {cfg.d_model // cfg.n_heads}; (a) runs with "
                f"r_zifo at std 1/sqrt(head dim)")
            dh = cfg.d_model // cfg.n_heads
            for name, block in params["periods"].items():
                if name.endswith("_s"):
                    block["r_zifo"] = block["r_zifo"] * (4 / dh) ** 0.5
            res, seq = lm_serve_pass("f32 serving, sLSTM rescaled", api,
                                     params, prompts, base=base)
            got = torch.stack(res.logits, dim=1).float()
            want = lm_teacher_forced(api, params, seq, LM_PROMPT)
        if not lm_check_f32("(a) f32 decode vs teacher-forced forward", got,
                            want):
            failures.append(f"{arch} (a)")
        del res, params, got, want
        torch.cuda.empty_cache()

    launches = read_launches()
    log(f"  dp_fused launches during phase 13: {launches} (none expected); "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"phase 13 checks failed: {failures}")
    return launches


# ----------------------------------------------------------------- phase 14

LT_ARCH = "qwen3-1.7b"
LT_STEPS = 10
LT_BATCH = 2         # train_4k's global batch 256, cut for one card
LT_SEQ = 4096        # train_4k's sequence (lm_types.ASSIGNED_SHAPES)
LT_CHUNK = 512
LT_TIMED_FROM = 3    # ms/step over steps 3..10
H100_BF16_FLOPS = 989e12     # H100 SXM data sheet, dense bf16
LT_GRAD_TOL = 1e-4   # (b): each leaf's gradient within this x max|g|
LT_KINDS = (("GEMM", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
            ("casts and copies", ("copy", "cast", "convert")),
            ("index / scatter / gather (embedding, MoE)",
             ("index", "scatter", "gather", "embedding", "sort", "radix")),
            ("reductions, softmax", ("reduce", "softmax")))


def lt_leaves_close(tag, got, want, tol):
    """Every leaf of ``got`` (card) within tol x max|want| of ``want``."""
    from repro_torch.train import tree

    leaves, paths = tree.flatten_with_paths(want)
    worst, bad = 0.0, []
    for g, w, path in zip(tree.leaves(got), leaves, paths):
        g = g.detach().float().cpu()
        w = w.detach().float().cpu()
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, err)
        if not bool(torch.isfinite(g).all()) or err > tol:
            bad.append(path)
    log(f"    {tag}: {len(leaves)} leaves, worst max|dg| / max|g| "
        f"{worst:.3e} (limit {tol:g}) {'ok' if not bad else 'FAIL'}")
    if bad:
        log(f"      leaves over the limit: {bad[:8]}")
    return not bad


def profile_lm_train_step(step, state, batch):
    """One train step under the profiler, in its two parts: the loss and
    its gradients (device time by kind of kernel) and the in-place AdamW
    update; launches and the device's busy share of the profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    parts = {}
    # device activity only: ~95 k kernels a step, and recording every
    # host op beside them costs the phase a minute of post-processing
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, grads = step.loss_and_grads(state.params, batch)
        torch.cuda.synchronize()
        parts["forward + backward"] = time.perf_counter() - t0
    timed = time_by_kind(prof, 1, LT_KINDS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof_opt:
        t0 = time.perf_counter()
        step.opt.update_(grads, state.opt, state.params)
        torch.cuda.synchronize()
        parts["AdamW update_"] = time.perf_counter() - t0
    del grads
    timed_opt = time_by_kind(prof_opt, 1, ())
    if timed is None or timed_opt is None:
        log("    profile of a train step: the profiler recorded no device "
            "time")
        return
    kinds, launches = timed
    opt_ms, opt_launches = sum(timed_opt[0].values()), timed_opt[1]
    kinds["optimizer (in-place AdamW, all its kernels)"] = opt_ms
    total = sum(kinds.values())
    wall = sum(parts.values()) * 1e3
    log(f"    profile of one train step: {total:.3f} ms of kernels in "
        f"{launches + opt_launches} launches ({opt_launches} of them the "
        f"update); device busy {total / wall:.1%} of the profiled wall "
        f"({wall:.3f} ms: " + ", ".join(
            f"{k} {v * 1e3:.3f} ms" for k, v in parts.items()) + ")")
    for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"      {v:8.3f} ms  {v / total:6.1%}  {k}")
    log_kernels(prof, 1, "the forward + backward", top=10)


def lt_state(api, gen, dev, lr=3e-4):
    """(AdamW at a constant ``lr``, a fresh state from SEED on the card)."""
    from repro_torch.train import optim
    from repro_torch.train.steps import init_train_state

    opt = optim.AdamW(lr=lambda s: torch.tensor(lr, device=dev))
    return opt, init_train_state(api, opt, gen.manual_seed(SEED), dev)


def phase_lm_train(dev):
    """LM training on the card (``repro_torch.launch.train``): (a) the main
    path, ``train_loop`` of qwen3-1.7b at full CONFIG for 10 steps of 2 x
    4096 tokens (train_4k's sequence; its global batch 256 cut to 2), bf16
    on f32 masters, remat on, the cosine schedule, no checkpoint: finite
    loss and grad norm every step, step 10, every leaf moved; ms/step over
    steps 3-10, tokens/s, the model FLOP share (6 x n_active_params x
    tokens, the reference's ``dryrun.model_flops``, over the H100 SXM data
    sheet's 989 TFLOP/s dense bf16), peak memory and a profile of one step.
    (b) qwen3 cut to 2 layers at full width, f32 (TF32 off), 1 x 512
    tokens, loss chunk 128: the card's loss and every leaf's gradient
    against the port on the CPU from the same params and batch (loss rtol
    1e-5, gradients within 1e-4 x max|g| of the leaf), and remat on
    against off on the card at the same bound. (c) granite-moe-1b-a400m at
    full CONFIG (32 experts, top-8, capacity 1.25), 3 steps of 2 x 4096:
    finite, moe_aux > 0, a nonzero gradient on the router and on each
    expert's weights. (d) xlstm-125m, whisper-base (1,500 stub frames) and
    recurrentgemma-9b (3 of 38 layers, full width), 2 steps of 2 x 512
    each: finite losses (xLSTM's gradient norm overflows at the reference's
    init in both packages: ``scripts/lm_train_diagnostics.py``). (e) whisper-base at full CONFIG under deterministic
    algorithms: 6 steps of ``train_loop`` straight and as 3 + checkpoint +
    restore + 3: the final states equal bit for bit. dp_fused launches (0)
    under path "lm_train"."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build
    from repro_torch.train import optim, tree
    from repro_torch.train.steps import make_train_step

    gc.collect()             # earlier phases' tensors held in cycles
    torch.cuda.empty_cache()
    reset_launches()
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    failures = []
    base = torch.cuda.memory_allocated()
    log(f"[14] LM training; {base / 2**30:.3f} GiB left allocated by earlier "
        f"phases")

    # -- (a) the main path ----------------------------------------------
    t_sub = time.perf_counter()
    cfg = configs.get(LT_ARCH)
    tokens = LT_BATCH * LT_SEQ
    log(f"  (a) train_loop({LT_ARCH!r}): full CONFIG ({cfg.n_layers} layers,"
        f" d {cfg.d_model}, vocab {cfg.vocab}, {cfg.n_params()} parameters),"
        f" {cfg.dtype} compute on f32 masters, remat {cfg.remat}; "
        f"{LT_STEPS} steps of {LT_BATCH} x {LT_SEQ} tokens, loss chunk "
        f"{LT_CHUNK}; reduced: train_4k's global batch 256 -> {LT_BATCH}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, hist = train_loop(LT_ARCH, reduced=False, steps=LT_STEPS,
                             global_batch=LT_BATCH, seq_len=LT_SEQ,
                             loss_chunk=LT_CHUNK, log_every=1, seed=SEED,
                             device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    finite = all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                 for h in hist)
    fresh = build(cfg).init(gen.manual_seed(SEED), device=dev)
    still = [p for p, a, b in zip(tree.flatten_with_paths(fresh)[1],
                                  tree.leaves(fresh),
                                  tree.leaves(state.params))
             if torch.equal(a, b)]
    del fresh
    ms = float(np.mean([h["ms"] for h in hist[LT_TIMED_FROM - 1:]]))
    flops = 6 * cfg.n_active_params() * tokens
    log(f"    losses {[round(h['loss'], 4) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 3) for h in hist]}")
    log(f"    ms/step {[round(h['ms'], 1) for h in hist]}; steps "
        f"{LT_TIMED_FROM}-{LT_STEPS}: {ms:.1f} ms/step, "
        f"{tokens / ms * 1e3:.0f} tokens/s; model FLOPs {flops:.4e} a step "
        f"(6 x {cfg.n_active_params()} x {tokens}), "
        f"{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s = "
        f"{flops / (ms / 1e3) / H100_BF16_FLOPS:.1%} of the H100 SXM data "
        f"sheet's {H100_BF16_FLOPS / 1e12:.0f} TFLOP/s dense bf16")
    log(f"    peak memory (max_memory_allocated) {peak / 2**30:.3f} GiB "
        f"({peak / 1e9:.2f} GB) above the phase's start; loop wall "
        f"{wall:.1f} s with init; step {int(state.step)}; leaves unchanged "
        f"{still}")
    if not finite or int(state.step) != LT_STEPS or still:
        failures.append("(a)")
    step = make_train_step(build(cfg), optim.AdamW(
        lr=lambda s: torch.tensor(3e-5, device=dev)), loss_chunk=LT_CHUNK,
        donate=True)
    pipe = pipeline_for(cfg, LT_SEQ, LT_BATCH, seed=SEED)
    profile_lm_train_step(step, state, pipe.batch(LT_STEPS, dev))
    del state, step
    torch.cuda.empty_cache()

    # -- (b) gradients on the card against the CPU ----------------------
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    log(f"    (a) {time.perf_counter() - t_sub:.1f} s")
    t_sub = time.perf_counter()
    log(f"  (b) {LT_ARCH} cut to {cfg2.n_layers} layers at full width, f32 "
        f"(TF32 {torch.backends.cuda.matmul.allow_tf32}), 1 x 512 tokens, "
        f"loss chunk 128")
    api2 = build(cfg2)
    params = api2.init(gen.manual_seed(SEED), device=dev)
    batch = pipeline_for(cfg2, 512, 1, seed=SEED).batch(0, dev)
    opt = optim.AdamW(lr=lambda s: 1e-3)
    g_step = make_train_step(api2, opt, loss_chunk=128)
    loss_g, aux_g, grads_g = g_step.loss_and_grads(params, batch)
    t0 = time.perf_counter()
    loss_c, _, grads_c = g_step.loss_and_grads(
        on_device(params, "cpu"), on_device(batch, "cpu"))
    log(f"    CPU pass {time.perf_counter() - t0:.1f} s")
    ok_loss = abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    log(f"    loss card {float(loss_g):.7f} cpu {float(loss_c):.7f} (rtol "
        f"1e-5) {'ok' if ok_loss else 'FAIL'}")
    ok = lt_leaves_close("card vs CPU gradients", grads_g, grads_c,
                         LT_GRAD_TOL)
    del grads_c
    off = make_train_step(build(dataclasses.replace(cfg2, remat=False)), opt,
                          loss_chunk=128)
    loss_o, _, grads_o = off.loss_and_grads(params, batch)
    ok_remat = lt_leaves_close("remat on vs off on the card", grads_g,
                               grads_o, LT_GRAD_TOL) and abs(
        float(loss_o) - float(loss_g)) <= 1e-5 * abs(float(loss_g))
    if not (ok_loss and ok and ok_remat):
        failures.append("(b)")
    del grads_o
    # what each AdamW update allocates above the state it starts from (the
    # in-place one last: it overwrites params)
    moments = opt.init(params)
    n_bytes = sum(t.numel() * 4 for t in tree.leaves(params))
    for name, update in (("update (out of place)", opt.update),
                         ("update_ (in place)", opt.update_)):
        g = tree.tree_map(torch.clone, grads_g)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = update(g, moments, params)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        log(f"    AdamW {name}: {extra / 1e9:.3f} GB above the state and "
            f"grads ({extra / n_bytes:.2f}x the {n_bytes / 1e9:.3f} GB of "
            f"f32 params)")
        del g, out
    del params, grads_g, moments
    torch.cuda.empty_cache()
    log(f"    (b) {time.perf_counter() - t_sub:.1f} s")

    # -- (c) MoE at full CONFIG -----------------------------------------
    t_sub = time.perf_counter()
    cfg3 = configs.get("granite-moe-1b-a400m")
    m = cfg3.moe
    log(f"  (c) granite-moe-1b-a400m: full CONFIG ({m.n_experts} experts, "
        f"top-{m.top_k}, capacity {m.capacity_factor}), 3 steps of "
        f"{LT_BATCH} x {LT_SEQ}")
    api3 = build(cfg3)
    opt3, st3 = lt_state(api3, gen, dev)
    pipe3 = pipeline_for(cfg3, LT_SEQ, LT_BATCH, seed=SEED)
    step3 = make_train_step(api3, opt3, loss_chunk=LT_CHUNK, donate=True)
    _, aux3, g3 = step3.loss_and_grads(st3.params, pipe3.batch(0, dev))
    ffn = g3["blocks"]["ffn"]
    router_nz = bool((ffn["router"] != 0).any())
    per_expert = [ffn[k][:, :m.n_experts].abs().sum(dim=(0, 2, 3))
                  for k in ("wi", "wg", "wo")]
    dead = [e for e in range(m.n_experts)
            if any(float(t[e]) == 0.0 for t in per_expert)]
    del g3, ffn, per_expert
    torch.cuda.synchronize()
    times, losses = [], []
    for it in range(3):
        t0 = time.perf_counter()
        st3, m3 = step3(st3, pipe3.batch(it, dev))
        losses.append((float(m3["loss"]), float(m3["moe_aux"]),
                       float(m3["grad_norm"])))
        times.append((time.perf_counter() - t0) * 1e3)
    fin = all(np.isfinite(x).all() for x in np.array(losses))
    log(f"    (loss, moe_aux, grad_norm) {losses}; ms/step "
        f"{[round(t, 1) for t in times]}; router gradient nonzero "
        f"{router_nz}; experts with a zero gradient on wi/wg/wo {dead}")
    if not (fin and router_nz and not dead
            and all(a > 0 for _, a, _ in losses)):
        failures.append("(c)")
    del st3, step3
    torch.cuda.empty_cache()
    log(f"    (c) {time.perf_counter() - t_sub:.1f} s")

    # -- (d) the other families -----------------------------------------
    t_sub = time.perf_counter()
    rg = configs.get("recurrentgemma-9b")
    for arch, cfg4 in (("xlstm-125m", configs.get("xlstm-125m")),
                       ("whisper-base", configs.get("whisper-base")),
                       ("recurrentgemma-9b (3 of 38 layers)",
                        dataclasses.replace(rg, n_layers=3))):
        api4 = build(cfg4)
        opt4, st4 = lt_state(api4, gen, dev)
        pipe4 = pipeline_for(cfg4, 512, LT_BATCH, seed=SEED)
        step4 = make_train_step(api4, opt4, loss_chunk=256, donate=True)
        torch.cuda.synchronize()
        rows = []
        for it in range(2):
            t0 = time.perf_counter()
            st4, m4 = step4(st4, pipe4.batch(it, dev))
            rows.append((float(m4["loss"]), float(m4["grad_norm"]),
                         (time.perf_counter() - t0) * 1e3))
        log(f"  (d) {arch}: full width, {LT_BATCH} x 512 tokens: (loss, "
            f"grad_norm, ms) {[tuple(round(x, 4) for x in r) for r in rows]}")
        # the loss only: xLSTM's gradient at the reference's init grows
        # ~10x per 10 positions in both packages and overflows f32 by 512
        # (scripts/lm_train_diagnostics.py); clipping then zeroes the step
        if not all(np.isfinite(r[0]) for r in rows):
            failures.append(f"(d) {arch}")
        del st4, step4
        torch.cuda.empty_cache()

    log(f"    (d) {time.perf_counter() - t_sub:.1f} s")
    # -- (e) checkpoint resume, bit for bit ------------------------------
    t_sub = time.perf_counter()
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        kw = dict(reduced=False, global_batch=LT_BATCH, seq_len=512,
                  loss_chunk=256, seed=SEED, verbose=False, device=dev)
        straight, _ = train_loop("whisper-base", steps=6, **kw)
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            train_loop("whisper-base", steps=3, ckpt_dir=d, ckpt_every=3,
                       **kw)
            resumed, hist_e = train_loop("whisper-base", steps=6, ckpt_dir=d,
                                         ckpt_every=3, **kw)
            t_ck = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(tree.leaves(straight),
                                                     tree.leaves(resumed)))
        log(f"  (e) whisper-base full CONFIG, deterministic algorithms: 6 "
            f"steps straight vs 3 + checkpoint + restore (resumed at step "
            f"{hist_e[0]['step'] - 1}) + 3: {len(tree.leaves(straight))} "
            f"leaves {'equal bit for bit' if same else 'DIFFER'}; the "
            f"checkpointed runs {t_ck:.1f} s")
        if not same or hist_e[0]["step"] != 4:
            failures.append("(e)")
        del straight, resumed
        log(f"    (e) {time.perf_counter() - t_sub:.1f} s")
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    torch.cuda.empty_cache()

    launches = read_launches()
    log(f"  dp_fused launches during phase 14: {launches} (none expected); "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"phase 14 checks failed: {failures}")
    return launches


# ----------------------------------------------------------------- phase 15

LD_ARCH = "qwen3-1.7b"
LD_LAYERS = 4        # of 28 (depth cut; every width kept)
LD_BATCH, LD_SEQ = 2, 512
LD_STEPS = 6
LD_F32_STEPS = 3
LD_CHUNK = 256
LD_TOL = {"bfloat16": 5e-3, "float32": 1e-4}   # a step's loss, 4 ranks vs 1
LD_RESTART_TOL = 2e-2
LD_DEPTH = 2         # dry-run traces at 2 and 3 layers, carried to full
LD_CELLS = ([(LD_ARCH, s, m) for m in (False, True)
             for s in ("train_4k", "prefill_32k", "decode_32k")]
            + [(a, "train_4k", False) for a in
               ("glm4-9b", "qwen2-72b", "granite-3-8b", "llava-next-34b")])


TRACE_PROCS = 6      # dry-run traces in parallel processes (host cores)
TRACE_FIRST = ("prefill_32k", "train_4k")    # the shapes traced first


class Traces:
    """The dry run of each (arch, shape name, multi_pod) cell, traced at
    LD_DEPTH + 1 units and carried to full depth, each in a process of its
    own (``python -m repro_torch.launch.dryrun``, fake CUDA tensors),
    TRACE_PROCS at a time. ``start`` launches them while the phase goes on:
    after its timed steps, which would share the host's cores with the
    tracers otherwise. ``rows`` yields (cell, row, process wall seconds),
    waiting for each; leaving the ``with`` block stops every process and
    removes the rows' files."""

    def __init__(self, cells):
        self.cells, self.started, self.pool = cells, [], None

    def __enter__(self):
        self.out_dir = Path(tempfile.mkdtemp(prefix="lm_dryrun_"))
        return self

    def start(self):
        import concurrent.futures as cf
        import os

        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")

        def one(cell):
            arch, shape, multi = cell
            mesh = "multipod" if multi else "pod"
            out = self.out_dir / f"{arch}-{shape}-{mesh}.json"
            t0 = time.perf_counter()
            p = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", mesh, "--depth",
                 str(LD_DEPTH), "--out", str(out)], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            self.started.append(p)
            text, _ = p.communicate(timeout=1000)
            if out.exists():
                row = json.loads(out.read_text())[0]
            else:
                row = {"cell": f"{arch}/{shape}/{mesh}", "status": "failed",
                       "error": f"exit {p.returncode}: {text[-2000:]}"}
            return row, time.perf_counter() - t0

        self.pool = cf.ThreadPoolExecutor(TRACE_PROCS)
        # the longest traces first (a prefill_32k cell traces for 100-220
        # s, a train_4k one for 40-130 s, the rest for ~25 s on an H100's
        # host): submitted in the listed order, a long cell that starts
        # last sets the phase's end; rows still come in the listed order
        started = {cell: self.pool.submit(one, cell) for cell in sorted(
            self.cells, key=lambda c: TRACE_FIRST.index(c[1])
            if c[1] in TRACE_FIRST else len(TRACE_FIRST))}
        self.futures = {cell: started[cell] for cell in self.cells}

    def rows(self):
        for cell, fut in self.futures.items():
            yield (cell, *fut.result())

    def __exit__(self, *exc):
        import shutil

        if self.pool is not None:
            self.pool.shutdown(wait=False, cancel_futures=True)
        for p in self.started:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(self.out_dir, ignore_errors=True)


def ld_losses(hist):
    return np.asarray([h["loss"] for h in hist])


def phase_lm_dist(dev):
    """LM sharding over torch.distributed (``repro_torch.sharding``): (a)
    qwen3-1.7b at full width cut to LD_LAYERS of 28 layers, 2 x 512 tokens,
    trained by ``launch.train.train_loop`` on 4 ranks of the one card (a
    2 x 2 (data, model) grid of threads, ``rank_threads``) against
    ``train_loop`` on one rank from the same seed: each of LD_STEPS steps'
    loss within LD_TOL (bf16 5e-3, the reference's FSDP check; f32 1e-4);
    f32 runs LD_F32_STEPS steps; the gathered sharded init equal to the
    single rank's bit for bit; every gradient in its parameter's
    placements; the bf16 run's checkpoint at step 3 (written on (2, 2))
    continued on (1, 4) within 2e-2 of (2, 2) going on. (b) the
    LM dry run (``launch.dryrun``) of LD_CELLS on fake CUDA tensors over a
    fake process group of the grid's size, traced at 2 and 3 layers and
    carried to full depth, in processes started after (a)'s timed steps
    and run beside the rest of (a) (``Traces``): per-rank peak, FLOPs, bytes,
    collective bytes by kind, the roofline terms on ``roofline.h100()``
    (each product type at its own peak), trace seconds. (c) ``launch.dryrun.run_cell``: rank 0's program at full
    depth for real on the card for the qwen3 rows under DRYRUN_FIT of the
    card, the fake group standing in for the other ranks (collectives move
    nothing and take no time: the time is the rank's compute alone), real
    max_memory_allocated over the estimate within DRYRUN_BAND; ms against
    bound_time. dp_fused launches (0) under path "lm_dist"."""
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    t_phase = time.perf_counter()
    failures = []
    base = torch.cuda.memory_allocated()
    log(f"[15] LM sharding; {base / 2**30:.3f} GiB left allocated by earlier"
        f" phases")
    with Traces(LD_CELLS) as traces:
        rows = ld_train_and_traces(dev, traces, failures)
    ld_real_runs(dev, rows, failures)
    launches = read_launches()
    log(f"  dp_fused launches during phase 15: {launches} (none expected); "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"phase 15 checks failed: {failures}")
    return launches


def ld_train_and_traces(dev, traces, failures):
    """Phase 15 (a), then (b) from the traces' futures; returns (b)'s rows
    by cell."""
    import dataclasses
    import shutil

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.analysis import roofline
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build
    from repro_torch.sharding import ctx, plans
    from repro_torch.sharding import state as sh_state
    from repro_torch.sharding.threads import ThreadedRanks, rank_threads
    from repro_torch.train import optim, tree
    from repro_torch.train.steps import init_train_state, make_train_step

    # -- (a) sharded training on the card -------------------------------
    t_sub = time.perf_counter()
    full = configs.get(LD_ARCH)
    kw = dict(reduced=False, steps=LD_STEPS, global_batch=LD_BATCH,
              seq_len=LD_SEQ, loss_chunk=LD_CHUNK, log_every=1, seed=SEED,
              device=dev)
    log(f"  (a) train_loop of {LD_ARCH} at full width (d {full.d_model}, "
        f"vocab {full.vocab}, GQA {full.n_heads}/{full.n_kv_heads}), "
        f"{LD_LAYERS} of {full.n_layers} layers, {LD_BATCH} x {LD_SEQ} "
        f"tokens, {LD_STEPS} steps: 4 ranks as a 2 x 2 (data, model) grid "
        f"of threads on the one card against one rank")
    ckpt = Path(tempfile.mkdtemp(prefix="lm_dist_"))
    with ThreadedRanks():
        hist = {}
        for dtype, steps in (("bfloat16", LD_STEPS), ("float32", LD_F32_STEPS)):
            cfg = dataclasses.replace(full, n_layers=LD_LAYERS, dtype=dtype)
            run = dict(kw, steps=steps)
            t0 = time.perf_counter()
            _, one = train_loop(cfg, **run, verbose=False)
            t1 = time.perf_counter()
            if dtype == "bfloat16":   # its step-3 checkpoint is restarted
                run.update(ckpt_dir=str(ckpt / "a"), ckpt_every=3)
            many = rank_threads(lambda r: train_loop(
                cfg, **run, model_axis=2, verbose=False)[1], 4)
            t2 = time.perf_counter()
            a, b = ld_losses(one), ld_losses(many[0])
            hist[dtype] = many[0]
            err = float(np.abs(a - b).max())
            same = all(np.array_equal(ld_losses(h), b) for h in many)
            ok = (err <= LD_TOL[dtype] and same and np.isfinite(b).all())
            log(f"    {dtype}, {steps} steps: one rank "
                f"{a.round(5).tolist()}; 2 x 2 {b.round(5).tolist()}; max "
                f"|d loss| {err:.3e} (limit {LD_TOL[dtype]:g}); ranks agree "
                f"{same}; wall one rank {t1 - t0:.1f} s, 4 ranks "
                f"{t2 - t1:.1f} s; ms/step from step 3: one rank "
                f"{np.mean([h['ms'] for h in one[2:]]):.1f}, 2 x 2 "
                f"{np.mean([h['ms'] for h in many[0][2:]]):.1f} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"(a) {dtype} losses")
        traces.start()       # beside the untimed rest of (a)

        cfg = dataclasses.replace(full, n_layers=LD_LAYERS)
        api = build(cfg)

        def init_and_grads(rank):
            mesh = sh_state.device_mesh(sh_state.local_grid(2), dev)
            plan = plans.make_plan(sh_state.grid(mesh), "train")
            rules = ctx.ActivationRules(mesh=plan.mesh,
                                        batch_axes=plan.batch_axes)
            opt = optim.AdamW(lr=lambda s: 1e-4)
            gen = torch.Generator(device=dev)
            state = init_train_state(api, opt, gen.manual_seed(SEED), dev,
                                     mesh=mesh)
            single = api.init(gen.manual_seed(SEED), device=dev)
            equal = all(torch.equal(sh_state.gather(x), y) for x, y in zip(
                tree.leaves(state.params), tree.leaves(single)))
            del single
            pipe = pipeline_for(cfg, LD_SEQ, LD_BATCH, seed=SEED)
            step = make_train_step(api, opt, loss_chunk=LD_CHUNK)
            with ctx.activation_rules(rules):
                _, _, grads = step.loss_and_grads(
                    state.params, sh_state.distribute_batch(
                        pipe.batch(0, dev), mesh, plan))
            placed = [p for g, p, x in zip(tree.leaves(grads),
                                           tree.flatten_with_paths(
                                               state.params)[1],
                                           tree.leaves(state.params))
                      if tuple(g.placements) != tuple(x.placements)]
            return equal, placed

        t0 = time.perf_counter()
        out = rank_threads(init_and_grads, 4)
        equal = all(e for e, _ in out)
        misplaced = sorted({p for _, ps in out for p in ps})
        log(f"    gathered 2 x 2 init == single rank's, bit for bit: "
            f"{equal}; gradients not in their params' placements: "
            f"{misplaced} ({time.perf_counter() - t0:.1f} s)")
        if not equal or misplaced:
            failures.append("(a) init / placements")

        # the bf16 run's step-3 checkpoint (written on (2, 2)) onto (1, 4)
        t0 = time.perf_counter()
        try:
            shutil.copytree(ckpt / "a" / "step_00000003",
                            ckpt / "b" / "step_00000003")
            moved = rank_threads(lambda r: train_loop(
                cfg, **kw, model_axis=4, verbose=False,
                ckpt_dir=str(ckpt / "b"))[1], 4)[0]
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        a, b = ld_losses(hist["bfloat16"][3:]), ld_losses(moved)
        err = float(np.abs(a - b).max())
        ok = ([h["step"] for h in moved] == [4, 5, 6]
              and err <= LD_RESTART_TOL)
        log(f"    restart at step 3: (2, 2) goes on {a.round(5).tolist()}, "
            f"restored onto (1, 4) {b.round(5).tolist()}; max |d loss| "
            f"{err:.3e} (limit {LD_RESTART_TOL:g}) "
            f"({time.perf_counter() - t0:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("(a) restart")
    assert not dist.is_initialized()
    log(f"    (a) {time.perf_counter() - t_sub:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) the dry run on fake CUDA tensors ----------------------------
    t_sub = time.perf_counter()
    hw = roofline.h100()
    log(f"  (b) LM dry run of rank 0 on fake CUDA tensors, traced at "
        f"{LD_DEPTH} and {LD_DEPTH + 1} layers and carried to full depth, "
        f"{TRACE_PROCS} processes started after (a)'s timed steps; "
        f"roofline on {hw.name}: "
        f"{roofline.peak_for(hw, 'bfloat16'):.3g} FLOP/s bf16, "
        f"{hw.peak_flops:.3g} f32 (the data sheet's dense rates), "
        f"{hw.hbm_bw:.3g} B/s HBM, {hw.ici_bw:.3g} B/s NVLink, "
        f"{hw.dcn_bw:.3g} B/s between pods")
    rows = {}
    for cell, row, wall in traces.rows():
        rows[cell] = row
        if row["status"] != "ok":
            failures.append(f"(b) {row['cell']}")
            log(f"    {row['cell']}: FAILED {row.get('error')}")
            continue
        log(f"    {row['cell']}: peak {row['mem_GiB']:.3f} GiB/rank (args "
            f"{row['arg_bytes'] / 2**30:.3f}), FLOPs {row['flops/chip']:.4e},"
            f" bytes {row['bytes/chip']:.4e}, collectives "
            f"{ {k: f'{v:.4e}' for k, v in row['coll_by_kind'].items()} } "
            f"({row['coll_count']}); FLOPs by type "
            f"{ {k: f'{v:.4e}' for k, v in row['flops_by_dtype'].items()} }"
            f"; t_compute "
            f"{row['t_compute'] * 1e3:.3f} ms, t_memory "
            f"{row['t_memory'] * 1e3:.3f} ms, t_collective "
            f"{(row['t_ici'] + row['t_dcn']) * 1e3:.3f} ms -> "
            f"{row['dominant']}, bound {row['bound_time'] * 1e3:.3f} ms; "
            f"useful {row['useful_ratio']:.3f}; trace {row['trace_s']:.1f} s"
            f" (layers {row['traced_layers']}; process {wall:.1f} s)")
    log(f"    (b) waited {time.perf_counter() - t_sub:.1f} s after (a)")
    return rows


def ld_real_runs(dev, rows, failures):
    """Phase 15 (c): the qwen3 rows of (b) for real."""
    from repro_torch.launch import dryrun, mesh as mesh_mod
    from repro_torch.models.lm_types import ASSIGNED_SHAPES

    shapes = {s.name: s for s in ASSIGNED_SHAPES}
    total = torch.cuda.get_device_properties(0).total_memory

    # -- (c) real runs of rank 0's program -------------------------------
    t_sub = time.perf_counter()
    log(f"  (c) rank 0's program for real on the card at full depth, the "
        f"other ranks a fake process group: collectives move no data, so "
        f"the time is the rank's compute alone; rows under "
        f"{DRYRUN_FIT:.0%} of {total / 2**30:.3f} GiB")
    misses = []
    for (arch, shape, multi), row in rows.items():
        if arch != LD_ARCH or row["status"] != "ok":
            continue
        est = row["mem_GiB"] * 2**30
        if est > DRYRUN_FIT * total:
            log(f"    {row['cell']}: not run, estimate {est / 2**30:.3f} "
                f"GiB")
            continue
        grid = mesh_mod.make_production_mesh(multi_pod=multi)
        out = dryrun.run_cell(arch, shapes[shape], grid, device=dev)
        ratio = out["peak_bytes"] / est
        bound = row["bound_time"] * 1e3
        log(f"    {row['cell']}: max_memory_allocated above the allocation "
            f"before its arguments ({out['base_bytes']} B) "
            f"{out['peak_bytes']} B = {out['peak_bytes'] / 2**30:.3f} GiB, "
            f"estimate {est / 2**30:.3f} GiB, ratio {ratio:.4f} (band "
            f"{DRYRUN_BAND}); {out['ms']:.1f} ms a step (first "
            f"{out['ms_first']:.1f} ms) vs bound_time {bound:.3f} ms "
            f"({bound / out['ms']:.2%} of it; compute alone)")
        if not DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1]:
            misses.append((row["cell"], ratio))
        gc.collect()
        torch.cuda.empty_cache()
    if misses:
        failures.append(f"(c) real / estimate outside {DRYRUN_BAND}: "
                        f"{misses}")
    log(f"    (c) {time.perf_counter() - t_sub:.1f} s")


# ----------------------------------------------------------------- phase 16

LF_ARCH = "granite-moe-1b-a400m"
LF_LAYERS = 4        # of 24 (depth cut; every width kept)
LF_STEPS, LF_F32_STEPS = 6, 3
LF_TOL = LD_TOL      # a step's loss, 4 ranks vs 1 (bf16 5e-3, f32 1e-4)
# (arch, layers kept or None for all): f32, 2 steps of LD_BATCH x LD_SEQ;
# xlstm-125m cut to 2 of its 3 "mmms" periods for the script's time (its
# sLSTM layers loop a token at a time on each rank's thread)
LF_OTHERS = (("xlstm-125m", 8), ("whisper-base", None),
             ("recurrentgemma-9b", 3))
LF_OTHER_STEPS = 2
LF_DECODE = 4        # decode steps after the sharded prefill
LF_SERVE_TOL = 1e-4  # logits, 4 ranks vs 1: of the largest |logit|
# xlstm-125m: the prefill's last logits after 512 positions held at phase
# 13's f32 bound for this model (1e-3 x max|logit|: its recurrences carry
# the rounding of a reordered sum along the sequence; 3.0e-4 read at 12
# layers). Its second step's loss read 4.8e-3 off at 12 layers (whisper's and
# recurrentgemma's gradients agreed bit for bit): AdamW's first update is
# lr x sign(g) per entry, so an entry of g at the level of rounding flips
# its update. So its first step is held by what rounding alone does: a
# one-rank run whose gradient sums the batch's rows in another order
# (``lf_first_step_diff``). Every gradient leaf within LF_GRAD_TOL of its
# largest entry or LF_ORDER_X times that run's difference; every entry
# that the sharded step moved by more than lr / 2 one that rounding can
# move; the second step's loss within 1e-4 or LF_ORDER_X times that
# run's difference. A missing or doubled partial sum is off by 0.5 of a
# leaf's largest entry.
LF_SSM_PREFILL_TOL = 1e-3
LF_GRAD_TOL = 1e-4   # the gloo test's xLSTM bound (RECURRENT_TOL)
LF_ORDER_X = 10
LF_CELLS = tuple((a, s, False)
                 for a in ("granite-moe-1b-a400m", "qwen2-moe-a2.7b",
                           "xlstm-125m", "recurrentgemma-9b", "whisper-base")
                 for s in ("prefill_32k", "train_4k", "decode_32k",
                           "long_500k")
                 if s != "long_500k" or a in ("xlstm-125m",
                                              "recurrentgemma-9b"))
# (d): the rows run for real (each under DRYRUN_FIT of the card), 5 of
# the 9 that fit, for the script's time
LF_REAL = (("granite-moe-1b-a400m", "train_4k"),
           ("granite-moe-1b-a400m", "decode_32k"),
           ("xlstm-125m", "decode_32k"), ("recurrentgemma-9b", "long_500k"),
           ("whisper-base", "train_4k"))


class LfRoutes:
    """Each routing call's expert ids, by caller: "one" for a single rank
    (``moe.route`` with the parameter's router), the rank for a
    thread-rank (its batch rows, with its local router). With ``replay``
    (the "one" calls of a recording), a thread-rank's call routes its rows
    to the experts recorded there, with gates and the aux loss from its
    own router probabilities (``moe.route``'s, on the recorded ids), and
    records the experts its own router would have picked. A rank's rows
    are its data coordinate's (rank = data x ``model`` + model
    coordinate)."""

    def __init__(self, replay=None, model=2):
        self.replay, self.model = replay, model

    def __enter__(self):
        import torch.distributed as dist
        import torch.nn.functional as F

        from repro_torch.models import moe

        self.calls, self.orig = {}, moe.route

        def route(p, cfg, x, router=None, total=lambda t: t, n=None):
            key = "one" if router is None else dist.get_rank()
            mine = self.calls.setdefault(key, [])
            if self.replay is None or key == "one":
                out = self.orig(p, cfg, x, router, total, n)
                mine.append(out[1].detach().cpu())
                return out
            m = cfg.moe
            probs = torch.softmax(x.float() @ router, dim=-1)
            mine.append(torch.topk(probs, m.top_k, dim=-1)[1].cpu())
            row0 = key // self.model * x.shape[0]
            ids = self.replay[len(mine) - 1][row0:row0 + x.shape[0]].to(
                x.device)
            gates = probs.gather(-1, ids)
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            one_hot = F.one_hot(ids, m.n_experts).float().sum(-2)
            frac = total(one_hot.sum((0, 1))) / n / m.top_k
            aux = m.n_experts * torch.sum(
                frac * (total(probs.sum((0, 1))) / n))
            return gates, ids, aux

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self.orig

    def flips(self, per_step, one=None):
        """Token decisions (a token's k experts in a layer's routing call)
        that differ between ``one`` (the single rank's calls, by default
        this recording's) and the ranks of model coordinate 0, summed per
        step of ``per_step`` calls."""
        one = self.calls.get("one", []) if one is None else one
        out = []
        for s in range(len(one) // per_step):
            n = 0
            for i in range(s * per_step, (s + 1) * per_step):
                for row in range(one[i].shape[0]):
                    mine = self.calls[row * self.model][i][0]
                    n += int((one[i][row].sort(-1).values
                              != mine.sort(-1).values).any(-1).sum())
            out.append(n)
        return out


def lf_other(arch, layers, dev, threaded_ranks):
    """(b) for one family: f32, LF_OTHER_STEPS steps of LD_BATCH x LD_SEQ
    on one rank and on 4 thread-ranks (2 x 2), then prefill (the forward's
    last logits) and LF_DECODE decode steps on both. Returns a dict of
    the losses and the serve errors."""
    import contextlib
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.launch import dryrun
    from repro_torch.models import build, encdec
    from repro_torch.sharding import ctx, plans
    from repro_torch.sharding import state as sh_state
    from repro_torch.sharding.threads import rank_threads
    from repro_torch.train import optim, tree
    from repro_torch.train.steps import (TrainState, init_train_state,
                                         make_train_step)

    cfg = dataclasses.replace(configs.get(arch), dtype="float32")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    api = build(cfg)
    opt = optim.AdamW(lr=lambda s: 1e-4)
    pipe = pipeline_for(cfg, LD_SEQ, LD_BATCH, seed=SEED)
    prompt = pipe.batch(LF_OTHER_STEPS, dev)
    nxt = torch.randint(0, cfg.vocab, (LF_DECODE, LD_BATCH, 1),
                        generator=torch.Generator().manual_seed(SEED)).to(dev)
    max_len = LD_SEQ + LF_DECODE

    def rescaled(params):
        # the reference's sLSTM init is chaotic at head dim 192 (phase 13):
        # r_zifo at std 1/sqrt(head dim), in place, on either layout
        if cfg.family == "ssm":
            dh = cfg.d_model // cfg.n_heads
            for name, block in params["periods"].items():
                if name.endswith("_s"):
                    block["r_zifo"].mul_((4 / dh) ** 0.5)
        return params

    def serve(params, rows, rules):
        kw = {"tokens": rows(prompt["tokens"])}
        if "frames" in prompt:
            kw["frames"] = rows(prompt["frames"])
        with torch.no_grad():
            with ctx.activation_rules(rules[0]):
                logits = [api.forward(params, **kw)[0][:, -1]]
            with ctx.activation_rules(rules[1]):
                if cfg.family == "encdec":
                    cache = encdec.init_cache(params, cfg, LD_BATCH, max_len,
                                              kw["frames"])
                else:
                    cache = rules[2](api.init_cache(params, LD_BATCH,
                                                    max_len))
                for t in nxt:
                    out, cache = api.decode_step(params, rows(t), cache)
                    logits.append(out)
        return [sh_state.gather(x) for x in logits]

    witness = cfg.family == "ssm"

    def first_step(step, state, b, by_row, keep):
        """``step(state, b)`` written out, its gradient taken a batch row
        at a time and averaged when ``by_row`` (the same mean loss, the
        batch's sum in another order): (state, metrics, (every gradient
        leaf, every param after the step), gathered, or None unless
        ``keep``)."""
        if by_row:
            parts = [step.loss_and_grads(state.params, {
                k: v[i:i + 1] for k, v in b.items()}) for i in range(LD_BATCH)]
            loss = sum(x[0] for x in parts) / LD_BATCH
            grads = tree.unflatten(state.params, [
                sum(g) / LD_BATCH for g in zip(*(tree.leaves(x[2])
                                                 for x in parts))])
        else:
            loss, _, grads = step.loss_and_grads(state.params, b)
        g1 = [sh_state.gather(g).clone() for g in tree.leaves(grads)]
        params, moments, gnorm = opt.update_(grads, state.opt, state.params)
        p1 = [sh_state.gather(x).clone() for x in tree.leaves(params)]
        return (TrainState(params=params, opt=moments, step=state.step + 1),
                {"loss": loss, "grad_norm": gnorm},
                (g1, p1) if keep else None)

    def run(mesh=None, by_row=False, keep=True):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        state = init_train_state(api, opt, gen, dev, mesh=mesh)
        rescaled(state.params)
        step = make_train_step(api, opt, loss_chunk=LD_CHUNK, donate=True)
        ident = lambda t: t
        rows, rules = ident, (None, None, ident)
        if mesh is not None:
            plan = plans.make_plan(sh_state.grid(mesh), "train")
            train_rules = ctx.ActivationRules(mesh=plan.mesh,
                                              batch_axes=plan.batch_axes)
        losses, first = [], None
        with (ctx.activation_rules(train_rules) if mesh is not None
              else contextlib.nullcontext()):
            for it in range(LF_OTHER_STEPS):
                b = pipe.batch(it, dev)
                if mesh is not None:
                    b = sh_state.distribute_batch(b, mesh, plan)
                if it == 0 and witness:
                    state, m, first = first_step(step, state, b, by_row, keep)
                else:
                    state, m = step(state, b)
                losses.append((float(m["loss"]), float(m["grad_norm"])))
        del state
        if by_row:
            return losses, None, first
        gen.manual_seed(SEED)
        if mesh is None:
            params = rescaled(api.init(gen, device=dev))
        else:
            splan = plans.make_plan(sh_state.grid(mesh), "serve")
            specs = plans.param_shardings(splan, api.init(
                torch.Generator(), device="meta"))
            params = api.init(gen, device=dev,
                              place=sh_state.layer_placer(mesh, specs))
            params = rescaled(sh_state.distribute(params, mesh, specs))
            base = ctx.ActivationRules(mesh=splan.mesh,
                                       batch_axes=splan.batch_axes)
            rules = (base, dataclasses.replace(base, shard_seq=True),
                     lambda c: tree.unflatten(c, [
                         sh_state.place(x, mesh, s) for x, s in zip(
                             tree.leaves(c), dryrun.cache_shardings(
                                 splan, cfg, c, LD_BATCH, max_len))]))
            rows = lambda t: sh_state.place(t, mesh, plans.batch_spec(
                splan, t.shape[0], t.dim() - 1))
        return losses, serve(params, rows, rules), first

    t0 = time.perf_counter()
    one = run()
    t1 = time.perf_counter()
    with threaded_ranks():
        many = rank_threads(lambda r: run(sh_state.device_mesh(
            sh_state.local_grid(2), dev), keep=r == 0), 4)[0]
    t2 = time.perf_counter()
    scale = max(float(x.abs().max()) for x in one[1])
    errs = [float((a - b).abs().max()) for a, b in zip(many[1], one[1])]
    out = {"cfg": cfg, "one": one[0], "many": many[0], "scale": scale,
           "errs": errs, "s_one": t1 - t0, "s_many": t2 - t1}
    if witness:
        order = run(by_row=True)
        out["order"] = order[0]
        out["witness"] = {k: lf_first_step_diff(one[2], x[2], opt.lr(1))
                          for k, x in (("many", many), ("order", order))}
    return out


def lf_witness(arch, a, r, lims):
    """(b)'s hold of xlstm-125m's steps (LF_SSM_PREFILL_TOL's comment):
    prints the first step's gradient and update against one rank, for the
    2 x 2 run and for the one-rank run in another order; returns (each
    step's loss limit, whether the first step's checks held)."""
    order = np.asarray(r["order"]).T[0]
    d_order = np.abs(a - order)
    lims = [lims[0]] + [max(lim, LF_ORDER_X * d)
                        for lim, d in zip(lims[1:], d_order[1:])]
    w = {k: np.asarray(v) for k, v in r["witness"].items()}
    bound = np.maximum(LF_GRAD_TOL, LF_ORDER_X * w["order"][:, 0])
    over = int((w["many"][:, 0] > bound).sum())
    for k in ("many", "order"):
        e, flips, moved, unexplained, n = w[k].T
        who = "2 x 2" if k == "many" else "one rank by rows"
        log(f"      {arch} first step, {who} vs one rank: gradient max |d| / max|g| over {len(e)} leaves "
            f"{e.max():.3e} (median {np.median(e):.3e}); entries whose "
            f"gradient sign differs {int(flips.sum())}, whose param moved "
            f"more than lr / 2 {int(moved.sum())}, of them with |g| above "
            f"twice the leaf's difference {int(unexplained.sum())}, of "
            f"{int(n.sum())}; step losses one rank by rows "
            f"{order.round(6).tolist()} (|d| "
            f"{[f'{x:.3e}' for x in d_order]})")
    log(f"      leaves over max({LF_GRAD_TOL:g}, {LF_ORDER_X} x the by-rows "
        f"difference): {over}")
    return lims, over == 0 and int(w["many"][:, 3].sum()) == 0


def lf_first_step_diff(one, other, lr):
    """Per leaf, another run's first step against one rank's: the
    gradient's max |difference| over the leaf's max|g|, the entries whose
    gradient sign differs, and the entries whose param after the step
    differs by more than lr / 2, and of them those whose one-rank |g|
    exceeds twice the leaf's max |gradient difference|. AdamW's first
    update is lr x g / (|g| + eps) per entry (the moments are g and g^2):
    two updates of it lr / 2 apart need gradients of opposite sign or at
    the eps level, and either way the smaller |g| is below their
    difference and the larger below twice it; a moved entry of the second
    kind is one that rounding did not move."""
    rows = []
    for g0, p0, g, p in zip(*one, *other):
        diff = (g - g0).abs()
        err = float(diff.max())
        moved = (p - p0).abs() > lr / 2
        rows.append((err / max(float(g0.abs().max()), 1e-30),
                     int((torch.sign(g) != torch.sign(g0)).sum()),
                     int(moved.sum()),
                     int((moved & (g0.abs() > 2 * err)).sum()), g0.numel()))
    return rows


def phase_lm_dist_families(dev):
    """LM sharding of the other four families (``repro_torch.sharding``,
    expert parallelism for MoE): (a) granite-moe-1b-a400m at full width
    (d 1024, 32 experts top-8, vocab 49,155) cut to LF_LAYERS of 24
    layers, 2 x 512 tokens, trained by ``launch.train.train_loop`` on 4
    ranks of the one card (threads, a 2 x 2 (data, model) grid) against one
    rank from the same seed: f32 LF_F32_STEPS steps within 1e-4, no
    routing decision flipped; bf16 LF_STEPS steps within 5e-3 with the
    2 x 2 run routed as the single rank's (``LfRoutes``' replay: bf16
    router near-ties flip decisions between free runs from the first step,
    whose counts are printed); the gathered init bit for bit, every
    gradient in its parameter's placements, each rank's 16 of the 32
    experts, moe_aux > 0, a gradient on every expert of every layer.
    (b) xlstm-125m, whisper-base (1,500 stub frames) and recurrentgemma-9b
    at full width (LF_OTHERS' depths), f32: LF_OTHER_STEPS steps of 2 x 512 on
    the 2 x 2 grid within 1e-4 of one rank, then sharded prefill (the
    forward's last logits) and LF_DECODE decode steps within
    LF_SERVE_TOL x max|logit| (xlstm: its first step's gradient and
    update held against rounding's, ``lf_witness``, and the prefill at
    LF_SSM_PREFILL_TOL; why at the constant).
    (c) the dry run of LF_CELLS on fake CUDA tensors over a fake group of
    256 (16 x 16), traced at LD_DEPTH and LD_DEPTH + 1 units and carried
    to full depth (``Traces``), started after (a)'s timed steps and run
    beside the rest of (a) and (b): peak, args, FLOPs by type, bytes, collective
    bytes by kind, the three terms at the H100's peaks, trace seconds.
    (d) LF_REAL rows for real at full depth, each under DRYRUN_FIT of the
    card, the fake group standing in for the other ranks: real peak over
    the estimate within DRYRUN_BAND, ms against bound_time. dp_fused
    launches (0) under path "lm_dist_families"."""
    import torch.distributed as dist

    from repro_torch.analysis import roofline
    from repro_torch.launch import dryrun, mesh as mesh_mod
    from repro_torch.models.lm_types import ASSIGNED_SHAPES
    from repro_torch.sharding.threads import ThreadedRanks

    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    t_phase = time.perf_counter()
    failures = []
    log(f"[16] LM sharding, the MoE, ssm, hybrid and encdec families; "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB left allocated")
    with Traces(LF_CELLS) as traces:
        failures += lf_train_moe(dev, traces)
        gc.collect()
        torch.cuda.empty_cache()

        # -- (b) the other three families -----------------------------
        t_sub = time.perf_counter()
        log(f"  (b) f32, {LF_OTHER_STEPS} steps of {LD_BATCH} x {LD_SEQ} "
            f"tokens, then prefill + {LF_DECODE} decode steps: 4 ranks "
            f"(2 x 2) against one rank")
        for arch, layers in LF_OTHERS:
            r = lf_other(arch, layers, dev, ThreadedRanks)
            cfg = r["cfg"]
            (a, ga), (b, gb) = (np.asarray(r[k]).T for k in ("one", "many"))
            ssm = cfg.family == "ssm"
            err = np.abs(a - b)
            lims = [LF_TOL["float32"]] * len(a)
            if ssm:
                lims, wit = lf_witness(arch, a, r, lims)
            tols = [(LF_SSM_PREFILL_TOL if ssm else LF_SERVE_TOL)
                    * r["scale"]] + [LF_SERVE_TOL * r["scale"]] * LF_DECODE
            ok = (np.isfinite(b).all() and all(err <= lims)
                  and all(e <= t for e, t in zip(r["errs"], tols))
                  and (not ssm or wit))
            log(f"    {arch} ({cfg.n_layers} layers, d {cfg.d_model}): "
                f"losses one rank {a.round(6).tolist()}, 2 x 2 "
                f"{b.round(6).tolist()}, |d loss| "
                f"{[f'{e:.3e}' for e in err]} (limits "
                f"{[f'{x:.3e}' for x in lims]}); grad norms one rank "
                f"{[f'{g:.4e}' for g in ga]}, 2 x 2 "
                f"{[f'{g:.4e}' for g in gb]}; prefill + decode logits max "
                f"|d| {[f'{e:.3e}' for e in r['errs']]} of max|logit| "
                f"{r['scale']:.3f} (limits "
                f"{[f'{t:.3e}' for t in tols]}); wall one rank "
                f"{r['s_one']:.1f} s, 4 ranks {r['s_many']:.1f} s (beside "
                f"the tracers) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"(b) {arch}")
            del r
            gc.collect()
            torch.cuda.empty_cache()
        assert not dist.is_initialized()
        log(f"    (b) {time.perf_counter() - t_sub:.1f} s")

        # -- (c) the dry run ------------------------------------------
        t_sub = time.perf_counter()
        hw = roofline.h100()
        rows = {}
        for cell, row, wall in traces.rows():
            rows[cell] = row
            if row["status"] != "ok":
                failures.append(f"(c) {row['cell']}")
                log(f"    {row['cell']}: FAILED {row.get('error')}")
                continue
            log(f"    {row['cell']}: peak {row['mem_GiB']:.3f} GiB/rank "
                f"(args {row['arg_bytes'] / 2**30:.3f}), FLOPs "
                f"{row['flops/chip']:.4e} by type "
                f"{ {k: f'{v:.4e}' for k, v in row['flops_by_dtype'].items()} }"
                f", bytes {row['bytes/chip']:.4e}, collectives "
                f"{ {k: f'{v:.4e}' for k, v in row['coll_by_kind'].items()} } "
                f"({row['coll_count']}); t_compute "
                f"{row['t_compute'] * 1e3:.3f} ms, t_memory "
                f"{row['t_memory'] * 1e3:.3f} ms, t_collective "
                f"{(row['t_ici'] + row['t_dcn']) * 1e3:.3f} ms -> "
                f"{row['dominant']}, bound {row['bound_time'] * 1e3:.3f} "
                f"ms; trace {row['trace_s']:.1f} s (layers "
                f"{row['traced_layers']}; process {wall:.1f} s)")
        log(f"  (c) dry run of {len(LF_CELLS)} cells on 16 x 16, "
            f"{TRACE_PROCS} processes beside (b) and (a)'s untimed checks, on "
            f"{hw.name}: {roofline.peak_for(hw, 'bfloat16'):.3g} FLOP/s "
            f"bf16, {hw.peak_flops:.3g} f32, {hw.hbm_bw:.3g} B/s HBM, "
            f"{hw.ici_bw:.3g} B/s NVLink; waited "
            f"{time.perf_counter() - t_sub:.1f} s after (b)")

    # -- (d) real runs of rank 0's program ------------------------------
    t_sub = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    shapes = {s.name: s for s in ASSIGNED_SHAPES}
    grid = mesh_mod.make_production_mesh(multi_pod=False)
    log(f"  (d) rank 0's program for real on the card at full depth, the "
        f"other ranks a fake process group (the time is the rank's compute "
        f"alone); rows under {DRYRUN_FIT:.0%} of {total / 2**30:.3f} GiB")
    misses = []
    for arch, shape in LF_REAL:
        row = rows[(arch, shape, False)]
        if row["status"] != "ok":
            continue
        est = row["mem_GiB"] * 2**30
        if est > DRYRUN_FIT * total:
            log(f"    {row['cell']}: not run, estimate {est / 2**30:.3f} "
                f"GiB")
            continue
        gc.collect()
        torch.cuda.empty_cache()
        out = dryrun.run_cell(arch, shapes[shape], grid, device=dev)
        ratio = out["peak_bytes"] / est
        bound = row["bound_time"] * 1e3
        log(f"    {row['cell']}: max_memory_allocated above the allocation "
            f"before its arguments ({out['base_bytes']} B) "
            f"{out['peak_bytes']} B = {out['peak_bytes'] / 2**30:.3f} GiB, "
            f"estimate {est / 2**30:.3f} GiB, ratio {ratio:.4f} (band "
            f"{DRYRUN_BAND}); {out['ms']:.1f} ms a step (first "
            f"{out['ms_first']:.1f} ms) vs bound_time {bound:.3f} ms "
            f"({bound / out['ms']:.2%} of it; compute alone)")
        if not DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1]:
            misses.append((row["cell"], round(ratio, 4)))
    if misses:
        failures.append(f"(d) real / estimate outside {DRYRUN_BAND}: "
                        f"{misses}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"    (d) {time.perf_counter() - t_sub:.1f} s")
    launches = read_launches()
    log(f"  dp_fused launches during phase 16: {launches} (none expected); "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"phase 16 checks failed: {failures}")
    return launches


def lf_train_moe(dev, traces):
    """(a) of phase 16, which starts ``traces`` after its timed steps;
    returns its failures."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build, moe
    from repro_torch.sharding import ctx, plans
    from repro_torch.sharding import state as sh_state
    from repro_torch.sharding.threads import ThreadedRanks, rank_threads
    from repro_torch.train import optim, tree
    from repro_torch.train.steps import init_train_state, make_train_step

    failures = []
    t_sub = time.perf_counter()
    full = configs.get(LF_ARCH)
    kw = dict(reduced=False, global_batch=LD_BATCH, seq_len=LD_SEQ,
              loss_chunk=LD_CHUNK, log_every=1, seed=SEED, device=dev,
              verbose=False)
    log(f"  (a) train_loop of {LF_ARCH} at full width (d {full.d_model}, "
        f"{full.moe.n_experts} experts top-{full.moe.top_k}, vocab "
        f"{full.vocab}), {LF_LAYERS} of {full.n_layers} layers, {LD_BATCH} "
        f"x {LD_SEQ} tokens: 4 ranks as a 2 x 2 (data, model) grid of "
        f"threads on the one card (experts over model) against one rank")
    # routing calls a step: a forward and remat's recompute per layer
    per_step = 2 * LF_LAYERS
    decisions = per_step * LD_BATCH * LD_SEQ
    ms = lambda h: np.mean([x["ms"] for x in h[2:]])
    with ThreadedRanks():
        for dtype, steps in (("float32", LF_F32_STEPS),
                             ("bfloat16", LF_STEPS)):
            cfg = dataclasses.replace(full, n_layers=LF_LAYERS, dtype=dtype)
            sharded = lambda r: train_loop(cfg, **kw, steps=steps,
                                           model_axis=2)[1]
            with LfRoutes() as routes:
                t0 = time.perf_counter()
                _, one = train_loop(cfg, **kw, steps=steps)
                t1 = time.perf_counter()
                many = rank_threads(sharded, 4)
                t2 = time.perf_counter()
            a, b = ld_losses(one), ld_losses(many[0])
            flips = routes.flips(per_step)
            same = all(np.array_equal(ld_losses(h), b) for h in many)
            log(f"    {dtype}, {steps} steps: one rank "
                f"{a.round(5).tolist()}; 2 x 2 {b.round(5).tolist()}; "
                f"|d loss| {[f'{x:.3e}' for x in np.abs(a - b)]}; routing "
                f"decisions (token, layer, forward and recompute) that "
                f"differ between the runs, by step: {flips} of "
                f"{decisions}; ranks agree {same}; wall one rank "
                f"{t1 - t0:.1f} s, 4 ranks {t2 - t1:.1f} s; ms/step from "
                f"step 3: one rank {ms(one):.1f}, 2 x 2 {ms(many[0]):.1f}")
            if dtype == "bfloat16":
                # held with the single rank's routing replayed
                with LfRoutes(replay=routes.calls["one"]) as replayed:
                    t0 = time.perf_counter()
                    many = rank_threads(sharded, 4)
                    t1 = time.perf_counter()
                b = ld_losses(many[0])
                same = all(np.array_equal(ld_losses(h), b) for h in many)
                log(f"    {dtype}, {steps} steps, the 2 x 2 run routed as "
                    f"the single rank's: {b.round(5).tolist()}; decisions "
                    f"its own router would have taken otherwise, by step: "
                    f"{replayed.flips(per_step, routes.calls['one'])} of "
                    f"{decisions}; ranks agree {same}; wall 4 ranks "
                    f"{t1 - t0:.1f} s")
            elif any(flips):
                log("    (f32 routing flipped: not a near-tie of bf16)")
            d = np.abs(a - b)
            ok = (same and np.isfinite(b).all() and all(d <= LF_TOL[dtype])
                  and (dtype == "bfloat16" or not any(flips)))
            log(f"    {dtype}: |d loss| {[f'{x:.3e}' for x in d]} (limit "
                f"{LF_TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"(a) {dtype} losses")
        traces.start()       # beside the untimed rest of (a) and (b)

        cfg = dataclasses.replace(full, n_layers=LF_LAYERS)
        api = build(cfg)

        def init_and_grads(rank):
            mesh = sh_state.device_mesh(sh_state.local_grid(2), dev)
            plan = plans.make_plan(sh_state.grid(mesh), "train")
            rules = ctx.ActivationRules(mesh=plan.mesh,
                                        batch_axes=plan.batch_axes)
            opt = optim.AdamW(lr=lambda s: 1e-4)
            gen = torch.Generator(device=dev)
            state = init_train_state(api, opt, gen.manual_seed(SEED), dev,
                                     mesh=mesh)
            single = api.init(gen.manual_seed(SEED), device=dev)
            equal = all(torch.equal(sh_state.gather(x), y) for x, y in zip(
                tree.leaves(state.params), tree.leaves(single)))
            del single
            pipe = pipeline_for(cfg, LD_SEQ, LD_BATCH, seed=SEED)
            step = make_train_step(api, opt, loss_chunk=LD_CHUNK)
            with ctx.activation_rules(rules):
                _, aux, grads = step.loss_and_grads(
                    state.params, sh_state.distribute_batch(
                        pipe.batch(0, dev), mesh, plan))
            paths = tree.flatten_with_paths(state.params)[1]
            misplaced = [p for g, x, p in zip(tree.leaves(grads),
                                              tree.leaves(state.params),
                                              paths)
                         if tuple(g.placements) != tuple(x.placements)]
            ffn = state.params["blocks"]["ffn"]
            local = [ffn[k].to_local().shape[1] for k in ("wi", "wg", "wo")]
            dead = []
            for k in ("wi", "wg", "wo"):
                g = sh_state.gather(grads["blocks"]["ffn"][k])
                alive = g.flatten(2).abs().amax(-1)[:, :cfg.moe.n_experts]
                dead += [(k, int(i), int(j))
                         for i, j in (alive == 0).nonzero().tolist()]
            return (equal, misplaced, local, float(aux["moe_aux"]), dead)

        t0 = time.perf_counter()
        out = rank_threads(init_and_grads, 4)
    equal = all(o[0] for o in out)
    misplaced = sorted({p for o in out for p in o[1]})
    local = [o[2] for o in out]
    aux = out[0][3]
    dead = out[0][4]
    want = moe.padded_experts(cfg) // 2
    ok = (equal and not misplaced and aux > 0 and not dead
          and all(x == [want] * 3 for x in local))
    log(f"    gathered 2 x 2 init == single rank's, bit for bit: {equal}; "
        f"gradients not in their params' placements: {misplaced}; each "
        f"rank's experts in wi/wg/wo {local} (of {moe.padded_experts(cfg)}"
        f"); moe_aux {aux:.6f}; (weight, layer, expert) without a gradient:"
        f" {dead} ({time.perf_counter() - t0:.1f} s) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("(a) init / placements / experts")
    assert not dist.is_initialized()
    log(f"    (a) {time.perf_counter() - t_sub:.1f} s")
    return failures


def main(argv) -> int:
    # ``--phases 10c`` (or ``10``, or ``10,10c``): phases 1 and 3, then
    # phase 10 (a)-(b) or (c) alone, for a run on several cards; no result
    # line, as it is not the whole run
    only = None
    if (len(argv) == 2 and argv[0] == "--phases"
            and set(argv[1].split(",")) <= {"10", "10c"}):
        only = set(argv[1].split(","))
    elif argv:
        print(f"chip_smoke: usage: chip_smoke.py [--phases 10,10c]; got "
              f"{argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.dp_model import init_dp_params, tabulate_model
    from repro_torch.core.types import COPPER_DP, WATER_DP
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")     # also switches TF32 off
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    t_start = time.perf_counter()

    def done(phase):
        log(f"  -- phases up to {phase} done at "
            f"{time.perf_counter() - t_start:.1f} s")

    phase_card_and_build()
    params = tabulate_model(
        init_dp_params(torch.Generator().manual_seed(SEED), COPPER_DP,
                       device=dev), COPPER_DP, "cheb")
    if only is not None:
        _, scan = phase_main_path(COPPER_DP, params, dev)
        if "10" in only:
            phase_distributed(COPPER_DP, params, dev, scan)
        if "10c" in only:
            phase_dist_cards(COPPER_DP, params, dev, scan)
        log(f"phases 1, 3, {sorted(only)} passed in "
            f"{time.perf_counter() - t_start:.1f} s (no result line: not "
            f"the whole run)")
        return 0
    kernels = phase_kernels(COPPER_DP, WATER_DP, params, dev)
    launches, scan = phase_main_path(COPPER_DP, params, dev)
    by_path = {"scan": launches}
    phase_rungs(COPPER_DP, params, dev)
    by_path["outer"] = phase_outer(COPPER_DP, params, dev, scan)
    done(5)
    by_path["water"] = phase_water(WATER_DP, dev)
    phase_quintic(COPPER_DP, params, dev)
    phase_npt(COPPER_DP, params, dev)
    phase_lj(dev)
    done(9)
    _, dist_launches = phase_distributed(COPPER_DP, params, dev, scan)
    by_path.update(dist_launches)
    by_path.update(phase_dist_cards(COPPER_DP, params, dev, scan))
    by_path["train_check"] = phase_train(COPPER_DP, dev)
    done(11)
    _, by_path["dryrun"] = phase_dryrun(dev)
    done(12)
    by_path["lm_serve"] = phase_lm_serve(dev)
    by_path["lm_train"] = phase_lm_train(dev)
    by_path["lm_dist"] = phase_lm_dist(dev)
    by_path["lm_dist_families"] = phase_lm_dist_families(dev)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    # launches: the main path's (phase 3); each path's run beside it
    print(json.dumps({"kernels": [
        dict(kernels[name], launches=launches[name],
             launches_by_path={p: c[name] for p, c in by_path.items()})
        for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
