#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

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
     reports the main path's shape.
  3. the main path: ``Simulation.run`` of the paper's copper protocol (NVE,
     330 K, 99 steps, rebuild every 50 with a 2 A skin) on fcc_copper(20,20,20)
     = 32,000 atoms at full COPPER_DP width, impl="cheb_pallas", engine
     "scan", weights random from a seed and Chebyshev-tabulated. Both kernels
     must launch >= 100 times (1 fwd + 1 bwd per force evaluation), the
     thermo must be finite and |d etot| per atom <= 1e-4 eV. A profile of
     three force evaluations splits the device time by kernel.
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
     phase 3's velocities: atoms constant, drift <= 1e-4 eV/atom, thermo
     rows against phase 3's at rtol 1e-5; (b) 4 slabs x 2 model shards,
     the kernels on neighbor-slot slices: the same one-step parity and 10
     steps against (a). Each kernel held against ref.py at the shape each
     path gives it; launch counts per path, us/step/atom, peak memory and
     the sweeps' share of the device time (torch.profiler).
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

Prints the kernels' JSON line (``launches`` of the main path, phase 3, and
``launches_by_path`` of every path), then ``{"ok": true, "device": {...}}``
last.
TF32 is off for matmuls and cuDNN throughout: every product is FP32.
"""

from __future__ import annotations

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
    return main


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
    log(f"    launches {launches}")
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
    # forces are scattered with index_add_ (atomics, order varies by run);
    # the rungs also differ in f32 summation order: hence the tolerances
    if not (torch.isfinite(f_k).all() and f_k.shape == pos_t.shape):
        raise AssertionError("bad forces from cheb_pallas")
    if de > 1e-5 * abs(float(e_c)) or df > 5e-5:
        raise AssertionError("cheb_pallas disagrees with cheb")


# ------------------------------------------------------- phases 5-9 helpers

def reset_launches():
    from repro_torch.kernels.dp_fused import ops
    ops.fwd_launches = 0
    ops.bwd_launches = 0


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
    index_add_'s atomics, so the slice's tolerances apply (thermo rtol
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
        # reference's tests), forces scatter with atomics
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


def sweep_share(step, params, st, boxt):
    """Device time under the halo/reverse/migration ranges over all device
    time of two steps, from torch.profiler (all threads)."""
    from torch.profiler import ProfilerActivity, profile

    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        log("    sweep share: this torch cannot profile worker threads; "
            "not measured")
        return None
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
    if not total or not ranges:
        log("    sweep share: the profiler recorded no device time under the "
            "ranges; not measured")
        return None
    share = sum(ranges.values()) / total
    log(f"    profile of 2 steps: {wall:.3f} ms wall a step, {total:.3f} ms "
        f"of kernel time a step over all ranks ({total / wall:.1%} of the "
        f"wall); under ranges: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in sorted(ranges.items()))
        + f"; sweep share of the kernel time {share:.2%}")
    log_kernels(prof, 2, "two distributed steps", top=8)
    return share


def dist_kernel_case(label, args, dev):
    s, env, c, lo, hi = args
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return kernel_case(label, s, env, c, lo, hi, dev, gen, sample=True,
                       chunked_lib=False)


def phase_distributed(cfg, params, dev, scan):
    """Copper at full COPPER_DP width in bricks on the one card (LocalComm:
    one thread and stream per rank), cheb_pallas, NVE. (a) 2x2x2 bricks:
    one step against the single-process port, then the 99-step protocol
    from phase 3's velocities, held against phase 3's thermo rows at rtol
    1e-5 (atoms constant, drift <= 1e-4 eV/atom); (b) 4 slabs x 2 model
    shards, the fused kernels on neighbor-slot slices: the same one-step
    parity, a few timed steps. Each kernel is held against ref.py at each
    path's shape."""
    from repro_torch.core import dp_model
    from repro_torch.md import domain, integrator, lattice, neighbors, stepper

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
    prog = domain.make_outer_md_program(
        cfg, spec, lc, (lattice.MASS["Cu"],), 1.0, decomp="slots",
        neighbor="cells", potential=pot)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    st = prog.prime(params, domain.shard_state(state, lc, dev), box_t)
    torch.cuda.synchronize()
    t_prime = time.perf_counter() - t0
    pe, ke, nat = [], [], []
    t0 = time.perf_counter()
    for n_segs, seg_len in stepper.chunk_schedule(99, 50, 8):
        st, _, _, _, th = prog.run(st, params, n_segs, seg_len, (), box_t)
        thermo = stepper.fetch_thermo(th)
        domain.check_segment_thermo(thermo)
        pe.append(thermo["pe"].reshape(-1))
        ke.append(thermo["ke"].reshape(-1))
        nat.append(thermo["n_atoms"].reshape(-1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["distributed_a"] = read_launches()
    pe, ke, nat = (np.concatenate(x).astype(np.float64) for x in (pe, ke, nat))
    n = len(pos)
    etot = pe + ke
    drift = float(etot.max() - etot.min()) / n
    log(f"[10a] 99 steps (2 segments, migration at each start): "
        f"{wall * 1e6 / (99 * n):.6f} us/step/atom (loop {wall:.3f} s; "
        f"initial force evaluation {t_prime:.3f} s); launches "
        f"{launches['distributed_a']}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"    atoms per step {int(nat.min())}..{int(nat.max())}; |d etot| "
        f"per atom {drift:.3e} eV (limit 1e-4)")
    worst = 0.0
    for row in scan.thermo:
        i = row["step"] - 1
        got = {"pe": pe[i], "ke": ke[i], "etot": etot[i]}
        log(f"    step {row['step']}: pe {pe[i]:.6f} ke {ke[i]:.6f} etot "
            f"{etot[i]:.6f} (scan: {row['pe']:.6f} {row['ke']:.6f} "
            f"{row['etot']:.6f})")
        for k, v in got.items():
            worst = max(worst, abs(v - row[k]) / max(abs(row[k]), 1e-30))
    log(f"    against phase 3's scan run: thermo max rel diff {worst:.3e} "
        f"(rtol 1e-5)")
    if not (np.all(nat == n) and drift <= 1e-4 and worst <= 1e-5):
        raise AssertionError("distributed (a) protocol failed")
    for name, count in launches["distributed_a"].items():
        if count != 8 * 100:
            raise AssertionError(f"(a) {name} launched {count} times, not "
                                 f"8 ranks x 100 force evaluations")
    sweep_share(prog.step, params, st, box_t)
    del st, prog
    torch.cuda.empty_cache()

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
    step = domain.make_distributed_md_step(
        cfg, spec, lc, (lattice.MASS["Cu"],), 1.0, decomp="slots",
        neighbor="cells", potential=pot)
    st = step.prime(params, domain.shard_state(state, lc, dev), box_t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (st, _, _, _), th = step.run(params, st, 10, (), box_t)
    thermo = stepper.fetch_thermo(th)
    domain.check_segment_thermo(thermo)
    wall = time.perf_counter() - t0
    log(f"[10b] 10 steps: {wall * 1e6 / (10 * n):.6f} us/step/atom; pe "
        f"{thermo['pe'][-1]:.6f} (10a at step 10: {pe[9]:.6f}); "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if abs(thermo["pe"][-1] - pe[9]) > 1e-5 * abs(pe[9]):
        raise AssertionError("(b) trajectory disagrees with (a)")
    sweep_share(step, params, st, box_t)
    return kernels, launches


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


def train_kind(key):
    low = key.lower()
    for kind, frags in TRAIN_KINDS:
        if any(f in low for f in frags):
            return kind
    return "other elementwise"


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
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and dev_us(e) > 0]
    if not rows:
        log("    profile of a training step: the profiler recorded no "
            "device time")
        return
    kinds = {}
    for e in rows:
        k = train_kind(e.key)
        kinds[k] = kinds.get(k, 0.0) + dev_us(e) / 2 / 1e3
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


def main() -> int:
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
    phase_card_and_build()
    params = tabulate_model(
        init_dp_params(torch.Generator().manual_seed(SEED), COPPER_DP,
                       device=dev), COPPER_DP, "cheb")
    kernels = phase_kernels(COPPER_DP, WATER_DP, params, dev)
    launches, scan = phase_main_path(COPPER_DP, params, dev)
    by_path = {"scan": launches}
    phase_rungs(COPPER_DP, params, dev)
    by_path["outer"] = phase_outer(COPPER_DP, params, dev, scan)
    by_path["water"] = phase_water(WATER_DP, dev)
    phase_quintic(COPPER_DP, params, dev)
    phase_npt(COPPER_DP, params, dev)
    phase_lj(dev)
    _, dist_launches = phase_distributed(COPPER_DP, params, dev, scan)
    by_path.update(dist_launches)
    by_path["train_check"] = phase_train(COPPER_DP, dev)
    _, by_path["dryrun"] = phase_dryrun(dev)
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
    sys.exit(main())
