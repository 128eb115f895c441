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
     chunks summed at the main path's shape; it is several calls, so the
     JSON line's ``library_ms`` is null). The JSON line reports the main
     path's shape.
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

Prints the kernels' JSON line, then ``{"ok": true, "device": {...}}`` last.
TF32 is off for matmuls and cuDNN throughout: every product is FP32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/dp_fused/csrc/dp_fused.cu"
REPLACES = {"dp_fused_fwd": "src/repro/kernels/dp_fused/dp_fused.py:145",
            "dp_fused_bwd": "src/repro/kernels/dp_fused/dp_fused.py:182"}
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
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
    """Least time (ms) for each kernel's work on these inputs: each input
    byte read once (live slots only), each output byte written once, and
    the FP32 operations of the factored algorithm against the H100's
    peaks. Forward: 8K (env^T B) + 3K (recurrence) per live slot, 8KM
    (S C) per atom. Backward: ~24K per live slot (both recurrences, B D,
    B' D, env . B'D), 8KM (C dT^T) per atom."""
    read = live * 20 + k * m * 4 + a * 4
    fwd_bytes = read + a * 4 * m * 4
    fwd_ops = live * 11 * k + a * 8 * k * m
    bwd_bytes = read + a * 4 * m * 4 + a * n * 20
    bwd_ops = live * 24 * k + a * 8 * k * m
    out = {}
    for name, b, f in (("dp_fused_fwd", fwd_bytes, fwd_ops),
                       ("dp_fused_bwd", bwd_bytes, bwd_ops)):
        t_b, t_f = b / PEAK_BYTES * 1e3, f / PEAK_FP32 * 1e3
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
                    sample=False, chunked_lib=False)
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
    phase_rungs(COPPER_DP, params, dev)
    phase_outer(COPPER_DP, params, dev, scan)
    phase_water(WATER_DP, dev)
    phase_quintic(COPPER_DP, params, dev)
    phase_npt(COPPER_DP, params, dev)
    phase_lj(dev)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [dict(kernels[name], launches=launches[name])
                                  for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
