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
     main path runs. Zeros past each count; ragged counts with NaN poison
     past each count (those slots must never be read). Times: kernel, plain
     version, bound and share of the bound at each shape, and on the 4,096
     rows the cuBLAS-backed composition that materialises G (the yardstick;
     it is several calls, so the JSON line's ``library_ms`` is null). The
     JSON line reports the main path's shape.
  3. the main path: ``Simulation.run`` of the paper's copper protocol (NVE,
     330 K, 99 steps, rebuild every 50 with a 2 A skin) on fcc_copper(20,20,20)
     = 32,000 atoms at full COPPER_DP width, impl="cheb_pallas", weights
     random from a seed and Chebyshev-tabulated. Both kernels must launch
     >= 100 times (1 fwd + 1 bwd per force evaluation), the thermo must be
     finite and |d etot| per atom <= 1e-4 eV. A profile of three force
     evaluations splits the device time by kernel.
  4. one energy_forces on fcc_copper(10,10,10): cheb_pallas against cheb on
     the card (energy rtol 1e-5, forces atol 5e-5).

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

    pos, typ, box = lattice.fcc_copper(20, 20, 20)
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


def phase_kernels(cfg, params, dev):
    from repro_torch.kernels.dp_fused import ops, ref

    lo, hi = cfg.table_lower, cfg.table_upper
    c = params["table"]["nets"]["0"]["coeffs"]
    k, m = c.shape
    env_all, s_all, n_esc = copper_rows(cfg, params, dev)
    n_all = s_all.shape[0]

    def plain_fwd(s, env, counts):
        return by_rows(lambda *x: ref.fused_fwd_ref(*x[:2], c, x[2], lo, hi),
                       s, env, counts)

    def plain_bwd(s, env, counts, dt):
        return by_rows(lambda *x: ref.fused_bwd_ref(*x[:2], c, *x[2:], lo, hi),
                       s, env, counts, dt)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    # the sample at N=512 and at the escalated N, then every row of the box
    # at the escalated N: the shape the main path gives the kernels
    shapes = sorted({(SAMPLE_ATOMS, min(512, n_esc)), (SAMPLE_ATOMS, n_esc),
                     (n_all, n_esc)})
    for a, n in shapes:
        s = s_all[:a, :n].contiguous()
        env = env_all[:a, :n].contiguous()
        counts = ops.live_counts(s)
        live = int(counts.sum())
        dt = torch.randn((a, 4, m), generator=gen, device=dev)
        log(f"[2] A={a} N={n} K={k} M={m}: live slots {live} "
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

        # the plain version runs in row chunks: 2 timed calls at full size;
        # the cuBLAS composition materialises G whole, so only the sample
        sample = a == SAMPLE_ATOMS
        reps = 5 if sample else 2
        t = {
            "dp_fused_fwd": (
                time_ms(lambda: ops.fused_fwd(s, env, c, counts, lo, hi), 20),
                time_ms(lambda: plain_fwd(s, env, counts), reps),
                time_ms(lambda: library_fwd(s, env, c, lo, hi), 5)
                if sample else None, err_f),
            "dp_fused_bwd": (
                time_ms(lambda: ops.fused_bwd(s, env, c, counts, dt, lo, hi), 20),
                time_ms(lambda: plain_bwd(s, env, counts, dt), reps),
                time_ms(lambda: library_bwd(s, env, c, dt, lo, hi), 5)
                if sample else None, err_b),
        }
        bnd = bounds(live, a, n, k, m)
        for name, (ms, plain_ms, lib_ms, err) in t.items():
            lib = "not timed" if lib_ms is None else f"{lib_ms:.4f} ms"
            log(f"  {name}: kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
                f"cuBLAS composition {lib} | bound {bnd[name][0]:.4f}"
                f" ms ({bnd[name][1]}) | {bnd[name][0] / ms:.1%} of bound")
            # no single PyTorch call computes this function, so the
            # composition is printed above but library_ms stays null
            results[(name, a, n)] = {
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[name][0],
                "bound_by": bnd[name][1], "library_ms": None}
        del s, env, dt
        torch.cuda.empty_cache()
    return {name: results[(name, n_all, n_esc)] for name in REPLACES}


# ------------------------------------------------------------------ phase 3

def phase_main_path(cfg, params, dev):
    from repro_torch.kernels.dp_fused import ops
    from repro_torch.md import api, lattice

    pos, typ, box = lattice.fcc_copper(20, 20, 20)
    pot = api.make_potential("dp", cfg, impl="cheb_pallas")
    spec = api.SimulationSpec(pot, api.NVE(), steps=99, engine="scan")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.fwd_launches = 0
    ops.bwd_launches = 0
    t0 = time.perf_counter()
    res = api.Simulation(spec).run(params, pos, typ, box, device=dev)
    total = time.perf_counter() - t0
    launches = {"dp_fused_fwd": ops.fwd_launches,
                "dp_fused_bwd": ops.bwd_launches}
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
    return launches


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
    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    # kernel events only: an aten op reports its kernels' time as its own
    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and dev_us(e) > 0), key=lambda e: -dev_us(e))
    dev_ms = sum(dev_us(e) for e in rows) / 3e3
    if not rows:
        log(f"    profile: one force evaluation {wall:.3f} ms wall; the "
            f"profiler recorded no device time (split not measured)")
        return
    log(f"    profile: one force evaluation {wall:.3f} ms wall, {dev_ms:.3f}"
        f" ms device time in kernels ({dev_ms / wall:.1%} busy)")
    # the twelve largest, and the dp_fused kernels wherever they rank
    fused = [e for e in rows[12:] if "fwd_kernel" in e.key
             or "bwd_kernel" in e.key]
    for e in rows[:12] + fused:
        log(f"      {dev_us(e) / 3e3:8.3f} ms  {e.count // 3:4d}x  "
            f"{e.key[:90]}")


# ------------------------------------------------------------------ phase 4

def phase_rungs(cfg, params, dev):
    from repro_torch.core import dp_model
    from repro_torch.md import lattice, neighbors, stepper

    pos, typ, box = lattice.fcc_copper(10, 10, 10)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.dp_model import init_dp_params, tabulate_model
    from repro_torch.core.types import COPPER_DP
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
    kernels = phase_kernels(COPPER_DP, params, dev)
    launches = phase_main_path(COPPER_DP, params, dev)
    phase_rungs(COPPER_DP, params, dev)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [dict(kernels[name], launches=launches[name])
                                  for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
