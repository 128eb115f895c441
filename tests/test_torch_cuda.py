"""The dp_fused CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one. The file imports
neither JAX nor the reference package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.dp_fused import ops, ref

LOWER, UPPER = -1.0, 9.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _inputs(seed, a, n, k, m, dev, fill="ragged"):
    """Live counts ragged, all 0 or all N; NaN poison past each count."""
    rng = np.random.default_rng(seed)
    counts = {"ragged": rng.integers(0, n + 1, a), "zero": np.zeros(a, int),
              "full": np.full(a, n)}[fill]
    s = rng.uniform(0.1, 8.0, (a, n)).astype(np.float32)
    env = (rng.normal(size=(a, n, 4)) * 0.3).astype(np.float32)
    past = np.arange(n)[None, :] >= counts[:, None]
    s[past] = np.nan
    env[past] = np.nan
    coeffs = (rng.normal(size=(k, m)) * 0.1).astype(np.float32)
    dt = rng.normal(size=(a, 4, m)).astype(np.float32)
    cnt = counts.astype(np.int32)
    return [torch.from_numpy(x).to(dev) for x in (s, env, coeffs, cnt, dt)]


# The later cases hold the kernels' edges: K = 1 and 2 (the recurrence's
# seeding), N not a multiple of 4 (rows that start off 16-byte boundaries),
# more atoms than the grid holds warps at once (the atom loop wraps), K = 96
# with M = 256 (the largest shared-memory tile of the forward), counts all 0
# or all N, and M not a multiple of 4 (the forward's scalar S C path).
_CASES = [
    (8, 64, 16, 32, "ragged"), (16, 128, 48, 128, "ragged"),
    (5, 96, 32, 64, "ragged"), (1, 256, 96, 128, "ragged"),
    (64, 824, 32, 128, "ragged"), (3, 40, 7, 200, "ragged"),
    (8, 64, 1, 32, "ragged"), (8, 64, 2, 128, "ragged"),
    (16, 37, 32, 128, "ragged"), (4, 1321, 32, 128, "ragged"),
    (20000, 40, 32, 128, "ragged"), (6, 256, 96, 256, "ragged"),
    (8, 96, 32, 128, "zero"), (8, 96, 32, 128, "full"),
    (3, 37, 5, 131, "full"),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "a,n,k,m,fill", _CASES,
    ids=[f"{a}-{n}-{k}-{m}" + ("" if f == "ragged" else f"-{f}")
         for a, n, k, m, f in _CASES])
def test_kernels_match_plain_versions(dev, a, n, k, m, fill):
    s, env, c, cnt, dt = _inputs(a * n + k, a, n, k, m, dev, fill)
    fw0, bw0 = ops.fwd_launches, ops.bwd_launches
    out = ops.fused_fwd(s, env, c, cnt, LOWER, UPPER)
    ds, denv = ops.fused_bwd(s, env, c, cnt, dt, LOWER, UPPER)
    torch.cuda.synchronize()
    assert (ops.fwd_launches - fw0, ops.bwd_launches - bw0) == (1, 1)
    # f32 sums in another order than the plain version
    out_r = ref.fused_fwd_ref(s, env, c, cnt, LOWER, UPPER)
    torch.testing.assert_close(out, out_r, rtol=2e-5,
                               atol=2e-5 * max(1.0, float(out_r.abs().max())))
    ds_r, denv_r = ref.fused_bwd_ref(s, env, c, cnt, dt, LOWER, UPPER)
    torch.testing.assert_close(ds, ds_r, rtol=3e-4, atol=3e-5 * max(
        1.0, float(ds_r.abs().max())))
    torch.testing.assert_close(denv, denv_r, rtol=3e-4, atol=3e-5 * max(
        1.0, float(denv_r.abs().max())))
    past = torch.arange(n, device=dev)[None, :] >= cnt[:, None]
    assert not ds[past].any() and not denv[past].any()


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["sin", "cotangent"])
def test_autograd_function_on_the_card(dev, loss):
    """Gradients through the wrapper (strided section views included)
    against autograd of the differentiable plain version.

    "sin": the loss sum(sin(T)), whose cotangent cos(T) carries each side's
    f32 rounding of T into its gradients; the kernel's and the plain f32
    version's gradients are both held against a float64 evaluation of the
    plain version, with atol scaled by the largest |gradient| (up to ~124
    here) as in the tests above. "cotangent": a fixed random cotangent of T,
    so only the sums' order differs, kernel against plain f32 at an
    unscaled atol."""
    rng = np.random.default_rng(1)
    s = torch.from_numpy(rng.uniform(0.1, 8.0, (32, 96)).astype(np.float32))
    s[:, 70:] = 0.0
    env = torch.from_numpy(rng.normal(size=(32, 96, 4)).astype(np.float32))
    env[:, 70:] = 0.0
    c = torch.from_numpy(rng.normal(size=(32, 128)).astype(np.float32) * 0.1)
    w = torch.from_numpy(rng.normal(size=(32, 4, 128)).astype(np.float32))
    s, env, c, w = s.to(dev), env.to(dev), c.to(dev), w.to(dev)

    def grads(fn, dtype):
        e = env.to(dtype, copy=True).requires_grad_(True)
        x = s.to(dtype, copy=True).requires_grad_(True)
        out = fn(e[:, 10:], x[:, 10:], c.to(dtype), LOWER, UPPER)
        loss_v = torch.sin(out).sum() if loss == "sin" else (out * w).sum()
        return torch.autograd.grad(loss_v, (e, x))

    live = (torch.arange(96, device=dev) < 70)
    plain = grads(ref.fused_env_tab_contract_ref, torch.float32)
    kernel = grads(ops.fused_env_tab_contract, torch.float32)
    if loss == "sin":
        want = grads(ref.fused_env_tab_contract_ref, torch.float64)
        for got in (kernel, plain):
            for g, g64 in zip(got, want):
                g64 = g64[:, live].float()
                torch.testing.assert_close(
                    g[:, live], g64, rtol=3e-4,
                    atol=3e-5 * max(1.0, float(g64.abs().max())))
    else:
        for g_k, g_r in zip(kernel, plain):
            torch.testing.assert_close(g_k[:, live], g_r[:, live], rtol=3e-4,
                                       atol=3e-5)


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(dev):
    s, env, c, cnt, _ = _inputs(2, 4, 16, 8, 32, dev)
    with pytest.raises(ValueError):
        ops.fused_fwd(s, env, c.cpu(), cnt, LOWER, UPPER)
    with pytest.raises(ValueError):
        ops.fused_fwd(s, env, torch.zeros(8, 300, device=dev), cnt, LOWER,
                      UPPER)


# ------------------------------------------------ water's section widths

@pytest.mark.cuda
@pytest.mark.parametrize("sel", [(46, 92), (80, 152), (128, 248)],
                         ids=["native", "escalated-once", "escalated-twice"])
def test_water_sections_through_the_wrapper(dev, sel):
    """WATER_DP's two neighbor sections (native, and after one and two
    escalations) as strided views of one (A, sel_O + sel_H) list, through
    the autograd wrapper: T summed over sections and both gradients, against
    the plain version. Each section launches each kernel once. Gradients
    compare on live slots: past each count the kernel gives 0 and the plain
    version G(0) dT (ROADMAP.md §C)."""
    rng = np.random.default_rng(sum(sel))
    a, n = 384, sum(sel)
    s = np.zeros((a, n), np.float32)
    env = np.zeros((a, n, 4), np.float32)
    lo = 0
    for width in sel:
        cnt = rng.integers(0, width + 1, a)
        live = np.arange(width)[None, :] < cnt[:, None]
        s[:, lo:lo + width] = np.where(live, rng.uniform(0.1, 8.0, (a, width)),
                                       0.0)
        env[:, lo:lo + width] = np.where(live[..., None], rng.normal(
            size=(a, width, 4)) * 0.3, 0.0)
        lo += width
    coeffs = [torch.from_numpy((rng.normal(size=(32, 128)) * 0.1).astype(
        np.float32)).to(dev) for _ in sel]
    w = torch.from_numpy(rng.normal(size=(a, 4, 128)).astype(np.float32)).to(dev)
    s, env = torch.from_numpy(s).to(dev), torch.from_numpy(env).to(dev)

    def run(fn):
        e = env.clone().requires_grad_(True)
        x = s.clone().requires_grad_(True)
        t, lo = 0.0, 0
        for width, c in zip(sel, coeffs):
            t = t + fn(e[:, lo:lo + width], x[:, lo:lo + width], c, LOWER,
                       UPPER)
            lo += width
        return (t.detach(),) + torch.autograd.grad((t * w).sum(), (e, x))

    fw0, bw0 = ops.fwd_launches, ops.bwd_launches
    got = run(ops.fused_env_tab_contract)
    torch.cuda.synchronize()
    assert (ops.fwd_launches - fw0, ops.bwd_launches - bw0) == (2, 2)
    want = run(ref.fused_env_tab_contract_ref)
    live = s != 0.0                 # s > 0.1 up to each count, 0 past it
    for g, r, mask in zip(got, want, (None, live[..., None], live)):
        if mask is not None:
            assert not g[~mask.expand_as(g)].any()
            g, r = g[mask.expand_as(g)], r[mask.expand_as(r)]
        torch.testing.assert_close(g, r, rtol=3e-4, atol=3e-5 * max(
            1.0, float(r.abs().max())))


# --------------------------------------------- the outer engine's graphs

def _copper_engine(dev, ensemble=None):
    """The tiny copper DP model at cheb_pallas on fcc_copper(5,5,5), the
    outer engine and a carry, all on the card."""
    from repro_torch.core.types import DPConfig
    from repro_torch.md import api, integrator, lattice, neighbors, stepper

    cfg = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(96,),
                   type_map=("Cu",), embed_widths=(8, 16, 32),
                   axis_neuron=4, fit_widths=(24, 24, 24), table_lower=-1.0,
                   table_upper=9.0)
    pot = api.make_potential("dp", cfg, impl="cheb_pallas")
    params = pot.init_params(torch.Generator().manual_seed(0), device=dev)
    pos, typ, box = lattice.fcc_copper(5, 5, 5)
    pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    typ = torch.as_tensor(typ, dtype=torch.int64, device=dev)
    boxt = stepper.pack_box(box, dev)
    masses = torch.full((len(pos),), lattice.MASS["Cu"], device=dev)
    vel = integrator.init_velocities(torch.Generator().manual_seed(1), masses,
                                     330.0)
    spec = neighbors.NeighborSpec(rcut_nbr=cfg.rcut + 2.0, sel=cfg.sel)
    key = stepper.grid_key_for(spec, box)
    nlist, ovf = stepper._dyn_cell_list_fn(spec, key)(pos, typ, boxt)
    assert int(ovf) <= 0
    _, f, _ = pot.energy_forces(params, pos, typ, nlist, box=boxt)
    ensemble = ensemble or api.NVE()
    carry = stepper.OuterCarry(pos, vel, f,
                               torch.zeros((), dtype=torch.int32, device=dev),
                               ensemble.init_state(dev), boxt, ())
    eng = stepper.md_outer_engine(pot, ensemble, spec, key)
    return eng, carry, (params, typ, masses, 1.0)


@pytest.mark.cuda
def test_captured_segment_matches_the_eager_segment(dev):
    """Two replays of a captured segment (rebuild + 10 steps) against the
    same segment function run eagerly twice from the same carry. The force
    scatter's atomics sum in another order from run to run, so the two
    agree to f32 rounding grown over 20 steps, not bit for bit."""
    from repro_torch.md import stepper

    eng, carry, aux = _copper_engine(dev)
    start = stepper.snapshot(carry)
    out, th = eng.run(stepper.restore(start), 2, 10, *aux)
    assert (eng.captures, eng.replays) == (1, 2)
    assert th["pe"].shape == (2, 10)
    c, eager = stepper.restore(start), []
    with torch.no_grad():
        for _ in range(2):
            c, th_e = eng._seg_fn(c, 10, *aux)
            eager.append(th_e)
    torch.testing.assert_close(out.pos, c.pos, rtol=0, atol=1e-5)
    torch.testing.assert_close(out.vel, c.vel, rtol=0, atol=1e-6)
    torch.testing.assert_close(th["pe"], torch.stack([t["pe"] for t in eager]),
                               rtol=1e-6, atol=1e-5)
    assert int(out.overflow) <= 0


@pytest.mark.cuda
def test_langevin_noise_is_fresh_per_replay_and_restored_by_snapshot(dev):
    """The ensemble's CUDA generator is registered with the graph: two
    replays from the same carry draw different noise, and a restored
    snapshot draws the first replay's noise again, bit for bit (the O-step
    alone, no atomics)."""
    from repro_torch.md import api, integrator, stepper

    ens = api.NVTLangevin(temp_k=330.0, friction=0.1, seed=3)
    masses = torch.full((256,), 63.546, device=dev)

    def seg(carry, seg_len, masses, dt):
        vel, state, ke = carry.vel, carry.ens, []
        for _ in range(seg_len):
            vel, state = ens.finalize(vel, masses, dt, state)
            ke.append(integrator.kinetic_energy(vel, masses))
        return carry._replace(vel=vel, ens=state), {"ke": torch.stack(ke)}

    zeros = torch.zeros((256, 3), device=dev)
    carry = stepper.OuterCarry(zeros, zeros + 0.01, zeros,
                               torch.zeros((), dtype=torch.int32, device=dev),
                               ens.init_state(dev),
                               torch.ones(3, device=dev), ())
    eng = stepper.OuterEngine(seg)
    start = stepper.snapshot(carry)
    v1 = eng.run(stepper.restore(start), 1, 5, masses, 1.0)[0].vel.clone()
    v2 = eng.run(start.carry, 1, 5, masses, 1.0)[0].vel.clone()
    v3 = eng.run(stepper.restore(start), 1, 5, masses, 1.0)[0].vel.clone()
    assert (eng.captures, eng.replays) == (1, 3)
    assert not torch.equal(v1, v2)
    assert torch.equal(v1, v3)


@pytest.mark.cuda
def test_replay_launch_counts_match_the_profiler(dev):
    """The counters add what a graph recorded at capture once per replay;
    the profiler's count of the kernels over two replays agrees."""
    from torch.profiler import ProfilerActivity, profile

    eng, carry, aux = _copper_engine(dev)
    eng.run(carry, 1, 10, *aux)                        # capture
    fw0, bw0 = ops.fwd_launches, ops.bwd_launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run(carry, 2, 10, *aux)
        torch.cuda.synchronize()
    counted = (ops.fwd_launches - fw0, ops.bwd_launches - bw0)
    assert counted == (20, 20)
    seen = [sum(e.count for e in prof.key_averages() if name in e.key)
            for name in ("fwd_kernel", "bwd_kernel")]
    assert tuple(seen) == counted, seen


@pytest.mark.cuda
def test_a_failed_capture_raises(dev):
    """A segment that cannot be captured (here: it reads a device value on
    the host) makes the run raise; nothing falls back to eager."""
    from repro_torch.md import stepper

    def seg(carry, seg_len, scale):
        vel = carry.vel * scale
        if float(vel.sum()) > 1e30:          # a host sync: illegal in capture
            vel = vel * 0.0
        return carry._replace(vel=vel), {"ke": vel.sum().reshape(1)}

    zeros = torch.zeros((8, 3), device=dev)
    carry = stepper.OuterCarry(zeros, zeros + 1.0, zeros,
                               torch.zeros((), dtype=torch.int32, device=dev),
                               (), torch.ones(3, device=dev), ())
    eng = stepper.OuterEngine(seg)
    with pytest.raises(RuntimeError):
        eng.run(carry, 1, 1, 2.0)
    assert eng.replays == 0
