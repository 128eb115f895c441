"""The dp_fused CUDA kernels against their plain versions, on the card,
and the port's other paths on the card (engines, bricks, training, the dry
run, the LM zoo's serving and training).

These tests need an NVIDIA GPU and skip without one. The file imports
neither JAX nor the reference package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels.dp_fused import ops, ref  # noqa: E402

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


# ------------------------------------- the force-and-virial reduction

F32_UNIT = 2.0 ** -24     # float32's unit roundoff


def _force_inputs(seed, a, sections, live_share, dev, rows=None, offset=0,
                  hot=0.0):
    """de, rij (A, S, 3) and nlist (A, S) int64, each type section's live
    slots packed at its front as ``neighbors.pack_type_sections`` packs
    them, about ``live_share`` of a section live; unless that is 0, the
    first centre has no live slot and the last a full row; a share ``hot``
    of the live slots points
    at row ``rows - 1``, which many centres then share. Padded slots' de
    and rij hold NaN, which the kernel must never load."""
    rng = np.random.default_rng(seed)
    rows = rows or a
    nlist = np.full((a, sum(sections)), -1, np.int64)
    lo = 0
    for width in sections:
        cnt = rng.binomial(width, live_share, a)
        if live_share > 0:
            cnt[0], cnt[-1] = 0, width      # a single centre: a full row
        live = np.arange(width)[None, :] < cnt[:, None]
        j = rng.integers(0, rows, (a, width))
        j = np.where(rng.random((a, width)) < hot, rows - 1, j)
        nlist[:, lo:lo + width] = np.where(live, j, -1)
        lo += width
    pad = (nlist < 0)[..., None]
    de = rng.normal(size=(*nlist.shape, 3)).astype(np.float32)
    rij = rng.uniform(-8.0, 8.0, (*nlist.shape, 3)).astype(np.float32)
    de, rij = (torch.from_numpy(np.where(pad, np.float32(np.nan), x)).to(dev)
               for x in (de, rij))
    return de, rij, torch.from_numpy(nlist).to(dev), rows, offset


def _unpoisoned(de, rij, nlist):
    """de and rij with zeros in the padded slots, as autograd gives them."""
    live = (nlist >= 0)[..., None]
    return torch.where(live, de, 0.0), torch.where(live, rij, 0.0)


def _assert_force_reduction_close(f, w, de, rij, nlist, rows, offset, dev):
    """The kernel's float32 f and W against the plain version in float64.

    Tolerance: float32 reassociation. A float32 sum of the same terms in
    any order whose longest chain of roundings is D lies within
    D x 2^-24 x sum|terms| of the exact sum. Row r of f sums the -de of the
    n_r slots that point at r, by atomics in any order (n_r + 1 roundings
    with the centre's own term), and that term, summed over the row's
    ceil(S/32) slots a lane and 5 shuffles: D_r = n_r + ceil(S/32) + 6.
    W sums a lane's fused products over its centres' slots (at most
    ceil(S/32) x ceil(A / (8 x SMs)) with at least one resident block an
    SM), 5 shuffles, the block's 8 warps, at most ceil(4096/32) partials a
    lane and 5 shuffles."""
    from repro_torch.kernels.dp_fused import force

    a, s = nlist.shape
    de64, rij64 = de.double(), rij.double()
    f_want, w_want = force.prod_force_virial_ref(de64, rij64, nlist, rows,
                                                 offset)
    live = (nlist >= 0)[..., None]
    f_mass = torch.zeros((rows, 3), dtype=torch.float64, device=dev)
    f_mass.index_add_(0, nlist.clamp(min=0).reshape(-1),
                      (de64.abs() * live).reshape(-1, 3))
    f_mass[offset:offset + a] += (de64.abs() * live).sum(dim=1)
    n_r = torch.bincount(nlist[nlist >= 0], minlength=rows)
    depth = (n_r + (s + 31) // 32 + 6).double()[:, None]
    f_tol = depth * F32_UNIT * f_mass + 1e-30
    assert bool(((f.double() - f_want).abs() <= f_tol).all()), float(
        ((f.double() - f_want).abs() / f_tol).max())
    w_mass = torch.einsum("ijk,ijl->kl", (rij64 * live).abs(), de64.abs())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w_depth = ((s + 31) // 32) * max(1, -(-a // (8 * sms))) + 5 + 8 \
        + 4096 // 32 + 5
    w_tol = w_depth * F32_UNIT * w_mass + 1e-30
    assert bool(((w.double() - w_want).abs() <= w_tol).all()), float(
        ((w.double() - w_want).abs() / w_tol).max())


# cu.weak's one escalated 1320-slot section ~28% live, water's (128, 248)
# sections, cu.strong's 864 x 512; then a row offset into a larger array
# (``md/domain._pair_forces``), one row many centres share, a single
# centre, and slots that are all padding
_FORCE_CASES = {
    "cu.weak": dict(a=6000, sections=(1320,), live_share=0.28),
    "water": dict(a=6000, sections=(128, 248), live_share=0.59),
    "cu.strong": dict(a=864, sections=(512,), live_share=0.72),
    "offset": dict(a=500, sections=(96,), live_share=0.5, rows=1700,
                   offset=900),
    "shared_row": dict(a=2000, sections=(64, 64), live_share=0.6, hot=0.3),
    "one_centre": dict(a=1, sections=(37,), live_share=0.5),
    "all_padding": dict(a=64, sections=(40,), live_share=0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_FORCE_CASES))
def test_force_reduction_kernel_matches_plain_version(dev, case):
    from repro_torch.kernels.dp_fused import force

    kw = _FORCE_CASES[case]
    de, rij, nlist, rows, offset = _force_inputs(
        len(case), kw["a"], kw["sections"], kw["live_share"], dev,
        kw.get("rows"), kw.get("offset", 0), kw.get("hot", 0.0))
    n0 = force.force_launches
    f, w = force.prod_force_virial(de, rij, nlist, rows, offset)
    torch.cuda.synchronize()
    assert force.force_launches - n0 == 1
    assert f.shape == (rows, 3) and w.shape == (3, 3)
    assert bool(torch.isfinite(f).all()) and bool(torch.isfinite(w).all())
    _assert_force_reduction_close(f, w, *_unpoisoned(de, rij, nlist), nlist,
                                  rows, offset, dev)
    if case == "all_padding":
        assert not f.any() and not w.any()


@pytest.mark.cuda
def test_force_reduction_counts_eager_captured_and_replayed_launches(dev):
    """An eager call launches and counts once; a call under CUDA-graph
    capture counts as captured, not launched; each replay adds what the
    graph recorded. Replays give the eager virial bit for bit (no atomics)
    and its forces within float32 reassociation (atomics)."""
    from repro_torch.kernels.dp_fused import force

    de, rij, nlist, rows, offset = _force_inputs(11, 3000, (128, 248), 0.59,
                                                 dev)
    n0 = force.force_launches
    f, w = force.prod_force_virial(de, rij, nlist, rows)
    torch.cuda.synchronize()
    assert force.force_launches - n0 == 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up, as capture requires
        force.prod_force_virial(de, rij, nlist, rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n1, c1 = force.force_launches, force.force_captured
    with torch.cuda.graph(graph):
        g_f, g_w = force.prod_force_virial(de, rij, nlist, rows)
    assert force.force_captured - c1 == 1
    assert force.force_launches == n1
    for _ in range(2):
        graph.replay()
        force.count_replay(1)
        torch.cuda.synchronize()
        assert torch.equal(g_w, w)
        _assert_force_reduction_close(g_f, g_w, *_unpoisoned(de, rij, nlist),
                                      nlist, rows, offset, dev)
    assert force.force_launches - n1 == 2


@pytest.mark.cuda
def test_force_reduction_raises_instead_of_falling_back(dev):
    from repro_torch.kernels.dp_fused import force

    de, rij, nlist, rows, _ = _force_inputs(5, 16, (24,), 0.5, dev)
    strided = torch.empty((24, 16, 3), device=dev).transpose(0, 1)
    n0 = force.force_launches
    for bad, err in [((de.double(), rij, nlist), TypeError),
                     ((de, rij, nlist.int()), TypeError),
                     ((de, rij.cpu(), nlist), ValueError),
                     ((de[:, :-1], rij, nlist), ValueError),
                     ((strided, rij, nlist), ValueError)]:
        with pytest.raises(err):
            force.prod_force_virial(*bad, rows)
    with pytest.raises(ValueError):
        force.prod_force_virial(de, rij, nlist, rows, offset=1)
    assert force.force_launches == n0


# ----------------------------------------- DPA-1's gated attention core

def _attn_inputs(seed, a, s, d, dev, kind="live_first"):
    """q, k, v, ww, gate, pad as ``dpa1.attention_layer`` gets them, and a
    cotangent of O: ~70% of the slots live, each row's first (its count
    drawn in [0.6 S, 0.8 S], as ``dpa1.compact`` packs them; dpa1.h2o reads
    70.2%) or scattered at random; w in (0, 1] and unit vectors on live
    slots, 0 on padded ones."""
    from repro_torch.core import dpa1

    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "scattered":
        live = torch.rand((a, s), generator=g, device=dev) < 0.7
    else:
        n = torch.randint(int(0.6 * s), int(0.8 * s) + 1, (a, 1),
                          generator=g, device=dev)
        live = torch.arange(s, device=dev) < n

    def unit(*shape):
        return torch.nn.functional.normalize(
            torch.randn(shape, generator=g, device=dev), dim=-1)

    q, k, v = unit(a, s, d) * d ** -0.5, unit(a, s, d), unit(a, s, d)
    w = torch.where(live, 0.05 + 0.95 * torch.rand((a, s), generator=g,
                                                   device=dev), 0.0)
    r = unit(a, s, 3) * live[..., None]
    ww = w[:, :, None] * w[:, None, :]
    gate = ww * torch.matmul(r, r.transpose(1, 2))
    pad = torch.where(live, -dpa1.SHIFT, dpa1.MASKED - dpa1.SHIFT)[:, None]
    dout = torch.randn((a, s, d), generator=g, device=dev)
    return (q, k, v, ww, gate, pad), dout, live


def _assert_attention_close(got, inputs, dout, live, chunk=2000):
    """The kernels' O, lse, dq, dk, dv, dww, dgate against the plain
    version in float64, chunk by chunk of atoms: each within 1e-4 of its
    value plus 2e-5 of the chunk's largest (float32 sums of ~100 terms in
    another order: O and lse 4e-7 of the largest on the card, the gradients
    ~2e-6); zeros where a row or key is padded."""
    from repro_torch.core import dpa1
    from repro_torch.kernels.dp_fused import attention

    names = ("O", "lse", "dq", "dk", "dv", "dww", "dgate")
    for i in range(0, live.shape[0], chunk):
        x = [t[i:i + chunk].double() for t in inputs]
        o, lse = attention.gated_attention_fwd_ref(*x, dpa1.SHIFT)
        want = (o, lse, *attention.gated_attention_bwd_ref(
            *x, dpa1.SHIFT, o, lse, dout[i:i + chunk].double()))
        for name, g, w in zip(names, got, want):
            g = g[i:i + chunk].double()
            tol = 1e-4 * w.abs() + 2e-5 * float(w.abs().max())
            bad = (g - w).abs() > tol
            assert not bool(bad.any()), (name, i, float(
                ((g - w).abs() / tol).max()))
    pairs = live[:, :, None] & live[:, None, :]
    assert not got[0][~live].any() and not got[6][~pairs].any()
    assert not got[3][~live].any() and not got[4][~live].any()


# dpa1.h2o's shape (24,000 atoms, 120 slots, 128 features); a section
# escalated past two 64-row blocks (S = 193, not a multiple of 4); a
# scattered mask; the other feature widths; a section under one key tile
_ATTN_CASES = {
    "dpa1.h2o": (24000, 120, 128, "live_first"),
    "s193": (500, 193, 128, "live_first"),
    "scattered": (2000, 120, 128, "scattered"),
    "d64": (300, 70, 64, "scattered"),
    "d32": (300, 33, 32, "live_first"),
    "s7": (64, 7, 128, "live_first"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_ATTN_CASES))
def test_attention_kernels_match_plain_version(dev, case):
    from repro_torch.core import dpa1
    from repro_torch.kernels.dp_fused import attention

    a, s, d, kind = _ATTN_CASES[case]
    inputs, dout, live = _attn_inputs(len(case), a, s, d, dev, kind)
    f0, b0 = attention.attn_fwd_launches, attention.attn_bwd_launches
    out, lse = attention.gated_attention_fwd(*inputs, dpa1.SHIFT)
    grads = attention.gated_attention_bwd(*inputs, dpa1.SHIFT, out, lse, dout)
    torch.cuda.synchronize()
    assert (attention.attn_fwd_launches - f0,
            attention.attn_bwd_launches - b0) == (1, 1)
    _assert_attention_close((out, lse, *grads), inputs, dout, live)


@pytest.mark.cuda
def test_attention_counts_eager_captured_and_replayed_launches(dev):
    """Through the autograd Function: an eager forward and backward launch
    and count once each; under CUDA-graph capture they count as captured;
    each replay adds what the graph recorded and gives the eager result."""
    from repro_torch.core import dpa1
    from repro_torch.kernels.dp_fused import attention

    inputs, dout, _ = _attn_inputs(3, 400, 120, 128, dev)

    def step():
        # leaves made in the step, as the model's positions are
        leaves = [t.detach().requires_grad_(True) for t in inputs[:5]]
        out = attention.gated_attention(*leaves, inputs[5], dpa1.SHIFT)
        return (out.detach(), *torch.autograd.grad(out, leaves, dout))

    f0, b0 = attention.attn_fwd_launches, attention.attn_bwd_launches
    eager = step()
    torch.cuda.synchronize()
    assert (attention.attn_fwd_launches - f0,
            attention.attn_bwd_launches - b0) == (1, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up, as capture requires
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    f1, c1, d1 = (attention.attn_fwd_launches, attention.attn_fwd_captured,
                  attention.attn_bwd_captured)
    with torch.cuda.graph(graph):
        captured = step()
    assert (attention.attn_fwd_captured - c1,
            attention.attn_bwd_captured - d1) == (1, 1)
    assert attention.attn_fwd_launches == f1
    for _ in range(2):
        graph.replay()
        attention.count_replay(1, 1)
    torch.cuda.synchronize()
    assert attention.attn_fwd_launches - f1 == 2
    for g, e in zip(captured, eager):
        assert torch.equal(g, e)


@pytest.mark.cuda
def test_attention_raises_instead_of_falling_back(dev):
    from repro_torch.core import dpa1
    from repro_torch.kernels.dp_fused import attention

    inputs, _, _ = _attn_inputs(5, 8, 40, 128, dev)
    q, k, v, ww, gate, pad = inputs
    strided = torch.empty((40, 8, 128), device=dev).transpose(0, 1)
    narrow = [t[..., :48].contiguous() for t in (q, k, v)]
    f0 = attention.attn_fwd_launches
    for bad, err in [((q.double(), k.double(), v.double(), ww.double(),
                       gate.double(), pad.double()), TypeError),
                     ((*narrow, ww, gate, pad), ValueError),
                     ((q, strided, v, ww, gate, pad), ValueError),
                     ((q, k, v.cpu(), ww, gate, pad), ValueError)]:
        with pytest.raises(err):
            attention.gated_attention(*bad, dpa1.SHIFT)
    assert attention.attn_fwd_launches == f0


@pytest.mark.cuda
def test_a_dpa1_evaluation_runs_the_attention_kernels(dev):
    """One ``DPA1Potential.energy_forces`` call on the card adds exactly
    ``attn_layer`` to each launch counter, and gives the CPU's energy,
    forces and virial (the plain version there) to float32 reassociation."""
    from repro_torch.core.types import DPA1Config
    from repro_torch.kernels.dp_fused import attention
    from repro_torch.md import api, lattice, neighbors
    from repro_torch.train import tree

    cfg = DPA1Config(ntypes=2, rcut=4.0, rcut_smth=0.5, sel=40,
                     type_map=("O", "H"), embed_widths=(4, 8, 16),
                     axis_neuron=4, tebd_dim=8, attn=32, attn_layer=2,
                     fit_widths=(16, 16, 16))
    pot = api.make_potential("dpa1", cfg)
    params = pot.init_params(torch.Generator().manual_seed(0), device="cpu")
    pos, typ, box = lattice.water_box(1, 1, 1, seed=0)
    results = []
    for d in ("cpu", dev):
        x = torch.as_tensor(np.mod(pos, box), dtype=torch.float32, device=d)
        t = torch.as_tensor(typ, dtype=torch.int64, device=d)
        b = torch.as_tensor(box, dtype=torch.float32, device=d)
        nlist, ovf = neighbors.brute_force_neighbors(
            x, t, neighbors.NeighborSpec(cfg.rcut + 2.0, (64, 128)), b)
        assert int(ovf) <= 0
        p = tree.tree_map(lambda u: u.to(d), params)
        f0, b0 = attention.attn_fwd_launches, attention.attn_bwd_launches
        e, f, stats = pot.energy_forces(p, x, t, nlist, box=b)
        if d != "cpu":
            torch.cuda.synchronize()
        launches = (attention.attn_fwd_launches - f0,
                    attention.attn_bwd_launches - b0)
        results.append((e.cpu(), f.cpu(), stats["virial"].cpu(), launches))
    (e_c, f_c, w_c, n_c), (e_g, f_g, w_g, n_g) = results
    assert n_c == (0, 0) and n_g == (cfg.attn_layer, cfg.attn_layer)
    assert float(e_g) == pytest.approx(float(e_c), rel=1e-5)
    torch.testing.assert_close(f_g, f_c, rtol=0,
                               atol=1e-4 * float(f_c.abs().max()))
    torch.testing.assert_close(w_g, w_c, rtol=0,
                               atol=1e-4 * float(w_c.abs().max()))


@pytest.mark.cuda
def test_a_captured_dpa1_run_replays_the_attention_kernels(dev):
    """DPA-1 on the outer engine: each segment is captured as a CUDA graph
    with the attention kernels in it, and its replays give the scan
    engine's thermo (float32 reassociation only); the replays add to the
    launch counters."""
    from repro_torch.core.types import DPA1Config
    from repro_torch.kernels.dp_fused import attention
    from repro_torch.md import api, lattice

    cfg = DPA1Config(ntypes=2, rcut=4.0, rcut_smth=0.5, sel=40,
                     type_map=("O", "H"), embed_widths=(4, 8, 16),
                     axis_neuron=4, tebd_dim=8, attn=32, attn_layer=2,
                     fit_widths=(16, 16, 16))
    pot = api.make_potential("dpa1", cfg)
    params = pot.init_params(torch.Generator().manual_seed(0), device=dev)
    pos, typ, box = lattice.water_box(1, 1, 1, seed=0)
    pos = np.mod(pos, box)
    res, launches = {}, {}
    for engine in ("scan", "outer"):
        f0 = attention.attn_fwd_launches
        res[engine] = api.Simulation(api.SimulationSpec(
            potential=pot, ensemble="nve", steps=12, dt_fs=0.5,
            rebuild_every=6, thermo_every=1, skin=2.0, seed=7,
            engine=engine)).run(params, pos, typ, box, device=dev)
        launches[engine] = attention.attn_fwd_launches - f0
    assert res["outer"].graph_captures >= 1
    assert launches["outer"] >= 12 * cfg.attn_layer
    pe = {e: np.asarray([row["pe"] for row in r.thermo])
          for e, r in res.items()}
    np.testing.assert_allclose(pe["outer"], pe["scan"], rtol=1e-5)
    np.testing.assert_allclose(res["outer"].final_pos, res["scan"].final_pos,
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_a_dpa2_evaluation_matches_the_reference(dev):
    """One ``DPA2Potential.energy_forces`` call on the card at the
    published widths (``WATER_DPA2``: 120 and 40 slots, six layers), on
    ``water_box(2, 1, 1)`` (384 atoms), against the benchmark's plain
    reference (``mdbench/reference/dpa2.py``, plain torch) on the card,
    both in float32 with TF32 off: energies to 1e-6 relative, forces to
    1e-5 of the largest (float32 reassociation over six layers; the
    reference in TF32 reads ~1e-3 off)."""
    import sys
    from pathlib import Path

    from repro_torch.core.types import WATER_DPA2
    from repro_torch.md import api, lattice, neighbors

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from mdbench import manifest
    from mdbench.reference import dpa2 as ref
    from mdbench.reference.shared import neighbor_table

    raw = manifest.load("dpa2.h2o.1card").config
    assert manifest.config_for(type(WATER_DPA2), raw) == WATER_DPA2
    weights = ref.weights(raw, 0, dev)
    pos, typ, box = lattice.water_box(2, 1, 1, seed=0)
    x = torch.as_tensor(np.mod(pos, box), dtype=torch.float32, device=dev)
    t = torch.as_tensor(typ, dtype=torch.int64, device=dev)
    b = torch.as_tensor(box, dtype=torch.float32, device=dev)
    nlist, ovf = neighbors.brute_force_neighbors(
        x, t, neighbors.NeighborSpec(WATER_DPA2.rcut + 0.2, (96, 192)), b)
    assert int(ovf) <= 0
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pot = api.make_potential("dpa2", WATER_DPA2)
        e, f, stats = pot.energy_forces(weights, x, t, nlist, box=b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert (stats["model_excess"] <= 0).all()
    want = ref.Reference(raw, weights, dev)
    table = neighbor_table(x, b, WATER_DPA2.rcut)
    e_ref, f_ref = want.energy_forces(x, t, b, table)
    assert float(e) == pytest.approx(e_ref, rel=1e-6)
    scale = float(f_ref.abs().max())
    assert float((f - f_ref).abs().max()) < 1e-5 * scale
    e_low, f_low = ref.Reference(raw, weights, dev,
                                 precision="tf32").energy_forces(x, t, b,
                                                                  table)
    assert float((f_low - f_ref).abs().max()) > 1e-5 * scale


@pytest.mark.cuda
def test_a_captured_dpa2_run_matches_the_scan_engine(dev):
    """DPA-2 on the outer engine: each segment, both compactions and the
    gather of the neighbours' g1 and its scatter-add included, is captured
    as a CUDA graph, and its replays give the scan engine's thermo (float32
    reassociation only)."""
    from repro_torch.core.types import DPA2Config
    from repro_torch.md import api, lattice

    cfg = DPA2Config(rcut=4.0, sel=40, repinit_widths=(4, 8, 16),
                     repinit_axis=4, repformer_rcut=3.0,
                     repformer_rcut_smth=2.0, repformer_sel=20, g1_dim=16,
                     g2_dim=8, attn2_hidden=8, fit_widths=(16, 16, 16))
    pot = api.make_potential("dpa2", cfg)
    params = pot.init_params(torch.Generator().manual_seed(0), device=dev)
    for lyr in params["repformers"]:
        lyr["g1_res"].fill_(1.0)
        lyr["g2_res"].fill_(1.0)
    pos, typ, box = lattice.water_box(1, 1, 1, seed=0)
    pos = np.mod(pos, box)
    res = {}
    for engine in ("scan", "outer"):
        res[engine] = api.Simulation(api.SimulationSpec(
            potential=pot, ensemble="nve", steps=12, dt_fs=0.5,
            rebuild_every=6, thermo_every=1, skin=2.0, seed=7,
            engine=engine)).run(params, pos, typ, box, device=dev)
    assert res["outer"].graph_captures >= 1
    assert res["outer"].section_slots == cfg.sections
    pe = {e: np.asarray([row["pe"] for row in r.thermo])
          for e, r in res.items()}
    np.testing.assert_allclose(pe["outer"], pe["scan"], rtol=1e-5)
    np.testing.assert_allclose(res["outer"].final_pos, res["scan"].final_pos,
                               rtol=0, atol=1e-4)


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
    the profiler's count of the kernels over two replays agrees: the
    dp_fused pair and the force reduction, once a step each."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.dp_fused import force

    eng, carry, aux = _copper_engine(dev)
    eng.run(carry, 1, 10, *aux)                        # capture
    fw0, bw0, r0 = ops.fwd_launches, ops.bwd_launches, force.force_launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run(carry, 2, 10, *aux)
        torch.cuda.synchronize()
    counted = (ops.fwd_launches - fw0, ops.bwd_launches - bw0,
               force.force_launches - r0)
    assert counted == (20, 20, 20)
    seen = [sum(e.count for e in prof.key_averages() if name in e.key)
            for name in ("fwd_kernel", "bwd_kernel",
                         "prod_force_virial_kernel")]
    assert tuple(seen) == counted, seen
    assert not [e.key for e in prof.key_averages() if "indexFunc" in e.key]


@pytest.mark.cuda
def test_each_new_capture_holds_no_more_memory(dev):
    """Every capture warms up on one side stream a device: PyTorch keeps
    cuBLAS workspaces for each stream a product ran on, so a new stream a
    capture held 64 MiB more each call. Engines that record and are
    dropped leave the card's allocation where the first left it."""
    import gc

    held = []
    for _ in range(3):
        eng, carry, aux = _copper_engine(dev)
        eng.run(carry, 1, 4, *aux)
        assert eng.captures == 1
        del eng, carry, aux
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated(dev))
    assert held[1] == held[2], held


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


@pytest.mark.cuda
def test_local_comm_bricks_on_the_card_match_single_process(dev):
    """Eight ranks on the card (2x2 bricks x 2 model shards, neighbor-slot
    split, brick cell list, one thread and stream per rank) against the
    single-process force evaluation of the same atoms, both through the
    fused kernels: PE 1e-4 + 1e-5 |E|, forces 1e-5 max(1, max|F|), virial
    2e-3 relative. Every rank launches both kernels once."""
    from repro_torch.core import dp_model
    from repro_torch.core.types import DPConfig
    from repro_torch.md import comm, domain, lattice, neighbors

    cfg = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(64,),
                   type_map=("Cu",), embed_widths=(8, 16, 32), axis_neuron=4,
                   fit_widths=(32, 32, 32))
    params = dp_model.tabulate_model(dp_model.init_dp_params(
        torch.Generator().manual_seed(0), cfg, device=dev), cfg, "cheb")
    pos, typ, box = lattice.fcc_copper(4, 4, 3)
    rng = np.random.default_rng(0)
    pos = np.mod(pos + rng.normal(0, 0.05, pos.shape), box).astype(np.float32)
    boxt = torch.tensor(np.asarray(box, np.float32), device=dev)
    pos_t = torch.from_numpy(pos).to(dev)
    typ_t = torch.from_numpy(typ).long().to(dev)
    nl, _ = neighbors.brute_force_neighbors(
        pos_t, typ_t, neighbors.NeighborSpec(rcut_nbr=4.5, sel=(64,)), boxt)
    e_ref, f_ref, w_ref = dp_model.dp_energy_forces(
        params, cfg, pos_t, nl, typ_t, boxt, impl="cheb_pallas")

    spec = domain.DomainSpec.for_topology(tuple(box), (2, 2), 96, 96, 4.5)
    state, _ = domain.partition_atoms(pos, np.zeros_like(pos), typ, spec)
    lc = comm.LocalComm(4, 2, device=dev)
    step = domain.make_distributed_md_step(
        cfg, spec, lc, (63.546,), 1e-3, impl="cheb_pallas", decomp="slots",
        neighbor="cells")
    fw0, bw0 = ops.fwd_launches, ops.bwd_launches
    (new, _, _, _), th = step(params, domain.shard_state(state, lc, dev), (),
                              boxt, ())
    torch.cuda.synchronize()
    assert (ops.fwd_launches - fw0, ops.bwd_launches - bw0) == (8, 8)
    assert int(th["n_atoms"]) == len(pos)
    assert max(int(th[k]) for k in ("halo_overflow", "nbr_overflow",
                                    "geom_overflow")) <= 0
    e_ref = float(e_ref)
    assert abs(float(th["pe"]) - e_ref) < 1e-4 + 1e-5 * abs(e_ref)
    w = th["stress"].cpu().numpy() * float(np.prod(box))
    w_ref = w_ref.cpu().numpy()
    assert np.abs(w - w_ref).max() / max(1.0, np.abs(w_ref).max()) < 2e-3
    f_ref = f_ref.cpu().numpy()
    mask, p0 = state.mask.numpy(), state.pos.numpy()
    force = new.force.cpu().numpy()
    tol = 1e-5 * max(1.0, float(np.abs(f_ref).max()))
    for s in range(4):
        for i in np.nonzero(mask[s])[0]:
            j = int(np.argmin(np.sum((pos - p0[s, i]) ** 2, 1)))
            assert np.abs(force[s, i] - f_ref[j]).max() < tol


def _brick_program(dev, capture, potential=None, ensemble=None, halo=96,
                   seed=0):
    """fcc_copper(4,4,3) jittered, in 2x2 bricks x 2 model shards (slot
    split, brick cell list) on the card: the outer program, its params, the
    bricks (velocities at 330 K, not primed), the box, and ``make(spec,
    capture)``, which builds the same program at another spec."""
    from repro_torch.core import dp_model
    from repro_torch.core.types import DPConfig
    from repro_torch.md import comm, domain, integrator, lattice

    cfg = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(64,),
                   type_map=("Cu",), embed_widths=(8, 16, 32), axis_neuron=4,
                   fit_widths=(32, 32, 32))
    params = {} if potential is not None else dp_model.tabulate_model(
        dp_model.init_dp_params(torch.Generator().manual_seed(0), cfg,
                                device=dev), cfg, "cheb")
    pos, typ, box = lattice.fcc_copper(4, 4, 3)
    rng = np.random.default_rng(seed)
    pos = np.mod(pos + rng.normal(0, 0.02, pos.shape), box).astype(np.float32)
    masses = torch.full((len(pos),), 63.546)
    vel = integrator.init_velocities(torch.Generator().manual_seed(seed),
                                     masses, 330.0).numpy()
    spec = domain.DomainSpec.for_topology(tuple(box), (2, 2), 96, halo, 4.5)
    state, _ = domain.partition_atoms(pos, vel, typ, spec)
    lc = comm.LocalComm(4, 2, device=dev)

    def make(spec, capture):
        return domain.make_outer_md_program(
            None if potential is not None else cfg, spec, lc, (63.546,), 1.0,
            impl="cheb_pallas", decomp="slots", neighbor="cells",
            potential=potential, ensemble=ensemble, capture=capture)

    boxt = torch.tensor(np.asarray(box, np.float32), device=dev)
    return (make(spec, capture), params, domain.shard_state(state, lc, dev),
            boxt, make)


def _min_image_max(a, b, boxt):
    d = a - b
    return float((d - boxt * torch.round(d / boxt)).abs().max())


@pytest.mark.cuda
def test_captured_outer_program_matches_the_eager_one(dev):
    """Eight thread-ranks on the card: the outer program with each segment
    length captured once as a CUDA graph (2 x 5 steps, then 3) against the
    same program run eagerly: positions by minimum image within 1e-5 A,
    thermo at rtol 1e-5 (the atomics sum in another order from run to run).
    The graphs record 8 ranks' launches and each replay counts them."""
    from repro_torch.md import domain, stepper

    runs = {}
    for capture in (False, True):
        prog, params, st, boxt, _ = _brick_program(dev, capture)
        st = prog.prime(params, st, boxt)
        fw0, bw0 = ops.fwd_launches, ops.bwd_launches
        ths = []
        for n_segs, seg_len in ((2, 5), (1, 3)):
            st, _, _, _, th = prog.run(st, params, n_segs, seg_len, (), boxt)
            ths.append(stepper.fetch_thermo(th))
            domain.check_segment_thermo(ths[-1])
        torch.cuda.synchronize()
        runs[capture] = (st.pos.clone(), ths, prog)
        launches = (ops.fwd_launches - fw0, ops.bwd_launches - bw0)
        want = 8 * (13 + 2 * capture)          # + a warm-up step a capture
        assert launches == (want, want), launches
    (p0, th0, _), (p1, th1, prog) = runs[False], runs[True]
    assert (prog.captures, prog.replays) == (2, 3)
    assert sorted(prog._graphs) == [3, 5]
    assert _min_image_max(p1, p0, boxt) < 1e-5
    for a, b in zip(th1, th0):
        assert a["pe"].shape == b["pe"].shape
        for k in ("pe", "ke", "press"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
        np.testing.assert_array_equal(a["n_atoms"], b["n_atoms"])


@pytest.mark.cuda
def test_captured_langevin_bricks_replay_from_a_restored_state(dev):
    """Langevin bricks in a graph: each replay draws fresh noise from every
    rank's own generator and the callers' generators advance; from a
    restored snapshot the replay draws the same noise again (velocities
    within the atomics' rounding, generator states bit for bit)."""
    from repro_torch.md import api, stepper

    prog, params, st, boxt, _ = _brick_program(
        dev, True, potential=api.LJPotential(sel=(64,), rcut_lj=4.0),
        ensemble=api.NVTLangevin(friction=0.05, seed=3))
    ens = prog.init_ensemble_state(dev)
    start = stepper.snapshot((prog.prime(params, st, boxt), ens))

    def run():
        st, ens = stepper.restore(start)
        st, ens, _, _, _ = prog.run(st, params, 1, 4, ens, boxt)
        return st.vel.clone(), [e["gen"].get_state() for e in ens]

    v1, g1 = run()
    st_fresh, _, _, _, _ = prog.run(start.carry[0], params, 1, 4, ens, boxt)
    v_fresh = st_fresh.vel.clone()
    v2, g2 = run()
    assert (prog.captures, prog.replays) == (1, 3)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert len({bytes(g.cpu().numpy()) for g in g1}) == 4
    assert float((v1 - v2).abs().max()) < 1e-5
    assert float((v_fresh - v1).abs().max()) > 1e-3


@pytest.mark.cuda
def test_an_overflow_escalation_builds_a_new_capture(dev, capsys):
    """A halo capacity too small for the bricks: the captured run's flags
    fail the check, the escalated spec's new program captures anew and its
    run passes, equal to the eager run at that spec. md_run on the card
    prints its captures and replays."""
    from repro_torch.launch import md_run
    from repro_torch.md import domain, stepper

    prog, params, st0, boxt, make = _brick_program(dev, True, halo=8)
    comm = prog.comm
    policy, progs = stepper.EscalationPolicy(), []
    for _ in range(policy.max_attempts):
        state = prog.prime(params, st0, boxt)
        _, _, _, _, th = prog.run(state, params, 1, 4, (), boxt)
        progs.append(prog)
        try:
            domain.check_segment_thermo(stepper.fetch_thermo(th))
            break
        except RuntimeError as e:
            assert "halo_overflow" in str(e)
        # as md_run: escalate, re-partition, a new program
        spec = domain.escalate_capacities(prog.spec, policy, n_model=2)
        whole, _ = domain.repartition_state(
            domain.gather_state(st0, comm), spec)
        st0 = domain.shard_state(whole, comm, dev)
        prog = make(spec, True)
    assert len(progs) >= 2
    assert all((p.captures, p.replays) == (1, 1) for p in progs)
    assert len({id(p._graphs[4].graph) for p in progs}) == len(progs)
    eager = make(prog.spec, False)
    _, _, _, _, th_e = eager.run(eager.prime(params, st0, boxt), params, 1,
                                 4, (), boxt)
    np.testing.assert_allclose(th["pe"].cpu().numpy(),
                               th_e["pe"].cpu().numpy(), rtol=1e-5)

    md_run.main(["--local-ranks", "4", "--nx", "6", "--steps", "6",
                 "--rebuild-every", "3"])
    out = capsys.readouterr().out
    assert "atoms 216" in out and "graph captures 1, replays 2" in out


@pytest.mark.cuda
@pytest.mark.parametrize("decomp,n_model", [("atoms", 1), ("slots", 2)])
def test_dist_captured_outer_program_matches_eager_and_local_comm(
        dev, decomp, n_model, tmp_path):
    """One NCCL process per card (DistComm), 2 x n_model: the outer program
    with each segment length captured once per process as a CUDA graph (2 x
    5 steps, then 3), its ppermutes and all-reduces inside, against the
    same program eager in those processes (thermo rtol 1e-6, positions by
    minimum image within 1e-5 A) and against LocalComm's ranks on card 0
    (thermo rtol 1e-5); each process launches the kernels 13 + 2 warm-up
    steps times. With 2 processes, a capture that fails on rank 1 (its
    recording reads a device value) raises on both, within the deadline."""
    import _torch_dist_worker as worker
    from repro_torch.md import comm

    world = 2 * n_model
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} GPUs, one per NCCL process "
                    f"({torch.cuda.device_count()} visible)")
    worker.spawn(worker.nccl_worker,
                 (worker.free_port(), str(tmp_path), n_model, decomp), world,
                 300)
    runs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
    lc = comm.LocalComm(2, n_model, device=dev)
    want_state, want, _, _ = worker.card_case(lc, dev, decomp, False)
    boxt = torch.tensor(np.asarray(worker._system()[0].box, np.float32))
    for r, run in enumerate(runs):
        eager, graph = run[False], run[True]
        assert eager["launches"] == (13, 13), (r, eager["launches"])
        assert graph["launches"] == (15, 15), (r, graph["launches"])
        assert (graph["captures"], graph["replays"]) == (2, 3), r
        for k in ("pe", "ke"):
            np.testing.assert_allclose(graph["thermo"][k],
                                       eager["thermo"][k], rtol=1e-6)
            np.testing.assert_allclose(graph["thermo"][k], want[k],
                                       rtol=1e-5)
        np.testing.assert_array_equal(graph["thermo"]["n_atoms"], 216)
        a, b = graph["state"], eager["state"]
        assert torch.equal(a.mask, b.mask)
        d = a.pos - b.pos
        assert float((d - boxt * torch.round(d / boxt)).abs().max()) < 1e-5
    if n_model == 1:
        errors = [run["failure"] for run in runs]
        assert errors[0] == "the segment's capture failed on another process"
        assert errors[1] is not None and "another process" not in errors[1]


# ------------------------------------------------------------- DP training

@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(dev):
    """One DP train step (the loss's double backward, AdamW) on the card
    against the same step on the CPU from the same state and batch, at
    chip_smoke.py phase 11's tolerances: every leaf's gradient rtol 1e-4,
    atol 1e-5 x max|g| of the leaf; loss and grad_norm rtol 1e-5."""
    from repro_torch.core import dp_model
    from repro_torch.core.types import DPConfig
    from repro_torch.train import dp_trainer, tree
    from repro_torch.train.steps import TrainState

    cfg = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(48,),
                   type_map=("Cu",), embed_widths=(8, 16, 32), axis_neuron=4,
                   fit_widths=(32, 32, 32))
    gen = torch.Generator().manual_seed(0)
    teacher = dp_model.init_dp_params(gen, cfg, device="cpu")
    data = dp_trainer.teacher_data(cfg, teacher, n_configs=2, device="cpu")
    loss_cfg = dp_trainer.DPLossConfig()
    opt = dp_trainer.make_optimizer(loss_cfg)
    student = dp_trainer.fit_env_stats(
        dp_model.init_dp_params(gen, cfg, device="cpu"), cfg, data)
    state = TrainState(student, opt.init(student),
                       torch.zeros((), dtype=torch.int32))
    step = dp_trainer.make_dp_train_step(cfg, loss_cfg, opt)
    on_card = (tree.tree_map(lambda t: t.to(dev), state),
               dp_trainer.DPBatch(*(x.to(dev) for x in data)))

    loss_c, _, g_c = step.loss_and_grads(state.params, data, state.step)
    loss_g, _, g_g = step.loss_and_grads(on_card[0].params, on_card[1],
                                         on_card[0].step)
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=0)
    for g, c in zip(tree.leaves(g_g), tree.leaves(g_c)):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4,
                                   atol=1e-5 * float(c.abs().max()))
    _, m_c = step(state, data)
    new_g, m_g = step(*on_card)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(m_g[k].cpu(), m_c[k], rtol=1e-5, atol=0)
    assert new_g.step.device.type == "cuda" and int(new_g.step) == 1


# ------------------------------------------------ the dry run's shape-only path

def _tiny_copper_args(dev):
    """Tabulated tiny-model params and a jittered fcc_copper(3,3,3) with its
    brute-force neighbor list, on ``dev``."""
    from repro_torch.core import dp_model
    from repro_torch.core.types import DPConfig
    from repro_torch.md import lattice, neighbors

    cfg = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(48,),
                   type_map=("Cu",), embed_widths=(8, 16, 32), axis_neuron=4,
                   fit_widths=(24, 24, 24), table_lower=-1.0,
                   table_upper=9.0)
    params = dp_model.tabulate_model(dp_model.init_dp_params(
        torch.Generator().manual_seed(0), cfg, device=dev), cfg, "cheb")
    pos, typ, box = lattice.fcc_copper(3, 3, 3)
    rng = np.random.default_rng(0)
    pos = torch.as_tensor(np.mod(pos + rng.normal(0, 0.05, pos.shape), box),
                          dtype=torch.float32, device=dev)
    typ = torch.as_tensor(typ, dtype=torch.int64, device=dev)
    box = torch.as_tensor(box, dtype=torch.float32, device=dev)
    nlist, _ = neighbors.brute_force_neighbors(
        pos, typ, neighbors.NeighborSpec(rcut_nbr=cfg.rcut, sel=cfg.sel), box)
    return cfg, (params, pos, nlist, typ, box)


def _energy_forces(cfg):
    from repro_torch.core import dp_model

    def fn(params, pos, nlist, typ, box):
        return dp_model.dp_energy_forces(params, cfg, pos, nlist, typ, box,
                                         impl="cheb_pallas")
    return fn


@pytest.mark.cuda
def test_fake_cuda_trace_reaches_neither_nvcc_nor_ctypes(dev, monkeypatch):
    """A fake CUDA trace of the fused rung runs the custom ops' fake
    implementations: the kernel library is never built or loaded, nothing
    launches, and the counter sees each kernel with the package's FLOP
    formula; the fake trace's numbers equal a real run's on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils import _pytree as pytree

    from repro_torch.analysis import op_cost
    from repro_torch.kernels.dp_fused import build

    cfg, args = _tiny_copper_args(dev)
    real = op_cost.analyze_fn(_energy_forces(cfg), *args)   # builds, launches
    torch.cuda.synchronize()

    def refuse(*a, **k):
        raise AssertionError("a fake trace reached the kernel build")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "_nvcc", refuse)
    fw0, bw0 = ops.fwd_launches, ops.bwd_launches
    mode = FakeTensorMode()
    fake_args = pytree.tree_map_only(torch.Tensor, mode.from_tensor, args)
    with mode:
        fake = op_cost.analyze_fn(_energy_forces(cfg), *fake_args)
    assert (ops.fwd_launches, ops.bwd_launches) == (fw0, bw0)
    a, n = args[2].shape
    k, m = args[0]["table"]["nets"]["0"]["coeffs"].shape
    want = {name: int(f) for name, (_, f) in
            ops.kernel_cost(a * n, a, n, k, m).items()}
    for name, flops in want.items():
        assert fake.flops_by_op[f"repro_torch.{name}"] == flops
    assert (fake.flops, fake.peak_bytes, fake.bytes_accessed) == (
        real.flops, real.peak_bytes, real.bytes_accessed)


@pytest.mark.cuda
def test_flop_formula_counts_on_the_card_as_on_the_cpu(dev):
    """The same evaluation counted on the card and on the CPU gives the
    same FLOPs, kernel by kernel (the formula reads shapes only)."""
    from repro_torch.analysis import op_cost

    cfg, args = _tiny_copper_args(dev)
    on_card = op_cost.analyze_fn(_energy_forces(cfg), *args)
    _, cpu_args = _tiny_copper_args(torch.device("cpu"))
    on_cpu = op_cost.analyze_fn(_energy_forces(cfg), *cpu_args)
    assert on_card.flops == on_cpu.flops > 0
    assert on_card.flops_by_op == on_cpu.flops_by_op


@pytest.mark.cuda
def test_custom_op_counts_eager_captured_and_replayed_launches(dev):
    """Through the custom ops an eager call launches and counts once; a
    call under CUDA-graph capture counts as captured, not launched; each
    replay adds what the graph recorded and gives the eager result."""
    s, env, c, cnt, dt = _inputs(7, 64, 96, 32, 128, dev)
    fw0, bw0 = ops.fwd_launches, ops.bwd_launches
    out = ops.fused_fwd(s, env, c, cnt, LOWER, UPPER)
    ds, denv = ops.fused_bwd(s, env, c, cnt, dt, LOWER, UPPER)
    torch.cuda.synchronize()
    assert (ops.fwd_launches - fw0, ops.bwd_launches - bw0) == (1, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up, as capture requires
        ops.fused_fwd(s, env, c, cnt, LOWER, UPPER)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    fw1, fc1, bc1 = ops.fwd_launches, ops.fwd_captured, ops.bwd_captured
    with torch.cuda.graph(graph):
        g_out = ops.fused_fwd(s, env, c, cnt, LOWER, UPPER)
        g_ds, g_denv = ops.fused_bwd(s, env, c, cnt, dt, LOWER, UPPER)
    assert (ops.fwd_captured - fc1, ops.bwd_captured - bc1) == (1, 1)
    assert ops.fwd_launches == fw1
    for _ in range(2):
        graph.replay()
        ops.count_replay(1, 1)
    torch.cuda.synchronize()
    assert ops.fwd_launches - fw1 == 2
    assert torch.equal(g_out, out) and torch.equal(g_denv, denv)
    assert torch.equal(torch.nan_to_num(g_ds), torch.nan_to_num(ds))


# ------------------------------------------ the environment matrix pair

def _env_rows(a, sections, live_share, dev, seed, ntypes=1):
    """rij (A, N, 3), nmask, atype, dstd as the model gets them: each type
    section's live slots packed at its front (about ``live_share`` of it),
    r from 0.8 to 10 A (inside the switch, on its ramp, past rcut 6 A), the
    first centre's first slots at r = 0, 1e-7, 6 (rcut) and 1 A; padded
    slots' r_ij NaN (the kernels must never load them) and, for the plain
    version, 0 as ``gather_rij`` leaves them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = sum(sections)
    nmask = torch.zeros((a, n), dtype=torch.bool, device=dev)
    lo = 0
    for width in sections:
        cnt = (width * live_share * (0.8 + 0.4 * torch.rand(
            (a,), generator=gen, device=dev))).round().clamp(max=width)
        nmask[:, lo:lo + width] = (torch.arange(width, device=dev)[None]
                                   < cnt[:, None])
        lo += width
    unit = torch.nn.functional.normalize(
        torch.randn((a, n, 3), generator=gen, device=dev), dim=-1)
    r = 0.8 + 9.2 * torch.rand((a, n), generator=gen, device=dev)
    r[0, :4] = torch.tensor([0.0, 1e-7, 6.0, 1.0], device=dev)
    unit[0, 2] = torch.tensor([0.0, 1.0, 0.0], device=dev)   # r exactly 6
    nmask[0, :4] = True
    rij = torch.where(nmask[..., None], unit * r[..., None], 0.0)
    poisoned = torch.where(nmask[..., None], rij, float("nan"))
    atype = torch.randint(0, ntypes, (a,), generator=gen, device=dev)
    dstd = 0.2 + torch.rand((ntypes, 4), generator=gen, device=dev)
    return rij, poisoned, nmask, atype, dstd


# copper rows at cu.weak's width (512 slots, 72% live), water's two
# escalated sections (128 + 248 = 376 slots, two centre types), and a
# grid-stride wrap (more slots than the grid holds threads)
_ENV_CASES = {
    "copper": dict(a=4000, sections=(512,), live_share=0.72),
    "water": dict(a=4000, sections=(128, 248), live_share=0.59, ntypes=2),
    "wrap": dict(a=200000, sections=(37,), live_share=0.5, ntypes=3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_ENV_CASES))
def test_env_mat_kernels_match_the_plain_version(dev, case):
    """The forward is ``descriptor.env_matrix`` + ``normalize_env`` on the
    card bit for bit (the kernel rounds as the eager ops do); the backward,
    against autograd of those ops in float64, errs no more than twice as
    much as autograd in float32 does, plus an ulp of the largest gradient.
    Zeros on padded slots (whose r_ij hold NaN) and outside the cut. One
    launch each."""
    from repro_torch.kernels.dp_fused import env

    rij, poisoned, nmask, atype, dstd = _env_rows(
        **_ENV_CASES[case], dev=dev, seed=len(case))
    f0, b0 = env.env_fwd_launches, env.env_bwd_launches
    x = poisoned.clone().requires_grad_(True)
    env_n, s_n = env.env_mat(x, nmask, atype, dstd, 2.0, 6.0)
    gen = torch.Generator(device=dev).manual_seed(7)
    denv = torch.randn(env_n.shape, generator=gen, device=dev)
    ds = torch.randn(s_n.shape, generator=gen, device=dev)
    (got,) = torch.autograd.grad((env_n * denv).sum() + (s_n * ds).sum(), x)
    torch.cuda.synchronize()
    assert (env.env_fwd_launches - f0, env.env_bwd_launches - b0) == (1, 1)

    def plain(dtype):
        y = rij.to(dtype).requires_grad_(True)
        e_p, s_p = env.env_mat_ref(y, nmask, atype, dstd.to(dtype), 2.0, 6.0)
        (g,) = torch.autograd.grad(
            (e_p * denv.to(dtype)).sum() + (s_p * ds.to(dtype)).sum(), y)
        return e_p.detach(), s_p.detach(), g
    e32, s32, g32 = plain(torch.float32)
    assert torch.equal(env_n, e32) and torch.equal(s_n, s32)
    _, _, g64 = plain(torch.float64)
    scale = float(g64.abs().max())
    err_k = float((got.double() - g64).abs().max())
    err_p = float((g32.double() - g64).abs().max())
    assert err_k <= 2.0 * err_p + 2.0 ** -24 * scale, (err_k, err_p, scale)
    # a random r within an ulp of rcut may round to either side of it
    r = rij.norm(dim=-1)
    dead = ~nmask | (r <= 1e-6) | (r >= 6.0 + 1e-5) | (r == 6.0)
    assert not env_n[~nmask].any() and not s_n[~nmask].any()
    assert not got[dead].any() and bool(torch.isfinite(got).all())


@pytest.mark.cuda
def test_env_mat_raises_instead_of_falling_back(dev):
    from repro_torch.kernels.dp_fused import env

    rij, _, nmask, atype, dstd = _env_rows(8, (16,), 0.5, dev, 0)
    with pytest.raises(TypeError):
        env.env_mat(rij.double(), nmask, atype, dstd, 2.0, 6.0)
    with pytest.raises(ValueError):
        env.env_mat(rij, nmask, atype, dstd.cpu(), 2.0, 6.0)


def _water_dp_args(dev):
    """A tiny two-type model (two neighbour sections) on water_box(1,1,1)."""
    from repro_torch.core import dp_model
    from repro_torch.core.types import DPConfig
    from repro_torch.md import lattice, neighbors

    cfg = DPConfig(ntypes=2, rcut=4.0, rcut_smth=0.5, sel=(16, 32),
                   type_map=("O", "H"), embed_widths=(8, 16, 32),
                   axis_neuron=4, fit_widths=(24, 24, 24), table_lower=-1.0,
                   table_upper=9.0)
    params = dp_model.tabulate_model(dp_model.init_dp_params(
        torch.Generator().manual_seed(0), cfg, device=dev), cfg, "cheb")
    pos, typ, box = lattice.water_box(1, 1, 1, seed=0)
    pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    typ = torch.as_tensor(typ, dtype=torch.int64, device=dev)
    box = torch.as_tensor(box, dtype=torch.float32, device=dev)
    nlist, _ = neighbors.brute_force_neighbors(
        pos, typ, neighbors.NeighborSpec(rcut_nbr=cfg.rcut, sel=cfg.sel), box)
    return cfg, (params, pos, nlist, typ, box)


@pytest.mark.cuda
@pytest.mark.parametrize("system", ["copper", "water"])
def test_an_se_e2_a_evaluation_launches_the_env_mat_pair_once(dev, system):
    """One cheb_pallas evaluation launches env_mat_fwd and env_mat_bwd once
    each (and the dp_fused pair once a section), and gives the cheb rung's
    energy and forces (energy rtol 1e-5, forces atol 5e-5)."""
    from repro_torch.core import dp_model
    from repro_torch.kernels.dp_fused import env

    cfg, (params, pos, nlist, typ, box) = (
        _tiny_copper_args if system == "copper" else _water_dp_args)(dev)
    f0, b0 = env.env_fwd_launches, env.env_bwd_launches
    d0 = ops.fwd_launches
    e, f, _ = dp_model.dp_energy_forces(params, cfg, pos, nlist, typ, box,
                                        impl="cheb_pallas")
    torch.cuda.synchronize()
    assert (env.env_fwd_launches - f0, env.env_bwd_launches - b0) == (1, 1)
    assert ops.fwd_launches - d0 == len(cfg.sel)
    e_c, f_c, _ = dp_model.dp_energy_forces(params, cfg, pos, nlist, typ, box,
                                            impl="cheb")
    assert (env.env_fwd_launches - f0, env.env_bwd_launches - b0) == (1, 1)
    assert abs(float(e) - float(e_c)) <= 1e-5 * abs(float(e_c))
    assert float((f - f_c).abs().max()) <= 5e-5


@pytest.mark.cuda
def test_outer_replays_count_the_env_mat_pair(dev):
    """A captured outer-engine segment records the pair once a step; each
    replay adds that to the counters, and the profiler's count of the two
    kernels over two replays of 10 steps agrees."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.dp_fused import env

    eng, carry, aux = _copper_engine(dev)
    c0, c1 = env.env_fwd_captured, env.env_bwd_captured
    eng.run(carry, 1, 10, *aux)                        # capture
    assert (env.env_fwd_captured - c0, env.env_bwd_captured - c1) == (10, 10)
    f0, b0 = env.env_fwd_launches, env.env_bwd_launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run(carry, 2, 10, *aux)
        torch.cuda.synchronize()
    counted = (env.env_fwd_launches - f0, env.env_bwd_launches - b0)
    assert counted == (20, 20)
    seen = tuple(sum(e.count for e in prof.key_averages() if name in e.key)
                 for name in ("env_mat_forward_kernel",
                              "env_mat_backward_kernel"))
    assert seen == counted, seen


@pytest.mark.cuda
def test_a_scan_trajectory_through_the_env_mat_pair_matches_the_torch_ops(
        dev, monkeypatch):
    """The paper's copper model at full width on fcc_copper(9,9,9) = 2,916
    atoms, 50 NVE steps on the scan engine from 330 K, once through the
    kernel pair and once through the plain torch ops: within
    cu.weak.1card's limits (``mdbench/limits/cu.weak.1card.json``): PE rows
    1e-6 eV an atom, the last velocities 6e-9 A/fs, the last positions
    6e-5 A. The force reduction's atomics sum in another order in each run,
    so neither run repeats itself bit for bit either."""
    from repro_torch.core import dp_model
    from repro_torch.core.types import COPPER_DP
    from repro_torch.kernels.dp_fused import env
    from repro_torch.md import api, lattice

    params = dp_model.tabulate_model(dp_model.init_dp_params(
        torch.Generator().manual_seed(0), COPPER_DP, device=dev), COPPER_DP,
        "cheb")
    pos, typ, box = lattice.fcc_copper(9, 9, 9)
    spec = api.SimulationSpec(api.make_potential("dp", COPPER_DP,
                                                 impl="cheb_pallas"),
                              api.NVE(), steps=50, thermo_every=1,
                              engine="scan", seed=3)

    def run():
        return api.Simulation(spec).run(params, pos, typ, box, device=dev)

    f0 = env.env_fwd_launches
    kernel = run()
    f1 = env.env_fwd_launches
    assert f1 - f0 >= 50
    monkeypatch.setattr(dp_model.env_ops, "env_mat", env.env_mat_ref)
    plain = run()
    assert env.env_fwd_launches == f1
    n = len(pos)
    pe = max(abs(a["pe"] - b["pe"]) for a, b in zip(kernel.thermo,
                                                    plain.thermo)) / n
    assert len(kernel.thermo) == len(plain.thermo) >= 50
    assert pe <= 1e-6, pe
    assert np.abs(kernel.final_vel - plain.final_vel).max() <= 6e-9
    d = kernel.final_pos - plain.final_pos
    d -= np.asarray(box) * np.round(d / np.asarray(box))
    assert np.abs(d).max() <= 6e-5


# ---------------------------------------------------------- LM zoo serving

_LM_ARCHS = ["glm4_9b", "qwen2_72b", "qwen3_1p7b", "granite_3_8b",
             "xlstm_125m", "granite_moe_1b_a400m", "qwen2_moe_a2p7b",
             "llava_next_34b", "recurrentgemma_9b", "whisper_base"]


def _lm_case(arch, dev):
    """The REDUCED config in f32 (MoE routed drop-free: capacity_factor =
    n_experts / top_k, so decode equals the teacher-forced forward), its
    weights from seed 0 on the CPU and on the card, and inputs."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.train import tree

    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(7)
    kw = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)))}
    if cfg.family == "encdec":
        kw["frames"] = torch.from_numpy(rng.normal(
            size=(2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    on_card = (tree.tree_map(lambda t: t.to(dev), params),
               {k: v.to(dev) for k, v in kw.items()})
    return api, (params, kw), on_card


def _lm_close(got, want):
    torch.testing.assert_close(
        got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_lm_forward_on_the_card_matches_the_cpu(dev, arch):
    from repro_torch.device import resolve_device

    resolve_device("cuda")          # TF32 off, as every entry point sets it
    api, (params, kw), (params_g, kw_g) = _lm_case(arch, dev)
    logits_c, aux_c = api.forward(params, **kw)
    logits_g, aux_g = api.forward(params_g, **kw_g)
    assert logits_g.device.type == "cuda"
    _lm_close(logits_g.cpu(), logits_c)
    _lm_close(aux_g.cpu(), aux_c)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_lm_decode_on_the_card_matches_its_forward(dev, arch):
    """prefill of 8 tokens + 4 decode steps (dense, MoE), or stateful
    decode of all 12 tokens (recurrent families), on the card, against the
    teacher-forced forward on the card."""
    from repro_torch.device import resolve_device
    from repro_torch.models import encdec
    from repro_torch.train.steps import make_serve_step

    resolve_device("cuda")
    api, _, (params, kw) = _lm_case(arch, dev)
    ref, _ = api.forward(params, **kw)
    toks = kw["tokens"]
    step = make_serve_step(api)
    k0 = 8 if api.prefill is not None else 0
    if api.prefill is not None:
        logits, cache = api.prefill(params, toks[:, :k0], 16)
        _lm_close(logits, ref[:, k0 - 1])
    elif api.cfg.family == "encdec":
        cache = encdec.init_cache(params, api.cfg, 2, 16, frames=kw["frames"])
    else:
        cache = api.init_cache(params, 2, 16)
    for t in range(k0, toks.shape[1]):
        logits, cache = step(params, toks[:, t:t + 1], cache)
        _lm_close(logits, ref[:, t])
    assert cache.length.device.type == "cuda"
    assert int(cache.length) == toks.shape[1]


# ---------------------------------------------------------- LM zoo training

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3_1p7b", "granite_moe_1b_a400m"])
def test_lm_train_step_on_the_card_matches_the_cpu(dev, arch):
    """One LM train step (f32, REDUCED, MoE drop-free) on the card against
    the CPU from the same params and batch: loss rtol 1e-5, every leaf's
    gradient within 1e-4 x max|g| of the leaf, grad_norm rtol 1e-4; and
    the card's gradients with remat on against off at the same bound."""
    import dataclasses

    from repro_torch.data.tokens import pipeline_for
    from repro_torch.device import resolve_device
    from repro_torch.models import build
    from repro_torch.train import optim, tree
    from repro_torch.train.steps import TrainState, make_train_step

    resolve_device("cuda")
    api, (params, _), (params_g, _) = _lm_case(arch, dev)
    batch = pipeline_for(api.cfg, 16, 2, seed=3).batch(0, "cpu")
    batch_g = {k: v.to(dev) for k, v in batch.items()}
    opt = optim.AdamW(lr=lambda s: 1e-3)
    step = make_train_step(api, opt, loss_chunk=8)
    loss_c, _, g_c = step.loss_and_grads(params, batch)
    loss_g, _, g_g = step.loss_and_grads(params_g, batch_g)
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=0)
    for g, c in zip(tree.leaves(g_g), tree.leaves(g_c)):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.cpu(), c, rtol=0,
                                   atol=1e-4 * float(c.abs().max()))
    off = make_train_step(build(dataclasses.replace(api.cfg, remat=False)),
                          opt, loss_chunk=8)
    _, _, g_off = off.loss_and_grads(params_g, batch_g)
    for a, b in zip(tree.leaves(g_g), tree.leaves(g_off)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    zero = lambda p: torch.zeros((), dtype=torch.int32, device=p.device)
    _, m_c = step(TrainState(params, opt.init(params), zero(loss_c)), batch)
    new_g, m_g = make_train_step(api, opt, loss_chunk=8, donate=True)(
        TrainState(params_g, opt.init(params_g), zero(loss_g)), batch_g)
    torch.testing.assert_close(m_g["grad_norm"].cpu(), m_c["grad_norm"],
                               rtol=1e-4, atol=0)
    assert new_g.step.device.type == "cuda" and int(new_g.step) == 1


@pytest.mark.cuda
def test_expert_parallel_moe_on_thread_ranks_matches_one_rank(dev):
    """``moe_ffn`` of REDUCED qwen2-moe at capacity 0.5 (drops), f32, on 4
    thread-ranks of the card as a (1, 4) grid (``sharding.threads``):
    each rank holds and runs e_pad / 4 experts, and the output and every
    gradient equal one rank's within 1e-5 of their largest entry."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.sharding import ctx, plans
    from repro_torch.sharding import state as sh_state
    from repro_torch.sharding.threads import ThreadedRanks, rank_threads
    from repro_torch.train import tree

    base = configs.get_reduced("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(base, dtype="float32", moe=dataclasses.replace(
        base.moe, capacity_factor=0.5))
    p = moe.init_moe_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((4, 64, cfg.d_model), generator=gen, device=dev)
    w = torch.randn(x.shape, generator=gen, device=dev)

    def run(p, x, w):
        p = tree.tree_map(lambda t: t.detach().requires_grad_(True), p)
        x = x.detach().requires_grad_(True)
        out, aux = moe.moe_ffn(p, cfg, x)
        leaves = [x] + tree.leaves(p)
        return out, torch.autograd.grad((out * w).sum() + aux, leaves), \
            leaves

    want, want_g, _ = run(p, x, w)

    def rank(r):
        mesh = sh_state.device_mesh(sh_state.local_grid(4), dev)
        plan = plans.make_plan(sh_state.grid(mesh), "train")
        rules = ctx.ActivationRules(mesh=plan.mesh,
                                    batch_axes=plan.batch_axes)
        placed = sh_state.distribute({"ffn": p}, mesh, plans.param_shardings(
            plan, {"ffn": p}))["ffn"]
        spec = plans.batch_spec(plan, 4, 2)
        with ctx.activation_rules(rules):
            out, grads, leaves = run(placed, sh_state.place(x, mesh, spec),
                                     sh_state.place(w, mesh, spec))
            grads = sh_state.like_params(list(grads), leaves)
            return (out.full_tensor(), [g.full_tensor() for g in grads],
                    [placed[k].to_local().shape[0] for k in ("wi", "wg",
                                                             "wo")])

    with ThreadedRanks():
        out, grads, local = rank_threads(rank, 4)[0]
    assert local == [moe.padded_experts(cfg) // 4] * 3
    for got, ref_ in zip([out] + grads, [want] + list(want_g)):
        err = float((got - ref_).abs().max())
        assert err <= 1e-5 * float(ref_.abs().max()), err


@pytest.mark.cuda
def test_traced_peak_of_full_attention_matches_the_card(dev):
    """``op_cost``'s peak of full attention's forward and backward (its
    softmax backward's hidden buffer counted) against the card's
    max_memory_allocated, within 5%."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import op_cost
    from repro_torch.models import attention

    def run(q, k, v):
        out = attention.full_attention(q, k, v, causal=False)
        return torch.autograd.grad(out.float().square().sum(), [q])

    shape = [(4, s, 8, 64) for s in (1024, 1500, 1500)]
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=dev,
                           dtype=torch.bfloat16).requires_grad_(True)
               for s in shape)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) - sum(
        t.numel() * t.element_size() for t in (q, k, v))
    run(q, k, v)
    torch.cuda.synchronize(dev)
    real = torch.cuda.max_memory_allocated(dev) - base
    with FakeTensorMode():
        fake = [torch.empty(s, device=dev, dtype=torch.bfloat16)
                .requires_grad_(True) for s in shape]
        est = op_cost.analyze_fn(run, *fake).peak_bytes
    assert 0.95 <= real / est <= 1.05, (real, est)
