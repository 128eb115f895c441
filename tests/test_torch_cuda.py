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
