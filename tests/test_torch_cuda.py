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


def _inputs(seed, a, n, k, m, dev):
    """Ragged live counts, NaN poison past each count."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, n + 1, a)
    s = rng.uniform(0.1, 8.0, (a, n)).astype(np.float32)
    env = (rng.normal(size=(a, n, 4)) * 0.3).astype(np.float32)
    past = np.arange(n)[None, :] >= counts[:, None]
    s[past] = np.nan
    env[past] = np.nan
    coeffs = (rng.normal(size=(k, m)) * 0.1).astype(np.float32)
    dt = rng.normal(size=(a, 4, m)).astype(np.float32)
    cnt = counts.astype(np.int32)
    return [torch.from_numpy(x).to(dev) for x in (s, env, coeffs, cnt, dt)]


@pytest.mark.cuda
@pytest.mark.parametrize("a,n,k,m", [
    (8, 64, 16, 32), (16, 128, 48, 128), (5, 96, 32, 64), (1, 256, 96, 128),
    (64, 824, 32, 128), (3, 40, 7, 200),
])
def test_kernels_match_plain_versions(dev, a, n, k, m):
    s, env, c, cnt, dt = _inputs(a * n + k, a, n, k, m, dev)
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


@pytest.mark.cuda
def test_autograd_function_on_the_card(dev):
    """Gradients through the wrapper (strided section views included)
    against autograd of the differentiable plain version."""
    rng = np.random.default_rng(1)
    s = torch.from_numpy(rng.uniform(0.1, 8.0, (32, 96)).astype(np.float32))
    s[:, 70:] = 0.0
    env = torch.from_numpy(rng.normal(size=(32, 96, 4)).astype(np.float32))
    env[:, 70:] = 0.0
    c = torch.from_numpy(rng.normal(size=(32, 128)).astype(np.float32) * 0.1)
    s, env, c = s.to(dev), env.to(dev), c.to(dev)
    grads = []
    for fn in (ops.fused_env_tab_contract, ref.fused_env_tab_contract_ref):
        e = env.clone().requires_grad_(True)
        x = s.clone().requires_grad_(True)
        out = fn(e[:, 10:], x[:, 10:], c, LOWER, UPPER)
        grads.append(torch.autograd.grad(torch.sin(out).sum(), (e, x)))
    live = (torch.arange(96, device=dev) < 70)
    for g_k, g_r in zip(*grads):
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
