"""dp_fused port: the port's ``fused_env_tab_contract`` (its plain path on the
CPU, through the autograd.Function) against the reference's Pallas wrapper
(interpret mode on the CPU), plus the kernels' contracts in ``ref.py``.
The CUDA kernels themselves are compared with the plain versions in
``test_torch_cuda.py``, which runs only with a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels.dp_fused import ops as jax_ops  # noqa: E402
from repro.kernels.dp_fused import ref as jax_ref  # noqa: E402
from repro_torch.kernels.dp_fused import ops, ref  # noqa: E402

# One torch thread: the suite's pytest workers already occupy the cores, and
# intra-op threads on top of them stall (see test_torch_md.py).
torch.set_num_threads(1)

LOWER, UPPER = -1.0, 9.0


def _mk_inputs(seed, a, n, k, m, counts=None):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.1, 8.0, (a, n)).astype(np.float32)
    env = (rng.normal(size=(a, n, 4)) * 0.3).astype(np.float32)
    if counts is not None:
        mask = np.arange(n)[None, :] < np.asarray(counts)[:, None]
        s = s * mask
        env = env * mask[..., None]
    coeffs = (rng.normal(size=(k, m)) * 0.1).astype(np.float32)
    return s, env, coeffs


def _jax_fwd(env, s, coeffs):
    return np.asarray(jax_ops.fused_env_tab_contract(
        jnp.asarray(env), jnp.asarray(s), jnp.asarray(coeffs), LOWER, UPPER))


def _torch_fwd(env, s, coeffs):
    with torch.no_grad():
        return ops.fused_env_tab_contract(
            torch.from_numpy(env), torch.from_numpy(s),
            torch.from_numpy(coeffs), LOWER, UPPER).numpy()


@pytest.mark.parametrize("a,n,k,m", [
    (8, 64, 16, 32), (16, 128, 48, 128), (5, 96, 32, 64), (1, 256, 96, 128),
])
def test_fused_matches_reference(a, n, k, m):
    """Against the reference's oracle at rtol/atol 2e-5, and against its
    Pallas kernel at atol 2e-5 * max|T|: the Pallas kernel sums 128-slot
    tiles in sequence, another f32 order, and on these inputs it differs
    from its own oracle by 3.3e-5 at K=96, where |T| reaches 9."""
    s, env, coeffs = _mk_inputs(0, a, n, k, m)
    out = _torch_fwd(env, s, coeffs)
    oracle = np.asarray(jax_ref.fused_env_tab_contract_ref(
        jnp.asarray(env), jnp.asarray(s), jnp.asarray(coeffs), LOWER, UPPER))
    np.testing.assert_allclose(out, oracle, rtol=2e-5, atol=2e-5)
    kernel = _jax_fwd(env, s, coeffs)
    np.testing.assert_allclose(
        out, kernel, rtol=2e-5, atol=2e-5 * max(1.0, np.abs(kernel).max()))


def test_fused_batch_dims():
    s, env, coeffs = _mk_inputs(1, 12, 64, 24, 32)
    s3, env3 = s.reshape(3, 4, 64), env.reshape(3, 4, 64, 4)
    out = _torch_fwd(env3, s3, coeffs)
    assert out.shape == (3, 4, 4, 32)
    np.testing.assert_allclose(out, _jax_fwd(env3, s3, coeffs), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("seed", [2, 3])
def test_fused_grads_match_reference_on_live_slots(seed):
    """Gradients of sum(sin(T)) through both wrappers. The reference zeroes
    only whole skipped tiles, so a padded slot inside a live tile gets
    denv = G(0) dT there and exactly 0 here; both are harmless (env rows
    and ds/dr vanish on padding), so slots compare where n < count."""
    a, n = 8, 64
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, n + 1, a)
    s, env, coeffs = _mk_inputs(seed, a, n, 24, 32, counts=counts)

    def loss_jax(env, s):
        out = jax_ops.fused_env_tab_contract(env, s, jnp.asarray(coeffs),
                                             LOWER, UPPER)
        return jnp.sum(jnp.sin(out))

    genv_j, gs_j = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(env),
                                                      jnp.asarray(s))
    env_t = torch.from_numpy(env).requires_grad_(True)
    s_t = torch.from_numpy(s).requires_grad_(True)
    out = ops.fused_env_tab_contract(env_t, s_t, torch.from_numpy(coeffs),
                                     LOWER, UPPER)
    genv_t, gs_t = torch.autograd.grad(torch.sin(out).sum(), (env_t, s_t))

    live = np.arange(n)[None, :] < ops.live_counts(s_t.detach()).numpy()[:, None]
    np.testing.assert_allclose(genv_t.numpy()[live], np.asarray(genv_j)[live],
                               rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(gs_t.numpy()[live], np.asarray(gs_j)[live],
                               rtol=3e-4, atol=3e-5)
    assert not genv_t.numpy()[~live].any() and not gs_t.numpy()[~live].any()


@pytest.mark.parametrize("seed", range(4))
def test_fused_ragged_counts(seed):
    """Any ragged per-atom count pattern gives the reference's answer."""
    rng = np.random.default_rng(100 + seed)
    a, n = int(rng.integers(1, 13)), 2 ** int(rng.integers(4, 8))
    counts = rng.integers(0, n + 1, a)
    s, env, coeffs = _mk_inputs(seed, a, n, 16, 32, counts=counts)
    np.testing.assert_allclose(_torch_fwd(env, s, coeffs),
                               _jax_fwd(env, s, coeffs), rtol=2e-5, atol=2e-5)


def test_live_counts_is_one_past_last_nonzero_slot():
    s = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 2.0, 0.0],
                      [1.0, 0.0, 3.0]])
    assert ops.live_counts(s).tolist() == [0, 1, 2, 3]
    assert ops.live_counts(s).dtype == torch.int32


def test_kernel_contracts_never_read_past_count():
    """fused_fwd_ref/fused_bwd_ref are the CUDA kernels' contracts: NaN
    poison past each atom's count must not reach T, and ds/denv there are
    exactly zero."""
    a, n, k, m = 6, 48, 16, 32
    counts = np.array([0, 5, 17, 31, 47, 48])
    s, env, coeffs = _mk_inputs(7, a, n, k, m, counts=counts)
    past = np.arange(n)[None, :] >= counts[:, None]
    s_p, env_p = s.copy(), env.copy()
    s_p[past] = np.nan
    env_p[past] = np.nan
    cnt = torch.from_numpy(counts.astype(np.int32))
    c = torch.from_numpy(coeffs)
    t_clean = ref.fused_fwd_ref(torch.from_numpy(s), torch.from_numpy(env), c,
                                cnt, LOWER, UPPER)
    t_pois = ref.fused_fwd_ref(torch.from_numpy(s_p), torch.from_numpy(env_p),
                               c, cnt, LOWER, UPPER)
    assert torch.isfinite(t_pois).all()
    torch.testing.assert_close(t_pois, t_clean, rtol=0, atol=0)
    np.testing.assert_allclose(t_clean.numpy(), _jax_fwd(env, s, coeffs),
                               rtol=2e-5, atol=2e-5)

    dt = torch.from_numpy(np.random.default_rng(8).normal(
        size=(a, 4, m)).astype(np.float32))
    ds, denv = ref.fused_bwd_ref(torch.from_numpy(s_p), torch.from_numpy(env_p),
                                 c, cnt, dt, LOWER, UPPER)
    assert torch.isfinite(ds).all() and torch.isfinite(denv).all()
    assert not ds.numpy()[past].any() and not denv.numpy()[past].any()


def test_wrapper_rejects_what_the_kernels_do_not_take():
    s, env, coeffs = (torch.from_numpy(x) for x in _mk_inputs(9, 4, 16, 8, 32))
    cnt = ops.live_counts(s)
    with pytest.raises(TypeError):
        ops.fused_fwd(s.double(), env, coeffs, cnt, LOWER, UPPER)
    with pytest.raises(ValueError):
        ops.fused_fwd(s, env[:, :8], coeffs, cnt, LOWER, UPPER)
    with pytest.raises(ValueError):
        ops.fused_fwd(s.t().contiguous().t(), env, coeffs, cnt, LOWER, UPPER)
    with pytest.raises(TypeError):
        ops.fused_fwd(s, env, coeffs, cnt.long(), LOWER, UPPER)
    with pytest.raises(ValueError):
        ops.fused_bwd(s, env, coeffs, cnt, torch.zeros(4, 4, 16), LOWER,
                      UPPER)


def test_plain_path_launches_no_kernel():
    s, env, coeffs = (torch.from_numpy(x) for x in _mk_inputs(10, 4, 16, 8, 32))
    before = (ops.fwd_launches, ops.bwd_launches)
    env.requires_grad_(True)
    out = ops.fused_env_tab_contract(env, s, coeffs, LOWER, UPPER)
    out.sum().backward()
    assert (ops.fwd_launches, ops.bwd_launches) == before


def _factored_fwd(s, env, coeffs, counts, lower, upper):
    """The CUDA forward's order: S = sum_n env^T B, then T = S C."""
    live = torch.arange(s.shape[1])[None, :] < counts[:, None]
    s = torch.where(live, s, 0.0)
    env = torch.where(live[..., None], env, 0.0)
    u = ((2.0 * s - lower - upper) / (upper - lower)).clamp(-1.0, 1.0)
    basis, _ = ref.cheb_basis_pair(u, coeffs.shape[0])
    return torch.einsum("anc,ank->ack", env, basis) @ coeffs


def _factored_bwd(s, env, coeffs, counts, dt, lower, upper):
    """The CUDA backward's order: D = C dT^T, then denv = B D and
    ds = 2/(hi-lo) [|u_raw|<1] env . (B' D); zero past the counts."""
    live = torch.arange(s.shape[1])[None, :] < counts[:, None]
    s = torch.where(live, s, 0.0)
    env = torch.where(live[..., None], env, 0.0)
    u_raw = (2.0 * s - lower - upper) / (upper - lower)
    basis, dbasis = ref.cheb_basis_pair(u_raw.clamp(-1.0, 1.0),
                                        coeffs.shape[0])
    d = torch.einsum("km,acm->akc", coeffs, dt)                   # (A, K, 4)
    denv = basis @ d
    ds = (env * (dbasis @ d)).sum(-1)
    ds = torch.where(live & (u_raw.abs() < 1.0), ds * (2.0 / (upper - lower)),
                     0.0)
    return ds, torch.where(live[..., None], denv, 0.0)


@pytest.mark.parametrize("seed", [11, 12])
def test_factored_order_matches_contracts_and_pallas(seed):
    """The CUDA kernels' factored order, T = (sum_n env^T B) C and
    D = C dT^T, in plain torch at copper width (K=32, M=128) with ragged
    counts and NaN past them, against ref.py's materialising contracts and
    the reference's Pallas kernel (interpret mode). Tolerances are those of
    the card test (tests/test_torch_cuda.py): every path sums in another f32
    order, over up to 128 slots and 32 basis terms."""
    a, n, k, m = 16, 128, 32, 128
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, n + 1, a)
    counts[:2] = (0, n)
    s, env, coeffs = _mk_inputs(seed, a, n, k, m, counts=counts)
    dt = rng.normal(size=(a, 4, m)).astype(np.float32)
    past = np.arange(n)[None, :] >= counts[:, None]
    s_p, env_p = s.copy(), env.copy()
    s_p[past] = np.nan
    env_p[past] = np.nan
    args = [torch.from_numpy(x) for x in (s_p, env_p, coeffs)]
    cnt = torch.from_numpy(counts.astype(np.int32))
    c, dt_t = args[2], torch.from_numpy(dt)

    out = _factored_fwd(*args, cnt, LOWER, UPPER)
    want = ref.fused_fwd_ref(*args, cnt, LOWER, UPPER)
    torch.testing.assert_close(out, want, rtol=2e-5,
                               atol=2e-5 * max(1.0, float(want.abs().max())))
    # the Pallas kernel gets the clean rows: it skips whole tiles only
    kernel = _jax_fwd(env, s, coeffs)
    np.testing.assert_allclose(out.numpy(), kernel, rtol=2e-5,
                               atol=2e-5 * max(1.0, np.abs(kernel).max()))

    ds, denv = _factored_bwd(*args, cnt, dt_t, LOWER, UPPER)
    ds_r, denv_r = ref.fused_bwd_ref(*args, cnt, dt_t, LOWER, UPPER)
    for got, ref_ in ((ds, ds_r), (denv, denv_r)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, ref_, rtol=3e-4, atol=3e-5 * max(
            1.0, float(ref_.abs().max())))
    assert not ds.numpy()[past].any() and not denv.numpy()[past].any()

    _, vjp = jax.vjp(
        lambda e, x: jax_ops.fused_env_tab_contract(
            e, x, jnp.asarray(coeffs), LOWER, UPPER),
        jnp.asarray(env), jnp.asarray(s))
    denv_j, ds_j = (np.asarray(g) for g in vjp(jnp.asarray(dt)))
    live = ~past
    for got, want_j in ((ds.numpy(), ds_j), (denv.numpy(), denv_j)):
        np.testing.assert_allclose(
            got[live], want_j[live], rtol=3e-4,
            atol=3e-5 * max(1.0, np.abs(want_j[live]).max()))

