"""The port's quintic table (paper Sec. 3.2) against the reference's.

Same weights (the reference's pytree through ``bridge``) go into
``repro.core.tabulation.build_quintic_table`` and the port's. The monomial
coefficients of t^k are (Hermite combination) / h^k: the higher ones come
from the cancellation of six node values, so in both packages they are
dominated by the float32 rounding of g. The coefficients are therefore held
in the interval's own units, c_k h^k (the u-basis the reference builds them
in), at rtol 1e-5 with atol 1e-5 of the table's largest |c_k h^k| (the same
scaling the kernel tests use); evaluated tables at rtol 1e-5 of max |g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import dp_model as jax_dp  # noqa: E402
from repro.core import tabulation as jax_tab  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import dp_model, embedding, tabulation  # noqa: E402

# One torch thread: the suite's pytest workers already occupy the cores.
torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module", params=["tiny_cfg", "tiny_water_cfg"])
def tables(request):
    """Each net's quintic table from both packages (one build per config)."""
    cfg = request.getfixturevalue(request.param)
    p_jax = jax_dp.init_dp_params(jax.random.PRNGKey(7), cfg)
    t_jax = jax_dp.tabulate_model(p_jax, cfg, "quintic")["table"]["nets"]
    p_t = bridge.params_from_numpy(jax.tree.map(np.asarray, p_jax), CPU)
    t_t = dp_model.tabulate_model(p_t, cfg, "quintic")["table"]["nets"]
    return cfg, p_t, t_jax, t_t


def test_quintic_coefficients_match_reference(tables):
    cfg, _, t_jax, t_t = tables
    assert set(t_t) == set(t_jax)
    for key, tab in t_jax.items():
        c_j = np.asarray(tab["coeffs"], np.float64)
        c_t = t_t[key]["coeffs"].numpy().astype(np.float64)
        assert c_t.shape == c_j.shape == (1000, 6, 32)
        assert (t_t[key]["lower"], t_t[key]["step"]) == \
            (tab["lower"], tab["step"]) == (cfg.table_lower, cfg.table_step)
        h_k = cfg.table_step ** np.arange(6)[None, :, None]
        u_j, u_t = c_j * h_k, c_t * h_k
        np.testing.assert_allclose(u_t, u_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(u_j).max())


def test_quintic_eval_matches_reference_at_and_past_the_edges(tables):
    """Interior points, every node, the last node, the upper edge itself
    and points past both edges (the clamp to lower + step*n - 1e-9, which
    rounds to the upper edge in float32)."""
    cfg, _, t_jax, t_t = tables
    lo, hi, h = cfg.table_lower, cfg.table_upper, cfg.table_step
    x = np.concatenate([
        np.linspace(lo - 0.5, hi + 0.5, 3001),
        lo + h * np.arange(1001),                  # every node
        [hi - h, hi - 1e-6, hi, hi + 1e-6, hi + 3.0, 1e6, lo - 1e6, lo],
    ]).astype(np.float32)
    for key, tab in t_jax.items():
        v_j = np.asarray(jax_tab.quintic_eval(tab, jnp.asarray(x)))
        v_t = tabulation.quintic_eval(t_t[key], torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(v_t, v_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(v_j).max())
        # past the upper edge the table holds its last value, which is g
        # at the edge; past the lower edge, g at the lower edge
        v_edge = v_t[-8:]
        np.testing.assert_array_equal(v_edge[3], v_edge[2])
        np.testing.assert_array_equal(v_edge[5], v_edge[2])
        np.testing.assert_array_equal(v_edge[6], v_edge[7])


def test_quintic_table_reproduces_the_net_at_its_edges(tables):
    cfg, p_t, _, t_t = tables
    for key, tab in t_t.items():
        g = embedding.embedding_scalar_fn(p_t["embed"][key])
        x = torch.tensor([cfg.table_lower, cfg.table_upper, 3.3])
        with torch.no_grad():
            np.testing.assert_allclose(tabulation.quintic_eval(tab, x),
                                       g(x), rtol=2e-5, atol=2e-6)


def test_per_step_gather_equals_the_full_gather(tables):
    """One coefficient row per Horner step gives bit for bit what the
    reference's gather of the whole (..., 6, M) block gives."""
    cfg, _, _, t_t = tables
    tab = t_t["0"]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(cfg.table_lower - 1, cfg.table_upper + 1,
                                     (17, 23)).astype(np.float32))
    coeffs, lower, step = tab["coeffs"], tab["lower"], tab["step"]
    n = coeffs.shape[0]
    xc = torch.clamp(x, lower, lower + step * n - 1e-9)
    idx = torch.clamp(((xc - lower) / step).to(torch.int64), 0, n - 1)
    t = (xc - (lower + idx.to(x.dtype) * step))[..., None]
    c = coeffs[idx]                                        # (..., 6, M)
    acc = c[..., 5, :]
    for k in (4, 3, 2, 1, 0):
        acc = acc * t + c[..., k, :]
    assert torch.equal(tabulation.quintic_eval(tab, x), acc)
