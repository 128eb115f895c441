"""The port's Deep Potential model against the reference, rung by rung.

Same inputs (numpy, seeded) and the same weights (the reference's pytree
through ``bridge.params_from_numpy``) go through ``repro.core`` and
``repro_torch.core``. Tolerances are f32 summation order: energy rtol 1e-5,
forces atol 2e-5, virial atol 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import descriptor as jax_descriptor  # noqa: E402
from repro.core import dp_model as jax_dp  # noqa: E402
from repro.md import lattice as jax_lattice  # noqa: E402
from repro.md import neighbors as jax_neighbors  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import descriptor, dp_model, layers  # noqa: E402

# One torch thread: the suite's pytest workers already occupy the cores, and
# intra-op threads on top of them stall (see test_torch_md.py).
torch.set_num_threads(1)

CPU = "cpu"


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _system(cfg, pos, typ, box):
    spec = jax_neighbors.NeighborSpec(rcut_nbr=cfg.rcut, sel=cfg.sel)
    nlist, ovf = jax_neighbors.brute_force_neighbors(
        jnp.asarray(pos, jnp.float32), jnp.asarray(typ), spec,
        jnp.asarray(box, jnp.float32))
    assert int(ovf) <= 0
    return (np.asarray(pos, np.float32), np.asarray(typ, np.int32),
            np.array(nlist), np.asarray(box, np.float32))


def _copper(cfg, jitter=0.05, seed=0):
    pos, typ, box = jax_lattice.fcc_copper(2, 2, 2)
    rng = np.random.default_rng(seed)
    return _system(cfg, np.mod(pos + rng.normal(0, jitter, pos.shape), box),
                   typ, box)


def _water(cfg):
    pos, typ, box = jax_lattice.water_box(1, 1, 1, seed=0)
    return _system(cfg, pos, typ, box)


def _both(cfg, seed, tabulate):
    """The reference's params (tabulated if asked: "quintic" or "cheb")
    and their port copy."""
    p = jax_dp.init_dp_params(jax.random.PRNGKey(seed), cfg)
    if tabulate:
        p = jax_dp.tabulate_model(p, cfg, tabulate)
    return p, bridge.params_from_numpy(_to_numpy(p), device=CPU)


def _table_kind(impl):
    return {"mlp": None, "quintic": "quintic"}.get(impl, "cheb")


def _compare(cfg, system, impl, seed=0):
    pos, typ, nlist, box = system
    p_jax, p_t = _both(cfg, seed, _table_kind(impl))
    e_j, f_j, w_j = jax_dp.dp_energy_forces(
        p_jax, cfg, jnp.asarray(pos), jnp.asarray(nlist), jnp.asarray(typ),
        jnp.asarray(box), impl=impl)
    e_t, f_t, w_t = dp_model.dp_energy_forces(
        p_t, cfg, torch.from_numpy(pos), torch.from_numpy(nlist).long(),
        torch.from_numpy(typ).long(), torch.from_numpy(box), impl=impl)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-5)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=2e-5)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=2e-4)


@pytest.mark.parametrize("impl", ["mlp", "quintic", "cheb", "cheb_pallas"])
def test_energy_forces_virial_copper(tiny_cfg, impl):
    _compare(tiny_cfg, _copper(tiny_cfg), impl)


@pytest.mark.parametrize("impl", ["mlp", "quintic", "cheb", "cheb_pallas"])
def test_energy_forces_virial_water(tiny_water_cfg, impl):
    """Two neighbor-type sections (strided section views before the fused
    wrapper) and the per-center-type fitting mix."""
    _compare(tiny_water_cfg, _water(tiny_water_cfg), impl, seed=1)


@pytest.mark.parametrize("impl", ["mlp", "cheb_pallas"])
def test_energy_forces_water_two_sided_nets(tiny_water_cfg, impl):
    """type_one_side=False: one T per center type, mixed with ``where``."""
    cfg = dataclasses.replace(tiny_water_cfg, type_one_side=False)
    _compare(cfg, _water(cfg), impl, seed=2)


def test_atomic_energy_per_atom(tiny_cfg):
    pos, typ, nlist, box = _copper(tiny_cfg, seed=3)
    p_jax, p_t = _both(tiny_cfg, 0, None)
    rij, nmask = jax_dp.gather_rij(jnp.asarray(pos), jnp.asarray(nlist),
                                   jnp.asarray(box))
    e_j = jax_dp.dp_atomic_energy(p_jax, tiny_cfg, rij, nmask,
                                  jnp.asarray(typ), impl="mlp")
    rij_t, nmask_t = dp_model.gather_rij(torch.from_numpy(pos),
                                         torch.from_numpy(nlist).long(),
                                         torch.from_numpy(box))
    np.testing.assert_allclose(rij_t.numpy(), np.asarray(rij), atol=1e-6)
    assert (nmask_t.numpy() == np.asarray(nmask)).all()
    e_t = dp_model.dp_atomic_energy(p_t, tiny_cfg, rij_t, nmask_t,
                                    torch.from_numpy(typ).long(), impl="mlp")
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5,
                               atol=1e-6)


def test_nsel_norm_pins_descriptor_normalization(tiny_cfg):
    """An escalated slot layout (more -1 padding) with nsel_norm pinned to
    the native capacity gives the same energy and forces."""
    pos, typ, nlist, box = _copper(tiny_cfg, seed=4)
    _, p_t = _both(tiny_cfg, 0, "cheb")
    args = (torch.from_numpy(pos),)
    rest = (torch.from_numpy(typ).long(), torch.from_numpy(box))
    e0, f0, _ = dp_model.dp_energy_forces(
        p_t, tiny_cfg, *args, torch.from_numpy(nlist).long(), *rest,
        impl="cheb_pallas")
    wide = np.concatenate([nlist, -np.ones((nlist.shape[0], 32), nlist.dtype)],
                          axis=1)
    cfg_wide = dataclasses.replace(tiny_cfg, sel=(wide.shape[1],))
    e1, f1, _ = dp_model.dp_energy_forces(
        p_t, cfg_wide, *args, torch.from_numpy(wide).long(), *rest,
        impl="cheb_pallas", nsel_norm=tiny_cfg.nsel)
    np.testing.assert_allclose(float(e1), float(e0), rtol=1e-6)
    np.testing.assert_allclose(f1.numpy(), f0.numpy(), atol=1e-6)


@pytest.mark.parametrize("cfg_name", ["tiny_cfg", "tiny_water_cfg"])
def test_cheb_table_matches_reference(cfg_name, request):
    cfg = request.getfixturevalue(cfg_name)
    p_jax = jax_dp.init_dp_params(jax.random.PRNGKey(5), cfg)
    t_jax = jax_dp.tabulate_model(p_jax, cfg, "cheb")["table"]["nets"]
    p_t = bridge.params_from_numpy(_to_numpy(p_jax), device=CPU)
    t_t = dp_model.tabulate_model(p_t, cfg, "cheb")["table"]["nets"]
    assert set(t_t) == set(t_jax)
    for key, tab in t_jax.items():
        np.testing.assert_allclose(t_t[key]["coeffs"].numpy(),
                                   np.asarray(tab["coeffs"]), rtol=1e-5,
                                   atol=1e-5)
        assert (t_t[key]["lower"], t_t[key]["upper"]) == \
            (tab["lower"], tab["upper"])


def test_init_matches_reference_layout(tiny_water_cfg):
    """Same keys, shapes and dtypes as the reference pytree; DeePMD scales."""
    p_jax = jax_dp.init_dp_params(jax.random.PRNGKey(0), tiny_water_cfg)
    p_t = dp_model.init_dp_params(torch.Generator().manual_seed(0),
                                  tiny_water_cfg, device=CPU)
    flat_j = jax.tree_util.tree_flatten_with_path(p_jax)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda x: x.numpy(), p_t))[0]
    assert [k for k, _ in flat_j] == [k for k, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        assert a.shape == b.shape and str(a.dtype) == str(b.dtype)
    big = layers.init_linear(torch.Generator().manual_seed(1), 400, 600,
                             torch.float32, torch.device(CPU))
    assert abs(float(big["w"].std()) - 1 / 1000 ** 0.5) < 2e-3
    assert abs(float(big["b"].std()) - 0.1) < 2e-2


def test_env_stats_match_reference(tiny_water_cfg):
    pos, typ, nlist, box = _water(tiny_water_cfg)
    rij, nmask = jax_dp.gather_rij(jnp.asarray(pos), jnp.asarray(nlist),
                                   jnp.asarray(box))
    env, _ = jax_descriptor.env_matrix(rij, nmask, tiny_water_cfg.rcut_smth,
                                       tiny_water_cfg.rcut)
    d_j = jax_descriptor.compute_env_stats(env, nmask, jnp.asarray(typ), 2)
    env_t, _ = descriptor.env_matrix(torch.from_numpy(np.array(rij)),
                                     torch.from_numpy(np.array(nmask)),
                                     tiny_water_cfg.rcut_smth,
                                     tiny_water_cfg.rcut)
    np.testing.assert_allclose(env_t.numpy(), np.asarray(env), atol=1e-6)
    d_t = descriptor.compute_env_stats(env_t, torch.from_numpy(
        np.array(nmask)), torch.from_numpy(typ).long(), 2)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5)


# ------------------------------------------ the force-and-virial reduction

def _reduction_inputs(seed, a, sections, rows, packed=True):
    """de, rij (A, S, 3) float32 and nlist (A, S) int64, -1 for padding:
    about half of each type section live (packed at its front, or not),
    the first centre with no live slot, the last with a full row. Padded
    slots hold finite garbage, which the plain path's mask must drop."""
    rng = np.random.default_rng(seed)
    nlist = np.full((a, sum(sections)), -1, np.int64)
    lo = 0
    for width in sections:
        live = rng.random((a, width)) < 0.5
        if packed:
            live = np.arange(width)[None, :] < live.sum(1)[:, None]
        live[0], live[-1] = False, True
        nlist[:, lo:lo + width] = np.where(
            live, rng.integers(0, rows, (a, width)), -1)
        lo += width
    de = rng.normal(size=(*nlist.shape, 3)).astype(np.float32)
    rij = rng.uniform(-4.0, 4.0, (*nlist.shape, 3)).astype(np.float32)
    return de, rij, nlist


def _reduction_loop(de, rij, nlist, rows, offset):
    """Forces and virial by a float64 double loop over centres and slots:
    -de on the neighbour, +de on the centre, W -= r (x) de; padding
    skipped."""
    f = np.zeros((rows, 3))
    w = np.zeros((3, 3))
    for a in range(nlist.shape[0]):
        for n in range(nlist.shape[1]):
            j = nlist[a, n]
            if j < 0:
                continue
            d = de[a, n].astype(np.float64)
            f[j] -= d
            f[offset + a] += d
            w -= np.outer(rij[a, n].astype(np.float64), d)
    return f, w


# (A, sections, rows, offset, packed): the single-process layout, water's
# two sections, ``md/domain._pair_forces``'s centres at a row offset of a
# larger array, and live slots not packed (the plain path assumes nothing)
_REDUCTION_CASES = {
    "single_process": (9, (12,), 9, 0, True),
    "two_sections": (8, (6, 10), 8, 0, True),
    "row_offset": (6, (7,), 15, 5, True),
    "unpacked": (7, (5, 6), 11, 2, False),
}


@pytest.mark.parametrize("case", list(_REDUCTION_CASES))
def test_force_reduction_plain_path_matches_a_double_loop(case):
    from repro_torch.kernels.dp_fused import force

    a, sections, rows, offset, packed = _REDUCTION_CASES[case]
    de, rij, nlist = _reduction_inputs(len(case), a, sections, rows, packed)
    f, w = force.prod_force_virial(torch.from_numpy(de),
                                   torch.from_numpy(rij),
                                   torch.from_numpy(nlist), rows, offset)
    f_want, w_want = _reduction_loop(de, rij, nlist, rows, offset)
    # float32 sums of a few dozen terms of order 1 (forces) and 10 (virial)
    np.testing.assert_allclose(f.numpy(), f_want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), w_want, rtol=1e-5, atol=1e-4)


def _index_add_forces(energy_of_rij, pos, nlist, box):
    """``energy_forces_from_rij`` as it was written before the reduction
    had a wrapper: mask, ``index_add_``, row sum, einsum."""
    rij, nmask = dp_model.gather_rij(pos, nlist, box)
    rij = rij.requires_grad_(True)
    e = energy_of_rij(rij, nmask)
    (de_drij,) = torch.autograd.grad(e, rij)
    de = de_drij * nmask[..., None].to(de_drij.dtype)
    j = torch.clamp(nlist, min=0).reshape(-1)
    f = torch.zeros_like(pos).index_add_(0, j, -de.reshape(-1, 3))
    f = f + de.sum(dim=1)
    virial = -torch.einsum("ijk,ijl->kl", rij.detach(), de)
    return e.detach(), f, virial


@pytest.mark.parametrize("system", ["copper", "water", "lj"])
def test_energy_forces_on_the_cpu_equal_the_index_add_formula(
        system, tiny_cfg, tiny_water_cfg):
    """On the CPU the wrapper takes the plain path: the same energy, forces
    and virial as the ``index_add_`` formula, bit for bit."""
    from repro_torch.md import api

    cfg = tiny_water_cfg if system == "water" else tiny_cfg
    pos, typ, nlist, box = (_water(cfg) if system == "water"
                            else _copper(cfg, seed=5))
    pos, box = torch.from_numpy(pos), torch.from_numpy(box)
    nlist, typ = torch.from_numpy(nlist).long(), torch.from_numpy(typ).long()
    if system == "lj":
        pot = api.LJPotential(rcut_lj=cfg.rcut)

        def energy(rij, nmask):
            return torch.sum(pot.atomic_energy({}, rij, nmask, typ))
    else:
        _, p_t = _both(cfg, 0, "cheb")
        amask = torch.ones(pos.shape[0])

        def energy(rij, nmask):
            return dp_model.dp_energy(p_t, cfg, rij, nmask, typ, amask,
                                      "cheb_pallas")
    got = dp_model.energy_forces_from_rij(energy, pos, nlist, box)
    want = _index_add_forces(energy, pos, nlist, box)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
