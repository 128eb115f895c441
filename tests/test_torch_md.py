"""The port's MD layer against the reference: neighbor lists, integrator,
stepper helpers, and the whole 99-step NVE slice through ``Simulation.run``.

The reference draws its Maxwell-Boltzmann velocities from threefry, which
torch cannot reproduce, so the slice test feeds the reference's velocities
to the port through ``repro_torch.md.integrator.init_velocities``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import dp_model as jax_dp  # noqa: E402
from repro.md import api as jax_api  # noqa: E402
from repro.md import integrator as jax_integrator  # noqa: E402
from repro.md import lattice as jax_lattice  # noqa: E402
from repro.md import neighbors as jax_neighbors  # noqa: E402
from repro.md import stepper as jax_stepper  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.md import api, integrator, lattice, neighbors, stepper  # noqa: E402

# The suite runs several pytest workers on the machine's cores; torch's own
# intra-op threads on top of them oversubscribe the CPU and stall its
# thread pool (the 99-step slice ran 20x slower). The tensors here are small.
torch.set_num_threads(1)

CPU = "cpu"


def _sets(nlist, sel):
    """Per-atom, per-section neighbor sets (slot order may legally differ)."""
    nlist = np.asarray(nlist)
    bounds = np.cumsum((0,) + tuple(sel))
    return [[frozenset(int(j) for j in row[a:b] if j >= 0)
             for a, b in zip(bounds[:-1], bounds[1:])] for row in nlist]


def _jittered_copper(n, jitter=0.1, seed=0):
    pos, typ, box = jax_lattice.fcc_copper(n, n, n)
    rng = np.random.default_rng(seed)
    pos = np.mod(pos + rng.normal(0, jitter, pos.shape), box)
    return pos.astype(np.float32), typ, box


def _assert_same_lists(out_t, out_j, sel):
    (nl_t, ovf_t), (nl_j, ovf_j) = out_t, out_j
    assert int(ovf_t) == int(ovf_j)
    assert nl_t.shape == tuple(np.shape(nl_j))
    assert _sets(nl_t.numpy(), sel) == _sets(nl_j, sel)


@pytest.mark.parametrize("sel", [(48,), (24,)])
def test_brute_force_neighbors_match_reference(sel):
    pos, typ, box = _jittered_copper(2, seed=1)
    kw = dict(rcut_nbr=4.0, sel=sel)
    out_j = jax_neighbors.brute_force_neighbors(
        jnp.asarray(pos), jnp.asarray(typ), jax_neighbors.NeighborSpec(**kw),
        jnp.asarray(box, jnp.float32))
    out_t = neighbors.brute_force_neighbors(
        torch.from_numpy(pos), torch.from_numpy(typ).long(),
        neighbors.NeighborSpec(**kw), torch.tensor(box, dtype=torch.float32))
    _assert_same_lists(out_t, out_j, sel)


def test_brute_force_type_sections_match_reference():
    pos, typ, box = jax_lattice.water_box(1, 1, 1, seed=3)
    pos = pos.astype(np.float32)
    kw = dict(rcut_nbr=4.0, sel=(8, 32))       # O section overflows
    out_j = jax_neighbors.brute_force_neighbors(
        jnp.asarray(pos), jnp.asarray(typ), jax_neighbors.NeighborSpec(**kw),
        jnp.asarray(box, jnp.float32))
    out_t = neighbors.brute_force_neighbors(
        torch.from_numpy(pos), torch.from_numpy(typ).long(),
        neighbors.NeighborSpec(**kw), torch.tensor(box, dtype=torch.float32))
    assert int(out_t[1]) > 0
    _assert_same_lists(out_t, out_j, kw["sel"])


@pytest.mark.parametrize("sel,cap", [((48,), 64), ((80,), 104), ((80,), 12)])
@pytest.mark.parametrize("dynamic", [False, True])
def test_cell_list_matches_reference(sel, cap, dynamic):
    """fcc_copper(5,5,5) at rcut_nbr 6 gives 3 cells per side; (48,)
    overflows the slots and cap 12 the cell bins, with equal excess."""
    pos, typ, box = _jittered_copper(5, seed=2)
    kw = dict(rcut_nbr=6.0, sel=sel, cell_capacity=cap)
    fn_j = jax_neighbors.make_cell_list_fn(jax_neighbors.NeighborSpec(**kw),
                                           box, dynamic_box=dynamic)
    fn_t = neighbors.make_cell_list_fn(neighbors.NeighborSpec(**kw), box,
                                       dynamic_box=dynamic)
    args_j = (jnp.asarray(pos), jnp.asarray(typ))
    args_t = (torch.from_numpy(pos), torch.from_numpy(typ).long())
    if dynamic:
        args_j += (jnp.asarray(box, jnp.float32),)
        args_t += (torch.tensor(box, dtype=torch.float32),)
    _assert_same_lists(fn_t(*args_t), fn_j(*args_j), sel)


def test_dynamic_cell_list_flags_invalid_grid():
    pos, typ, box = _jittered_copper(5, seed=4)
    spec = neighbors.NeighborSpec(rcut_nbr=6.0, sel=(80,), cell_capacity=104)
    fn = neighbors.make_cell_list_fn(spec, box, dynamic_box=True)
    small = torch.tensor(box * 0.9, dtype=torch.float32)
    _, ovf = fn(torch.from_numpy(pos) * 0.9, torch.from_numpy(typ).long(),
                small)
    assert int(ovf) >= int(neighbors.GRID_INVALID)


def test_integrator_matches_reference():
    rng = np.random.default_rng(5)
    vel = rng.normal(size=(40, 3)).astype(np.float32) * 0.01
    force = rng.normal(size=(40, 3)).astype(np.float32)
    pos = rng.uniform(-2, 12, (40, 3)).astype(np.float32)
    masses = rng.uniform(1, 64, 40).astype(np.float32)
    box = np.array([10.0, 11.0, 9.0], np.float32)
    j = [jnp.asarray(x) for x in (vel, force, pos, masses, box)]
    t = [torch.from_numpy(x) for x in (vel, force, pos, masses, box)]
    pairs = [
        (jax_integrator.kinetic_energy(j[0], j[3]),
         integrator.kinetic_energy(t[0], t[3])),
        (jax_integrator.temperature(j[0], j[3]),
         integrator.temperature(t[0], t[3])),
        (jax_integrator.kinetic_tensor(j[0], j[3]),
         integrator.kinetic_tensor(t[0], t[3])),
        (jax_integrator.verlet_half_kick(j[0], j[1], j[3], 1.0),
         integrator.verlet_half_kick(t[0], t[1], t[3], 1.0)),
        (jax_integrator.verlet_drift(j[2], j[0] * 100, 1.0, j[4]),
         integrator.verlet_drift(t[2], t[0] * 100, 1.0, t[4])),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6,
                                   atol=1e-6)
    v = integrator.init_velocities(torch.Generator().manual_seed(0),
                                   torch.full((4000,), 63.546), 330.0)
    temp = float(integrator.temperature(v, torch.full((4000,), 63.546)))
    assert abs(temp - 330.0) < 20.0
    assert float((v * 63.546).sum(0).abs().max()) < 1e-2


def test_stepper_helpers_match_reference():
    for steps, every in [(99, 50), (100, 50), (7, 50), (0, 50)]:
        assert stepper.segment_schedule(steps, every) == \
            jax_stepper.segment_schedule(steps, every)
    with pytest.raises(ValueError):
        stepper.segment_schedule(10, 0)
    pol_t, pol_j = stepper.EscalationPolicy(), jax_stepper.EscalationPolicy()
    for n in (1, 7, 48, 64, 512, 824):
        assert pol_t.grow(n) == pol_j.grow(n)
    assert pol_t.grow(512) == 824 and pol_t.grow(64) == 104
    rng = np.random.default_rng(6)
    pe, ke, press, vol = (rng.normal(size=49) for _ in range(4))
    assert stepper.thermo_rows(pe, ke, 50, 99, 50, 500, press, vol) == \
        jax_stepper.thermo_rows(pe, ke, 50, 99, 50, 500, press, vol)
    assert stepper.grid_key_for(neighbors.NeighborSpec(6.0, (8,)),
                                np.array([18.17, 12.0, 6.5])) == (3, 2, 1)
    np.testing.assert_array_equal(stepper.box_lengths(np.diag([1., 2., 3.])),
                                  [1., 2., 3.])
    with pytest.raises(ValueError):
        stepper.box_lengths(np.ones((3, 3)))
    th = {"pe": torch.arange(3.0), "stress": torch.arange(27.0).view(3, 3, 3)}
    host = stepper.fetch_thermo(th)
    np.testing.assert_array_equal(host["stress"], th["stress"].numpy())
    np.testing.assert_array_equal(host["pe"], [0.0, 1.0, 2.0])


def _min_image(d, box):
    return d - box * np.round(d / box)


def test_99_step_nve_slice_matches_reference(tiny_cfg, tiny_params,
                                             monkeypatch):
    """The paper's protocol (NVE, 330 K, rebuild every 50 with a 2 A skin)
    on fcc_copper(5,5,5): the reference at impl="cheb" against the port at
    impl="cheb_pallas" (its autograd.Function on the plain path here). The
    first build escalates sel 48 -> 80 in both. Positions compare by their
    minimum-image difference (a wrapped atom sits at 0 in one run and at L
    in the other)."""
    pos, typ, box = lattice.fcc_copper(5, 5, 5)
    p_jax = jax_dp.tabulate_model(tiny_params, tiny_cfg, "cheb")
    pot_j = jax_api.make_potential("dp", tiny_cfg, impl="cheb")
    r_j = jax_api.Simulation(jax_api.SimulationSpec(
        pot_j, jax_api.NVE(), steps=99, engine="scan")).run(
            p_jax, pos, typ, box)

    masses = jnp.asarray(jax_lattice.masses_for(tiny_cfg.type_map, typ))
    v0 = np.array(jax_integrator.init_velocities(jax.random.PRNGKey(0),
                                                 masses, 330.0))
    monkeypatch.setattr(integrator, "init_velocities",
                        lambda gen, masses, temp_k, amask=None: v0)
    p_t = bridge.params_from_numpy(jax.tree.map(np.asarray, p_jax), CPU)
    pot_t = api.make_potential("dp", tiny_cfg, impl="cheb_pallas")
    r_t = api.Simulation(api.SimulationSpec(
        pot_t, api.NVE(), steps=99, engine="scan")).run(
            p_t, pos, typ, box, device=CPU)

    assert r_t.escalations == r_j.escalations == 1
    assert r_t.sel == (80,)
    assert r_t.host_syncs == r_j.host_syncs
    assert [row["step"] for row in r_t.thermo] == \
        [row["step"] for row in r_j.thermo] == [50, 99]
    for a, b in zip(r_t.thermo, r_j.thermo):
        for key in ("pe", "ke", "etot"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-4,
                                       err_msg=key)
    np.testing.assert_allclose(
        _min_image(r_t.final_pos - r_j.final_pos, box), 0.0, atol=1e-4)
    np.testing.assert_allclose(r_t.final_vel, r_j.final_vel, atol=1e-5)
