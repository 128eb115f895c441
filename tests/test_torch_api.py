"""The port's simulation API against the reference: water_box, LJ, the
thermostats and barostats, the registries, and the port's own bit-exact
guarantees (friction 0 == NVE, compressibility 0 == fixed box, ``run_md``
== ``Simulation.run``), all on the CPU.

Threefry cannot be matched, so the stochastic parts are held with the
reference's own draws: the test splits the reference's key as its
``finalize``/``apply`` does, draws the same standard normals, and hands them
to the port's deterministic halves (``NVTLangevin.o_step``,
``StochasticCellRescaleBarostat.rescale``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import dp_model as jax_dp  # noqa: E402
from repro.md import api as jax_api  # noqa: E402
from repro.md import lattice as jax_lattice  # noqa: E402
from repro.md import neighbors as jax_neighbors  # noqa: E402
from repro_torch.md import api, driver, lattice  # noqa: E402

# One torch thread: the suite's pytest workers already occupy the cores.
torch.set_num_threads(1)

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x))


def _lj_system(nx=3, jitter=0.15, seed=0):
    pos, typ, box = jax_lattice.fcc_copper(nx, nx, nx)
    rng = np.random.default_rng(seed)
    pos = np.mod(pos + rng.normal(0, jitter, pos.shape), box)
    lj_kw = dict(sel=(64,), rcut_lj=4.0)
    spec = jax_neighbors.NeighborSpec(rcut_nbr=4.5, sel=(64,))
    nlist, ovf = jax_neighbors.brute_force_neighbors(
        jnp.asarray(pos, jnp.float32), jnp.asarray(typ), spec,
        jnp.asarray(box, jnp.float32))
    assert int(ovf) <= 0
    return (lj_kw, pos.astype(np.float32), typ, np.array(nlist),
            box.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 11])
def test_water_box_equals_reference(seed):
    for shape in ((1, 1, 1), (2, 1, 3)):
        got = lattice.water_box(*shape, seed=seed)
        want = jax_lattice.water_box(*shape, seed=seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_lj_energy_forces_virial_match_reference():
    lj_kw, pos, typ, nlist, box = _lj_system()
    e_j, f_j, s_j = jax_api.LJPotential(**lj_kw).energy_forces(
        {}, jnp.asarray(pos), jnp.asarray(typ), jnp.asarray(nlist),
        box=jnp.asarray(box))
    e_t, f_t, s_t = api.LJPotential(**lj_kw).energy_forces(
        {}, _t(pos), _t(typ).long(), _t(nlist).long(), box=_t(box))
    # f32 sums in another order; the jittered LJ forces and virial are
    # large (|W| ~ 450 eV), so atol scales with the largest entry
    f_j, w_j = np.asarray(f_j), np.asarray(s_j["virial"])
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-5)
    np.testing.assert_allclose(f_t.numpy(), f_j,
                               atol=2e-5 * max(1.0, np.abs(f_j).max()))
    np.testing.assert_allclose(s_t["virial"].numpy(), w_j, rtol=1e-5,
                               atol=1e-5 * np.abs(w_j).max())
    assert float(f_t.sum(0).abs().max()) < 1e-4        # Newton's third law


def test_lj_pairs_beyond_rcut_contribute_zero():
    lj = api.LJPotential(sel=(4,), rcut_lj=4.0)
    box = torch.tensor([30.0, 30.0, 30.0])
    nlist = torch.tensor([[1, -1, -1, -1], [0, -1, -1, -1]])
    for d, live in ((4.01, False), (6.5, False), (3.9, True)):
        pos = torch.tensor([[5.0, 5.0, 5.0], [5.0 + d, 5.0, 5.0]])
        e, f, stats = lj.energy_forces({}, pos, torch.zeros(2).long(), nlist,
                                       box=box)
        if live:
            assert float(f.abs().max()) > 0 and float(e) != 0.0
        else:
            assert float(e) == 0.0
            assert not f.any() and not stats["virial"].any()


def _thermal_state(n=64, seed=3):
    rng = np.random.default_rng(seed)
    vel = (rng.normal(size=(n, 3)) * 0.01).astype(np.float32)
    masses = rng.choice([63.546, 15.999, 1.008], n).astype(np.float32)
    return vel, masses


def test_berendsen_thermostat_matches_reference():
    vel, masses = _thermal_state()
    for temp_k in (50.0, 2000.0):
        v_j, _ = jax_api.BerendsenThermostat(temp_k, 40.0).finalize(
            jnp.asarray(vel), jnp.asarray(masses), 1.0, ())
        v_t, state = api.BerendsenThermostat(temp_k, 40.0).finalize(
            _t(vel), _t(masses), 1.0, ())
        assert state == ()
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=2e-6,
                                   atol=1e-9)


def test_langevin_o_step_matches_reference_with_its_noise():
    vel, masses = _thermal_state()
    ens_j = jax_api.NVTLangevin(temp_k=330.0, friction=0.2, seed=5)
    state = ens_j.init_state()
    v_j, _ = ens_j.finalize(jnp.asarray(vel), jnp.asarray(masses), 1.0, state)
    _, sub = jax.random.split(state["key"])           # as finalize splits
    xi = np.asarray(jax.random.normal(sub, vel.shape, jnp.float32))
    ens_t = api.NVTLangevin(temp_k=330.0, friction=0.2, seed=5)
    v_t = ens_t.o_step(_t(vel), _t(masses), 1.0, _t(xi))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-5,
                               atol=1e-7)
    # the port's own draw is live, and comes from the carried generator
    st = ens_t.init_state(CPU)
    g0 = st["gen"].get_state()
    v1, st = ens_t.finalize(_t(vel), _t(masses), 1.0, st)
    v2, st = ens_t.finalize(_t(vel), _t(masses), 1.0, st)
    assert not torch.equal(v1, v2)
    st["gen"].set_state(g0)
    assert torch.equal(ens_t.finalize(_t(vel), _t(masses), 1.0, st)[0], v1)


def _stress(p_ev_a3, seed=4):
    rng = np.random.default_rng(seed)
    s = np.diag([p_ev_a3] * 3) + rng.normal(0, 1e-3, (3, 3))
    return s.astype(np.float32)


def test_berendsen_barostat_matches_reference():
    rng = np.random.default_rng(8)
    box = np.array([18.1, 18.2, 18.3], np.float32)
    pos = rng.uniform(0, 18, (40, 3)).astype(np.float32)
    vel = rng.normal(size=(40, 3)).astype(np.float32) * 0.01
    for p_gpa, p0 in ((3.0, 0.0), (-2.0, 1.0), (400.0, 0.0)):   # last clamps
        stress = _stress(p_gpa / 160.21766208)
        kw = dict(pressure_gpa=p0, tau_fs=100.0, compressibility_per_gpa=0.01)
        b_j, x_j, v_j, _ = jax_api.BerendsenBarostat(**kw).apply(
            jnp.asarray(box), jnp.asarray(pos), jnp.asarray(vel),
            jnp.asarray(stress), (), 1.0)
        b_t, x_t, v_t, st = api.BerendsenBarostat(**kw).apply(
            _t(box), _t(pos), _t(vel), _t(stress), (), 1.0)
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-6)
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-6,
                                   atol=1e-6)
        assert torch.equal(v_t, _t(vel)) and st == ()


def test_scr_barostat_matches_reference_with_its_noise():
    rng = np.random.default_rng(9)
    box = np.array([14.5, 14.6, 14.4], np.float32)
    pos = rng.uniform(0, 14, (40, 3)).astype(np.float32)
    vel = rng.normal(size=(40, 3)).astype(np.float32) * 0.01
    kw = dict(pressure_gpa=1.0, tau_fs=50.0, compressibility_per_gpa=0.02,
              temp_k=500.0, seed=3)
    baro_j = jax_api.StochasticCellRescaleBarostat(**kw)
    baro_t = api.StochasticCellRescaleBarostat(**kw)
    for p_gpa in (4.0, -1.0):
        stress = _stress(p_gpa / 160.21766208)
        state = baro_j.init_state()
        b_j, x_j, v_j, _ = baro_j.apply(
            jnp.asarray(box), jnp.asarray(pos), jnp.asarray(vel),
            jnp.asarray(stress), state, 1.0)
        _, sub = jax.random.split(state["key"])       # as apply splits
        xi = torch.tensor(float(jax.random.normal(sub, ())))
        b_t, x_t, v_t = baro_t.rescale(_t(box), _t(pos), _t(vel),
                                       _t(stress), xi, 1.0)
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-6)
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-6)


def test_registries_match_reference_and_every_name_builds(tiny_cfg):
    assert api.POTENTIAL_CHOICES == jax_api.POTENTIAL_CHOICES
    assert api.ENSEMBLE_CHOICES == jax_api.ENSEMBLE_CHOICES
    assert api.BAROSTAT_CHOICES == jax_api.BAROSTAT_CHOICES
    for name in api.POTENTIAL_CHOICES:
        pot_t = api.make_potential(name, tiny_cfg)
        pot_j = jax_api.make_potential(name, tiny_cfg)
        assert type(pot_t).__name__ == type(pot_j).__name__
        assert getattr(pot_t, "impl", None) == getattr(pot_j, "impl", None)
        hash(pot_t)
    for impl in ("mlp", "quintic", "cheb", "cheb_pallas"):
        pot_t = api.make_potential("dp", tiny_cfg, impl=impl)
        pot_j = jax_api.make_potential("dp", tiny_cfg, impl=impl)
        assert type(pot_t).__name__ == type(pot_j).__name__
        assert getattr(pot_t, "kind", None) == getattr(pot_j, "kind", None)
    assert api.TabulatedDPPotential(tiny_cfg).impl == "quintic"
    for name in api.ENSEMBLE_CHOICES:
        for p in (None, 2.0):
            ens_t, baro_t = api.resolve_ensemble(name, pressure_gpa=p)
            ens_j, baro_j = jax_api.resolve_ensemble(name, pressure_gpa=p)
            assert type(ens_t).__name__ == type(ens_j).__name__
            assert type(baro_t).__name__ == type(baro_j).__name__
            spec = api.SimulationSpec(api.make_potential("lj"),
                                      ensemble=name, pressure_gpa=p)
            assert type(spec.ensemble).__name__ == type(ens_j).__name__
            assert type(spec.barostat).__name__ == type(baro_j).__name__
    for name in api.BAROSTAT_CHOICES:
        assert type(api.make_barostat(name)).__name__ == \
            type(jax_api.make_barostat(name)).__name__
    with pytest.raises(ValueError):
        api.make_barostat("mtk_full")
    with pytest.raises(ValueError):
        api.make_ensemble("npt_berendsen")
    spec = api.SimulationSpec(api.make_potential("lj"), pressure_gpa=0.5)
    assert isinstance(spec.barostat, api.BerendsenBarostat)


def test_prepare_params_rebuilds_the_other_kind(tiny_cfg):
    pot_q = api.make_potential("quintic", tiny_cfg)
    pot_c = api.make_potential("cheb", tiny_cfg)
    base = api.DPPotential(tiny_cfg).init_params(
        torch.Generator().manual_seed(0), device=CPU)
    pq = pot_q.prepare_params(base)
    assert pot_q.prepare_params(pq) is pq
    pc = pot_c.prepare_params(pq)
    assert all("upper" in t for t in pc["table"]["nets"].values())


# --------------------------------------- the port's bit-exact guarantees

def _lj_run(engine, **kw):
    pos, typ, box = lattice.fcc_copper(3, 3, 3)
    lj = api.LJPotential(sel=(64,), rcut_lj=4.0)
    spec = api.SimulationSpec(lj, steps=30, temp_k=200.0, skin=0.5,
                              rebuild_every=10, thermo_every=10,
                              engine=engine, **kw)
    return api.Simulation(spec).run({}, pos, typ, box, device=CPU)


def _same_run(a, b):
    np.testing.assert_array_equal(a.final_pos, b.final_pos)
    np.testing.assert_array_equal(a.final_vel, b.final_vel)
    np.testing.assert_array_equal(a.final_box, b.final_box)
    assert a.thermo == b.thermo


@pytest.mark.parametrize("engine", ["python", "scan", "outer"])
def test_zero_friction_langevin_is_nve_bit_for_bit(engine):
    nve = _lj_run(engine)
    _same_run(_lj_run(engine, ensemble=api.NVTLangevin(friction=0.0)), nve)
    assert _lj_run(engine, ensemble=api.NVTLangevin(friction=0.05)) \
        .thermo != nve.thermo


@pytest.mark.parametrize("engine", ["python", "scan", "outer"])
@pytest.mark.parametrize("baro", ["berendsen", "scr"])
def test_zero_compressibility_is_the_fixed_box_bit_for_bit(engine, baro):
    fixed = _lj_run(engine)
    frozen = _lj_run(engine, barostat=api.make_barostat(
        baro, compressibility_per_gpa=0.0))
    _same_run(frozen, fixed)
    moving = _lj_run(engine, barostat=api.make_barostat(baro, tau_fs=50.0))
    assert not np.array_equal(moving.final_box, fixed.final_box)


@pytest.mark.parametrize("engine", ["python", "scan", "outer"])
def test_run_md_shim_is_simulation_run_bit_for_bit(tiny_cfg, engine):
    cfg = tiny_cfg.__class__(**{**tiny_cfg.__dict__, "sel": (64,)})
    params = api.DPPotential(cfg).init_params(
        torch.Generator().manual_seed(1), device=CPU)
    pos, typ, box = lattice.fcc_copper(3, 3, 3)
    kw = dict(steps=12, rebuild_every=5, thermo_every=4, skin=0.5,
              engine=engine)
    shim = driver.run_md(cfg, params, pos, typ, box, device=CPU, **kw)
    spec = api.SimulationSpec(api.DPPotential(cfg, nsel_norm=cfg.nsel), **kw)
    _same_run(shim, api.Simulation(spec).run(params, pos, typ, box,
                                             device=CPU))


def test_dp_forces_through_quintic_rung_in_a_run(tiny_cfg):
    """The default tabulated kind runs a whole simulation."""
    pot = api.TabulatedDPPotential(tiny_cfg.__class__(
        **{**tiny_cfg.__dict__, "sel": (64,)}))
    params = pot.init_params(torch.Generator().manual_seed(2), device=CPU)
    assert all("step" in t for t in params["table"]["nets"].values())
    pos, typ, box = lattice.fcc_copper(3, 3, 3)
    res = api.Simulation(api.SimulationSpec(
        pot, steps=6, rebuild_every=3, skin=0.5)).run(params, pos, typ, box,
                                                      device=CPU)
    assert np.isfinite(res.thermo[-1]["etot"])
    p_jax = jax_dp.tabulate_model(
        jax_dp.init_dp_params(jax.random.PRNGKey(0), tiny_cfg), tiny_cfg,
        "quintic")
    assert set(p_jax["table"]["nets"]["0"]) == \
        set(params["table"]["nets"]["0"])
