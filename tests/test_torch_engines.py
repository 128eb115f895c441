"""The port's three stepping engines against the reference's, and the outer
engine's own machinery (chunk replay, grid re-derivation), on the CPU.

The 99-step protocol (dt 1 fs, 330 K start, rebuild every 50 with a 2 A
skin) runs in both packages on every engine: NVE with the tiny DP model
(the reference at impl="cheb", the port at "cheb_pallas", whose
autograd.Function takes the plain path here), and Berendsen NPT with LJ,
which draws no noise. The reference's threefry velocities are fed to the
port. Tolerances are the slice's: thermo rtol 1e-5, positions 1e-4 A by
minimum image (a wrapped atom sits at 0 in one run and at L in the
other), velocities 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import dp_model as jax_dp  # noqa: E402
from repro.md import api as jax_api  # noqa: E402
from repro.md import integrator as jax_integrator  # noqa: E402
from repro.md import lattice as jax_lattice  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.md import (  # noqa: E402
    api, driver, integrator, lattice, neighbors, stepper)

# One torch thread: the suite's pytest workers already occupy the cores.
torch.set_num_threads(1)

CPU = "cpu"
ENGINES = ("python", "scan", "outer")
PROTOCOL = dict(steps=99, dt_fs=1.0, temp_k=330.0, rebuild_every=50,
                thermo_every=50, skin=2.0)


def _nve_case(tiny_cfg, tiny_params):
    cfg = dataclasses.replace(tiny_cfg, sel=(96,))   # no escalation needed
    p_jax = jax_dp.tabulate_model(tiny_params, cfg, "cheb")
    return (jax_api.make_potential("dp", cfg, impl="cheb"), jax_api.NVE(),
            None, p_jax,
            api.make_potential("dp", cfg, impl="cheb_pallas"), api.NVE(),
            None, bridge.params_from_numpy(jax.tree.map(np.asarray, p_jax),
                                           CPU))


def _npt_case():
    kw = dict(sel=(128,), rcut_lj=4.0)
    th = dict(temp_k=330.0, tau_fs=100.0)
    bk = dict(pressure_gpa=0.0, tau_fs=100.0, compressibility_per_gpa=0.01)
    return (jax_api.LJPotential(**kw), jax_api.BerendsenThermostat(**th),
            jax_api.BerendsenBarostat(**bk), {},
            api.LJPotential(**kw), api.BerendsenThermostat(**th),
            api.BerendsenBarostat(**bk), {})


@pytest.fixture(scope="module")
def v0():
    """The reference's Maxwell-Boltzmann start for fcc_copper(5,5,5)."""
    _, typ, _ = jax_lattice.fcc_copper(5, 5, 5)
    masses = jnp.asarray(jax_lattice.masses_for(("Cu",), typ))
    return np.array(jax_integrator.init_velocities(jax.random.PRNGKey(0),
                                                   masses, 330.0))


def _min_image(d, box):
    return d - box * np.round(d / box)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", ["nve_dp", "npt_berendsen_lj"])
def test_engine_matches_reference_over_99_steps(case, engine, tiny_cfg,
                                                tiny_params, v0, monkeypatch):
    (pot_j, ens_j, baro_j, p_j, pot_t, ens_t, baro_t, p_t) = (
        _nve_case(tiny_cfg, tiny_params) if case == "nve_dp" else _npt_case())
    pos, typ, box = lattice.fcc_copper(5, 5, 5)
    r_j = jax_api.Simulation(jax_api.SimulationSpec(
        pot_j, ens_j, barostat=baro_j, engine=engine, **PROTOCOL)).run(
            p_j, pos, typ, box)
    monkeypatch.setattr(integrator, "init_velocities",
                        lambda gen, masses, temp_k, amask=None: v0)
    r_t = api.Simulation(api.SimulationSpec(
        pot_t, ens_t, barostat=baro_t, engine=engine, **PROTOCOL)).run(
            p_t, pos, typ, box, device=CPU)

    assert r_t.engine == r_j.engine == engine
    assert r_t.host_syncs == r_j.host_syncs
    assert r_t.escalations == r_j.escalations
    assert r_t.grid_rebuilds == r_j.grid_rebuilds
    assert [row["step"] for row in r_t.thermo] == \
        [row["step"] for row in r_j.thermo] == [50, 99]
    for a, b in zip(r_t.thermo, r_j.thermo):
        assert set(a) == set(b)
        for key in ("pe", "ke", "etot", "vol"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-4,
                                       err_msg=key)
        np.testing.assert_allclose(a["press_gpa"], b["press_gpa"], rtol=1e-4,
                                   atol=1e-3)
    np.testing.assert_allclose(r_t.final_box, r_j.final_box, rtol=1e-6)
    np.testing.assert_allclose(
        _min_image(r_t.final_pos - r_j.final_pos, r_j.final_box), 0.0,
        atol=1e-4)
    np.testing.assert_allclose(r_t.final_vel, r_j.final_vel, atol=1e-5)
    assert r_t.stress.shape == (99, 3, 3)
    if baro_t is not None:      # the box moved, as in the reference
        assert not np.allclose(r_t.final_box, box)


def _dp_setup(tiny_cfg, sel=(64,)):
    cfg = dataclasses.replace(tiny_cfg, sel=sel)
    pot = api.make_potential("dp", cfg, impl="cheb_pallas")
    params = pot.init_params(torch.Generator().manual_seed(3), device=CPU)
    return cfg, pot, params


def test_outer_equals_scan_bit_for_bit_and_syncs_less(tiny_cfg):
    """On the CPU the outer engine's segment is the scan engine's host
    rebuild + step loop, op for op: the same trajectory, Langevin noise
    included, with one host sync per chunk instead of per segment."""
    _, pot, params = _dp_setup(tiny_cfg)
    pos, typ, box = lattice.fcc_copper(3, 3, 3)
    ens = api.NVTLangevin(temp_k=330.0, friction=0.05, seed=4)
    res = {e: api.Simulation(api.SimulationSpec(
        pot, ens, steps=99, rebuild_every=50, skin=0.5, engine=e)).run(
            params, pos, typ, box, device=CPU) for e in ("scan", "outer")}
    np.testing.assert_array_equal(res["outer"].final_pos,
                                  res["scan"].final_pos)
    np.testing.assert_array_equal(res["outer"].final_vel,
                                  res["scan"].final_vel)
    assert res["outer"].thermo == res["scan"].thermo
    assert (res["outer"].host_syncs, res["scan"].host_syncs) == (3, 4)
    assert res["outer"].graph_captures == 0       # eager on the CPU


def test_outer_chunk_replay_after_overflow_matches_ample_run(tiny_cfg):
    """A chunk whose on-device rebuilds overflow a small capacity replays
    from its snapshot with escalated capacities — and with the Langevin
    generator set back, so it redraws the same noise — and lands on the
    ample-capacity trajectory."""
    cfg, pot, params = _dp_setup(tiny_cfg, sel=(48,))
    pos_np, typ_np, box_np = lattice.fcc_copper(3, 3, 3)
    pos = torch.tensor(pos_np, dtype=torch.float32)
    typ = torch.tensor(typ_np).long()
    boxt = stepper.pack_box(box_np, torch.device(CPU))
    masses = torch.full((len(pos),), lattice.MASS["Cu"])
    vel = torch.as_tensor(integrator.init_velocities(
        torch.Generator().manual_seed(0), masses, 330.0))
    ens = api.NVTLangevin(temp_k=330.0, friction=0.1, seed=7)
    kw = dict(steps=40, dt_fs=1.0, rebuild_every=10, thermo_every=20,
              chunk_segments=8, escalation=None)

    spec_ok = neighbors.NeighborSpec(rcut_nbr=cfg.rcut + 0.5, sel=cfg.sel)
    build_ok = stepper.build_neighbors_escalating(cfg, spec_ok, box_np, pos,
                                                  typ)
    assert build_ok.escalations == 0
    _, f0, _ = pot.energy_forces(params, pos, typ, build_ok.nlist, box=boxt)

    def run(build):
        ovf = torch.zeros((), dtype=torch.int32)
        carry = stepper.OuterCarry(pos, vel, f0, ovf, ens.init_state(CPU),
                                   boxt, ())
        return driver._run_md_outer(pot, ens, params, carry, typ, box_np,
                                    masses, build, torch.device(CPU), **kw)

    ref = run(build_ok)
    small = stepper.NeighborBuild(
        build_ok.nlist, dataclasses.replace(cfg, sel=(4,)),
        dataclasses.replace(spec_ok, sel=(4,)), 0)
    res = run(small)
    assert ref.escalations == 0 and res.escalations > 0
    assert res.overflow_worst > 0 and res.sel[0] >= 42
    assert res.host_syncs == ref.host_syncs + res.escalations
    np.testing.assert_allclose(res.final_pos, ref.final_pos, atol=1e-6)
    np.testing.assert_allclose(res.final_vel, ref.final_vel, atol=1e-6)
    assert [t["step"] for t in res.thermo] == [t["step"] for t in ref.thermo]
    for a, b in zip(res.thermo, ref.thermo):
        assert abs(a["pe"] - b["pe"]) < 1e-5 and abs(a["ke"] - b["ke"]) < 1e-5


@pytest.mark.parametrize("engine", ENGINES)
def test_grid_is_rederived_when_the_box_crosses_a_cell_count(engine):
    """A +120 GPa Berendsen squeeze shrinks fcc_copper(4,4,4) (14.5 A: 3
    cells of 4.5 A) through the 3-cell boundary: each engine re-derives the
    grid (scan and python at a rebuild, outer by a chunk replay on
    GRID_INVALID) and the run stays finite."""
    pos, typ, box = lattice.fcc_copper(4, 4, 4)
    res = driver.run_md(
        None, {}, pos, typ, box, device=CPU, engine=engine,
        potential=api.LJPotential(sel=(64,), rcut_lj=4.0),
        ensemble=api.BerendsenThermostat(temp_k=50.0, tau_fs=50.0),
        barostat=api.BerendsenBarostat(pressure_gpa=120.0, tau_fs=30.0,
                                       compressibility_per_gpa=0.01),
        steps=120, temp_k=50.0, skin=0.5, rebuild_every=5, thermo_every=20)
    assert res.final_box[0] < 0.95 * box[0]
    assert res.grid_rebuilds > 0, (res.final_box, res.grid_rebuilds)
    assert np.all(np.isfinite(res.final_pos))


def test_chunk_schedule_and_escalation_fold_match_reference():
    from repro.md import stepper as jax_stepper
    for steps, every, chunk in [(99, 50, 8), (400, 50, 3), (7, 5, 1),
                                (0, 10, 2), (100, 50, 1)]:
        assert stepper.chunk_schedule(steps, every, chunk) == \
            jax_stepper.chunk_schedule(steps, every, chunk)
    with pytest.raises(ValueError):
        stepper.chunk_schedule(10, 5, 0)
    pol_t, pol_j = stepper.EscalationPolicy(), jax_stepper.EscalationPolicy()
    for n in (4, 48, 512):
        for scale in (1.0, 1.3, 2.0, 3.7):
            assert pol_t.grow(n, scale) == pol_j.grow(n, scale)
    a, b = np.array([10.0, 10, 10]), np.array([8.0, 9, 10])
    assert pol_t.volume_scale(a, b) == pol_j.volume_scale(a, b)
    assert pol_t.volume_scale(b, a) == 1.0


def test_snapshot_restores_tensors_and_generators():
    gen = torch.Generator().manual_seed(5)
    carry = stepper.OuterCarry(torch.zeros(3), torch.ones(3), torch.ones(3),
                               torch.zeros((), dtype=torch.int32),
                               {"gen": gen}, torch.ones(3), ())
    snap = stepper.snapshot(carry)
    first = torch.randn(4, generator=gen)
    carry.pos.add_(1.0)
    back = stepper.restore(snap)
    assert back.ens["gen"] is gen and not back.pos.any()
    assert torch.equal(torch.randn(4, generator=gen), first)
    assert stepper.generators_of(carry) == [gen]


def test_python_engine_refuses_an_overflowing_start(tiny_cfg):
    _, pot, params = _dp_setup(tiny_cfg, sel=(8,))
    pos, typ, box = lattice.fcc_copper(3, 3, 3)
    with pytest.raises(RuntimeError, match="overflow"):
        api.Simulation(api.SimulationSpec(pot, steps=2, engine="python",
                                          skin=0.5)).run(
            params, pos, typ, box, device=CPU)
