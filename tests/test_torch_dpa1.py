"""DPA-1 (``core/dpa1.py``, ``md/api.DPA1Potential``) on the CPU, held
against the benchmark's plain reference (``mdbench/reference/dpa1.py``,
which imports nothing of the port) on seeded weights at narrow widths, on
``water(1, 1, 1)``: 192 atoms in a 12.42 A box, rcut 4 A and a 2 A skin so
that rcut + skin stays under half the box.

Energy, forces and the virial of one evaluation; trajectories on the scan
and outer engines; the energy independent of the model's capacity;
invariance under slot permutation, rotation and translation; continuity as
a pair crosses rcut; a section that overflows grows and drops nothing; the
reference's TF32 control outside the tolerance. The file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_dpa1.py
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import dp_model, dpa1  # noqa: E402
from repro_torch.core.types import DPA1Config, DPConfig  # noqa: E402
from repro_torch.md import api, neighbors, stepper  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mdbench.reference import dpa1 as ref  # noqa: E402
from mdbench.reference import md as ref_md  # noqa: E402
from mdbench.reference.shared import neighbor_table  # noqa: E402
from mdbench.systems import water  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
RAW = {"ntypes": 2, "rcut": 4.0, "rcut_smth": 0.5, "sel": 40,
       "type_map": ["O", "H"], "embed_widths": [4, 8, 16],
       "axis_neuron": 4, "tebd_dim": 8, "attn": 16, "attn_layer": 2,
       "fit_widths": [16, 16, 16]}
CFG = DPA1Config(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in RAW.items()})
SKIN = 2.0
# the port against the reference, float32 both, in other orders of summation:
# energies to 1e-6 relative (a float32 sum of 192 atoms' ~0.2 eV), forces
# to 2e-6 eV/A absolute (the largest are ~1e-2: about 1e-4 relative, which
# covers the autograd of either side); the TF32 control reads 5e-3 eV and
# 1e-5 eV/A off, outside both
E_RTOL, F_ATOL = 1e-6, 2e-6


@pytest.fixture(scope="module")
def system():
    pos, typ, box = water.water((1, 1, 1), 0)
    pos = np.mod(pos, box).astype(np.float32)
    return (torch.as_tensor(pos), torch.as_tensor(typ, dtype=torch.int64),
            torch.as_tensor(box, dtype=torch.float32), pos, typ, box)


@pytest.fixture(scope="module")
def weights():
    return ref.weights(RAW, 0, CPU)


def _list(x, t, b, sel=(64, 128)):
    nlist, ovf = neighbors.brute_force_neighbors(
        x, t, neighbors.NeighborSpec(CFG.rcut + SKIN, sel), b)
    assert int(ovf) <= 0
    return nlist


def _reference(weights, x, t, b, precision="float32"):
    model = ref.Reference(RAW, weights, CPU, precision=precision)
    return model.energy_forces(x, t, b, neighbor_table(x, b, CFG.rcut + SKIN))


def test_energy_and_forces_match_the_reference(system, weights):
    x, t, b = system[:3]
    e, f, _, excess = dpa1.energy_forces(weights, CFG, x, _list(x, t, b), t,
                                         b)
    e_ref, f_ref = _reference(weights, x, t, b)
    assert int(excess) <= 0
    assert float(e) == pytest.approx(e_ref, rel=E_RTOL)
    assert float((f - f_ref).abs().max()) < F_ATOL
    assert float(f_ref.abs().max()) > 1e-3


def test_the_virial_is_the_references_strain_derivative(system, weights):
    """W_aa = -dE/d(eps_aa) of the reference under a stretch of axis a
    (positions and box), by central differences: float32 energies of ~36
    eV over a 2e-3 stretch leave ~1e-2 relative; the off-diagonal
    components of a rotation-invariant energy are symmetric."""
    x, t, b = system[:3]
    _, _, virial, _ = dpa1.energy_forces(weights, CFG, x, _list(x, t, b), t,
                                         b)
    h = 1e-3
    for a in range(3):
        scale = torch.ones(3)
        scale[a] = 1 + h
        up, _ = _reference(weights, x * scale, t, b * scale)
        scale[a] = 1 - h
        down, _ = _reference(weights, x * scale, t, b * scale)
        want = -(up - down) / (2 * h)
        assert float(virial[a, a]) == pytest.approx(want, rel=2e-2, abs=2e-3)
    assert torch.allclose(virial, virial.T, atol=1e-5)


@pytest.mark.parametrize("engine", ["scan", "outer"])
def test_a_trajectory_on_each_engine_matches_the_reference(system, weights,
                                                           engine):
    x, t, b, pos, typ, box = system
    pot = api.make_potential("dpa1", CFG)
    steps, seed = 12, 7
    res = api.Simulation(api.SimulationSpec(
        potential=pot, ensemble="nve", steps=steps, dt_fs=0.5,
        rebuild_every=6, thermo_every=1, skin=SKIN, seed=seed,
        engine=engine)).run(weights, pos, typ, box, device="cpu")
    model = ref.Reference(RAW, weights, CPU)
    mass = torch.as_tensor(ref_md.masses(CFG.type_map, typ),
                           dtype=torch.float32)
    vel = ref_md.start_velocities(seed, mass, 330.0)
    traj = ref_md.nve(model, x, vel, t, b, mass, 0.5, steps, SKIN)
    pe = np.asarray([row["pe"] for row in res.thermo])
    assert np.max(np.abs(pe - traj.pe)) / len(pos) < 1e-7
    d = res.final_pos - traj.pos.numpy()
    d -= box * np.round(d / box)
    assert np.max(np.abs(d)) < 1e-5
    assert np.max(np.abs(res.final_vel - traj.vel.numpy())) < 1e-7
    assert res.section_slots == CFG.sel and res.stress.shape == (steps, 3, 3)


def test_the_engines_give_the_same_stress(system, weights):
    pos, typ, box = system[3:]
    out = {}
    for engine in ("scan", "outer"):
        out[engine] = api.Simulation(api.SimulationSpec(
            potential=api.make_potential("dpa1", CFG), ensemble="nve",
            steps=6, dt_fs=0.5, rebuild_every=3, skin=SKIN, seed=3,
            engine=engine)).run(weights, pos, typ, box, device="cpu")
    assert np.allclose(out["scan"].stress, out["outer"].stress, rtol=0,
                       atol=1e-9)
    assert np.abs(out["scan"].stress).max() > 0


def test_the_energy_does_not_depend_on_the_capacity(system, weights):
    x, t, b = system[:3]
    nlist = _list(x, t, b)
    got = [dpa1.energy_forces(weights, CFG, x, nlist, t, b, cap=cap)
           for cap in (CFG.sel, 120, 160)]
    for e, f, v, _ in got[1:]:
        assert float(e) == pytest.approx(float(got[0][0]), rel=1e-6)
        assert torch.allclose(f, got[0][1], rtol=0, atol=1e-7)
        assert torch.allclose(v, got[0][2], rtol=1e-5, atol=1e-7)


def _rij(weights, x, t, b):
    mixed, _, _ = dpa1.compact(x, _list(x, t, b), b, CFG.rcut, CFG.sel)
    rij, nmask = dp_model.gather_rij(x, mixed, b)
    return rij, nmask, t[torch.clamp(mixed, min=0)]


def test_invariant_under_slot_order_rotation_and_translation(system, weights):
    x, t, b = system[:3]
    rij, nmask, nbr_type = _rij(weights, x, t, b)
    e0 = dpa1.atomic_energy(weights, CFG, rij, nmask, t, nbr_type)
    pot = api.make_potential("dpa1", CFG)
    assert torch.equal(pot.atomic_energy(weights, rij, nmask, t,
                                         nbr_type=nbr_type), e0)
    with pytest.raises(ValueError):
        pot.atomic_energy(weights, rij, nmask, t)
    gen = torch.Generator().manual_seed(1)
    perm = torch.stack([torch.randperm(CFG.sel, generator=gen)
                        for _ in range(len(x))])
    e_perm = dpa1.atomic_energy(
        weights, CFG, torch.gather(rij, 1, perm[..., None].expand(-1, -1, 3)),
        torch.gather(nmask, 1, perm), t, torch.gather(nbr_type, 1, perm))
    assert torch.allclose(e_perm, e0, rtol=0, atol=1e-6)
    q, _ = torch.linalg.qr(torch.randn(3, 3, generator=gen))
    e_rot = dpa1.atomic_energy(weights, CFG, rij @ q, nmask, t, nbr_type)
    assert torch.allclose(e_rot, e0, rtol=0, atol=1e-6)
    shift = torch.tensor([3.1, -7.7, 5.3])
    moved = torch.remainder(x + shift, b)
    e_a = dpa1.energy_forces(weights, CFG, x, _list(x, t, b), t, b)[0]
    e_b = dpa1.energy_forces(weights, CFG, moved, _list(moved, t, b), t,
                             b)[0]
    assert float(e_b) == pytest.approx(float(e_a), rel=1e-6)


def test_smooth_as_a_pair_crosses_rcut(weights):
    """Three atoms in a large box: one slides across rcut; the energy and
    forces just inside and just outside differ by no more than the switch
    leaves (w ~ 10 (d / 3.5)^3 at a distance d from rcut) and the e^-20
    that the gone slot no longer adds."""
    box = torch.full((3,), 30.0)
    typ = torch.tensor([0, 1, 1])

    def at(r):
        x = torch.tensor([[10.0, 10.0, 10.0], [11.8, 10.0, 10.0],
                          [10.0, 10.0 + r, 10.0]])
        nlist = _list(x, typ, box, sel=(4, 4))
        e, f, _, _ = dpa1.energy_forces(weights, CFG, x, nlist, typ, box)
        return float(e), f

    d = 1e-3
    e_in, f_in = at(CFG.rcut - d)
    e_out, f_out = at(CFG.rcut + d)
    assert abs(e_in - e_out) < 1e-6
    assert float((f_in - f_out).abs().max()) < 1e-5
    e_near, _ = at(2.0)
    assert abs(e_near - e_out) > 5e-5     # the pair does count inside


def test_make_potential_wants_a_dpa1_config():
    with pytest.raises(ValueError):
        api.make_potential("dpa1", DPConfig())
    pot = api.make_potential("dpa1", CFG)
    assert pot.sel == (CFG.sel, CFG.sel) and pot.slots == CFG.sel
    assert pot.with_layout((64, 96)).with_capacity(48).slots == 48
    assert pot.with_capacity(48).with_layout((64, 96)).sel == (64, 96)


def test_compact_reports_what_it_cannot_take(system):
    x, t, b = system[:3]
    nlist = _list(x, t, b)
    mixed, excess, live = dpa1.compact(x, nlist, b, CFG.rcut, 8)
    inside = (neighbor_table(x, b, CFG.rcut) >= 0).sum(dim=1)
    assert int(excess) == int(inside.max()) - 8 > 0
    assert int(live) == int(inside.sum())
    assert ((mixed >= 0).sum(dim=1) == torch.clamp(inside, max=8)).all()


def _escalations(calls):
    return [s.attrs for s in calls[-1].spans if s.name == "model.escalate"]


@pytest.mark.parametrize("engine,where", [("scan", "build"),
                                          ("outer", "build"),
                                          ("scan", "segment"),
                                          ("outer", "chunk")])
def test_an_excess_escalates_and_drops_nothing(system, weights, engine,
                                               where):
    """A section too small at the start grows at the host build; one that
    fits there but not later in the run (a capacity of exactly the most
    pairs an atom has at the start, at 10,000 K) runs its segment or chunk
    again, grown. Either way the run equals one with room to spare."""
    x, t, b, pos, typ, box = system
    inside = int((neighbor_table(x, b, CFG.rcut) >= 0).sum(dim=1).max())
    start = 8 if where == "build" else inside
    spec = dict(ensemble="nve", steps=12, dt_fs=1.0, temp_k=10000.0,
                rebuild_every=12, thermo_every=1, skin=SKIN, seed=0,
                engine=engine)
    pot = api.make_potential("dpa1", CFG)
    roomy = api.Simulation(api.SimulationSpec(
        potential=pot.with_capacity(64), **spec)).run(weights, pos, typ, box,
                                                      device="cpu")
    res = api.Simulation(api.SimulationSpec(
        potential=pot.with_capacity(start), **spec)).run(weights, pos, typ,
                                                         box, device="cpu")
    grown = _escalations(obs.calls(1))
    assert grown and {g["where"] for g in grown} == {where}, grown
    assert res.section_slots > start and res.escalations >= len(grown)
    pe, pe_roomy = ([row["pe"] for row in r.thermo] for r in (res, roomy))
    assert np.allclose(pe, pe_roomy, rtol=1e-6, atol=0)
    assert np.allclose(res.final_pos, roomy.final_pos, rtol=0, atol=1e-5)


def test_the_python_engine_refuses_an_overflowing_section(system, weights):
    pos, typ, box = system[3:]
    pot = api.DPA1Potential(CFG, capacity=8, nbr_sel=(64, 128))
    with pytest.raises(RuntimeError, match="overflow"):
        api.Simulation(api.SimulationSpec(
            potential=pot, steps=2, rebuild_every=2, skin=SKIN,
            engine="python")).run(weights, pos, typ, box, device="cpu")


def test_the_tf32_control_leaves_the_tolerance(system, weights):
    x, t, b = system[:3]
    e, f = _reference(weights, x, t, b)
    e_tf32, f_tf32 = _reference(weights, x, t, b, precision="tf32")
    assert abs(e_tf32 - e) > 100 * E_RTOL * abs(e)
    assert float((f_tf32 - f).abs().max()) > 2 * F_ATOL


def test_the_parameters_drawn_by_the_port_run_the_model(system):
    """``init_params`` gives the layout the reference's weights have."""
    x, t, b = system[:3]
    params = api.make_potential("dpa1", CFG).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    raw = ref.weights(RAW, 0, CPU)

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v2 for k in tree
                    for k2, v2 in shapes(tree[k], f"{path}/{k}").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in shapes(v, f"{path}/{i}").items()}
        return {path: tuple(tree.shape)}

    assert shapes(params) == shapes(raw)
    e, f, _, _ = dpa1.energy_forces(params, CFG, x, _list(x, t, b), t, b)
    assert math.isfinite(float(e)) and torch.isfinite(f).all()
