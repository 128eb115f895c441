"""DPA-2 (``core/dpa2.py``, ``md/api.DPA2Potential``) on the CPU, held
against the benchmark's plain reference (``mdbench/reference/dpa2.py``,
which imports nothing of the port) on seeded weights at narrow widths with
all six repformer layers, on ``water(1, 1, 1)``: 192 atoms in a 12.42 A
box, repinit within 4 A, the repformers within 3 A and a 2 A skin, so that
rcut + skin stays under half the box. Message passing reaches
4 + 6 x 3 = 22 A.

Energy, forces and the virial of one evaluation; g1 and g2 after each
layer; an atom outside another's list moving that atom's energy;
trajectories on the scan and outer engines; invariance under slot
permutation, rotation and translation, and under the capacities; each
section that overflows grows alone and drops nothing; the reference's TF32
control outside the tolerance. The file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_dpa2.py
"""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import descriptor, dp_model, dpa2  # noqa: E402
from repro_torch.core.types import DPA1Config, DPA2Config  # noqa: E402
from repro_torch.md import api, neighbors  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mdbench.reference import dpa2 as ref  # noqa: E402
from mdbench.reference import md as ref_md  # noqa: E402
from mdbench.reference.shared import neighbor_table  # noqa: E402
from mdbench.systems import water  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
RAW = {"ntypes": 2, "type_map": ["O", "H"], "tebd_dim": 8, "rcut": 4.0,
       "rcut_smth": 0.5, "sel": 40, "repinit_widths": [4, 8, 16],
       "repinit_axis": 4, "repformer_rcut": 3.0, "repformer_rcut_smth": 2.0,
       "repformer_sel": 20, "repformer_layers": 6, "g1_dim": 16,
       "g2_dim": 8, "attn2_hidden": 8, "attn2_heads": 4,
       "repformer_axis": 4, "fit_widths": [16, 16, 16]}
CFG = DPA2Config(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in RAW.items()})
SKIN = 2.0
# the port against the reference, float32 both, in other orders of summation
# (the port adds the attention's shift and gates in another order, makes
# N's first layer from a table of type pairs, and takes forces through r_ij
# where the reference takes them through the positions): energies to 1e-6
# relative (a float32 sum of 192 atoms), forces to 5e-6 of the largest
# force (read: 7e-7 at the published residual scale, largest force ~5e-4
# eV/A; 1.6e-6 with the residuals at 1, where six layers amplify the
# rounding and the largest force is ~1 eV/A); the TF32 control reads
# ~2e-3 relative and ~1e-3 of the largest force off, outside both
E_RTOL, F_RTOL = 1e-6, 5e-6


def _system():
    pos, typ, box = water.water((1, 1, 1), 0)
    pos = np.mod(pos, box).astype(np.float32)
    return (torch.as_tensor(pos), torch.as_tensor(typ, dtype=torch.int64),
            torch.as_tensor(box, dtype=torch.float32), pos, typ, box)


@pytest.fixture(scope="module")
def system():
    return _system()


def _weights(residual: str):
    """The seeded weights; ``"one"`` sets every residual vector to 1, so
    that each layer's update terms move the energy as much as g1 and g2
    themselves."""
    w = ref.weights(RAW, 0, CPU)
    if residual == "one":
        for lyr in w["repformers"]:
            lyr["g1_res"] = torch.ones_like(lyr["g1_res"])
            lyr["g2_res"] = torch.ones_like(lyr["g2_res"])
    return w


@pytest.fixture(scope="module")
def weights():
    return _weights("published")


@pytest.fixture(scope="module")
def weights_one():
    return _weights("one")


def _list(x, t, b, sel=(64, 128)):
    nlist, ovf = neighbors.brute_force_neighbors(
        x, t, neighbors.NeighborSpec(CFG.rcut + SKIN, sel), b)
    assert int(ovf) <= 0
    return nlist


def _model(weights, precision="float32"):
    return ref.Reference(RAW, weights, CPU, precision=precision)


def _reference(weights, x, t, b, precision="float32"):
    return _model(weights, precision).energy_forces(
        x, t, b, neighbor_table(x, b, CFG.rcut + SKIN))


def _close(e, f, e_ref, f_ref):
    assert float(e) == pytest.approx(e_ref, rel=E_RTOL)
    scale = float(f_ref.abs().max())
    assert float((f - f_ref).abs().max()) < F_RTOL * scale
    assert scale > 1e-4


@pytest.mark.parametrize("residual", ["published", "one"])
def test_energy_and_forces_match_the_reference(system, residual):
    x, t, b = system[:3]
    w = _weights(residual)
    e, f, _, excess = dpa2.energy_forces(w, CFG, x, _list(x, t, b), t, b)
    assert (excess <= 0).all()
    _close(e, f, *_reference(w, x, t, b))


def test_each_update_term_moves_the_energy(system, weights_one):
    """With the residual vectors at 1, zeroing any one of a layer's five
    update terms (u1, u2 on g2; v1, v2, v3 on g1) moves the energy by far
    more than the comparison's tolerance, in the port and the reference
    alike."""
    x, t, b = system[:3]
    nlist = _list(x, t, b)
    e0 = float(dpa2.energy_forces(weights_one, CFG, x, nlist, t, b)[0])
    for key, row in (("g2_res", 0), ("g2_res", 1), ("g1_res", 0),
                     ("g1_res", 1), ("g1_res", 2)):
        w = {**weights_one, "repformers": [dict(lyr) for lyr in
                                           weights_one["repformers"]]}
        lyr = w["repformers"][2]
        lyr[key] = lyr[key].clone()
        lyr[key][row] = 0.0
        e = float(dpa2.energy_forces(w, CFG, x, nlist, t, b)[0])
        e_ref, _ = _reference(w, x, t, b)
        assert abs(e - e0) > 1e3 * E_RTOL * abs(e0), (key, row)
        assert e == pytest.approx(e_ref, rel=E_RTOL)


def test_the_virial_is_the_references_strain_derivative(system, weights_one):
    """W_aa = -dE/d(eps_aa) of the reference under a stretch of axis a
    (positions and box), by central differences: float32 energies of ~100
    eV over a 2e-3 stretch leave ~1e-2 relative; the off-diagonal
    components of a rotation-invariant energy are symmetric."""
    x, t, b = system[:3]
    _, _, virial, _ = dpa2.energy_forces(weights_one, CFG, x, _list(x, t, b),
                                         t, b)
    h = 1e-3
    for a in range(3):
        scale = torch.ones(3)
        scale[a] = 1 + h
        up, _ = _reference(weights_one, x * scale, t, b * scale)
        scale[a] = 1 - h
        down, _ = _reference(weights_one, x * scale, t, b * scale)
        want = -(up - down) / (2 * h)
        assert float(virial[a, a]) == pytest.approx(want, rel=2e-2, abs=2e-2)
    assert torch.allclose(virial, virial.T, atol=1e-4)


def _port_states(weights, x, t, b):
    """The port's g1 and g2 (with the second section's neighbours) after
    the inputs and after each layer, by its own functions."""
    cfg = CFG
    mixed, sub, _, _ = dpa2.compact(x, _list(x, t, b), b, cfg, cfg.sections)
    rij, nmask = dp_model.gather_rij(x, mixed, b)
    tebd = dpa2.type_embedding(weights)
    g1 = dpa2.repinit(weights, cfg, rij, nmask, t,
                      t[torch.clamp(mixed, min=0)], tebd)
    rij2, mask, nbr = dpa2.sub_section(rij, mixed, sub)
    env, s = descriptor.env_matrix(rij2, mask, cfg.repformer_rcut_smth,
                                   cfg.repformer_rcut)
    sw = s * torch.linalg.vector_norm(
        torch.where(mask[..., None], rij2, 1.0), dim=-1)
    g2 = torch.tanh(env[..., :1] * weights["g2_embed"]["w"][0]
                    + weights["g2_embed"]["b"])
    gates = dpa2.attention_gates(env[..., 1:], sw, mask, cfg.attn2_hidden)
    out = [(g1, nbr, g2)]
    for lyr in weights["repformers"]:
        g1, g2 = dpa2.repformer_layer(lyr, cfg, g1, g2, env[..., 1:], sw,
                                      nbr, gates)
        out.append((g1, nbr, g2))
    return out


def _by_neighbour(nbr, g2):
    """Each atom's g2 rows in the order of the neighbours' indices, the
    padded slots last (no neighbour appears twice in a 12.42 A box at
    3 A)."""
    key = torch.where(nbr >= 0, nbr, 1 << 30)
    order = torch.argsort(key, dim=1)
    rows = torch.gather(g2, 1, order[..., None].expand(-1, -1, g2.shape[-1]))
    return torch.gather(key, 1, order), rows


def test_g1_and_g2_after_each_layer_match_the_reference(system, weights_one):
    x, t, b = system[:3]
    port = _port_states(weights_one, x, t, b)
    want = _model(weights_one).layer_states(
        x, t, b, neighbor_table(x, b, CFG.rcut + SKIN))
    assert len(port) == len(want) == CFG.repformer_layers + 1
    for (g1, nbr, g2), (g1_r, j_r, live_r, g2_r) in zip(port, want):
        scale = float(g1_r.abs().max())
        assert float((g1 - g1_r).abs().max()) < 1e-5 * scale
        key, rows = _by_neighbour(nbr, g2)
        key_r, rows_r = _by_neighbour(torch.where(live_r, j_r, -1), g2_r)
        width = int((key_r < (1 << 30)).sum(dim=1).max())
        assert torch.equal(key[:, :width], key_r[:, :width])
        assert float((rows[:, :width] - rows_r[:, :width]).abs().max()) \
            < 1e-5 * float(g2_r.abs().max())
        assert (key[:, width:] == (1 << 30)).all()


def test_an_atom_outside_the_list_moves_the_energy(weights_one):
    """Message passing, at the published cut-offs (6 A and 4 A, so
    ``water(2, 2, 2)``: 1,536 atoms in a 24.84 A box): an atom k 7-9 A
    from atom i, outside i's 6 A section, moved by 0.3 A, moves E_i
    through the g1 of the atoms between them, by as much in the port as in
    the reference (the largest of the first eight such atoms, ~1e-5 eV on
    E_i of ~0.3 eV; float32 leaves ~1e-7 eV), and the forces still match."""
    cfg = dataclasses.replace(CFG, rcut=6.0, rcut_smth=0.5, sel=120,
                              repformer_rcut=4.0, repformer_rcut_smth=3.5,
                              repformer_sel=40)
    raw = dict(RAW, rcut=6.0, rcut_smth=0.5, sel=120, repformer_rcut=4.0,
               repformer_rcut_smth=3.5, repformer_sel=40)
    pos, typ, box = water.water((2, 2, 2), 0)
    x = torch.as_tensor(np.mod(pos, box).astype(np.float32))
    t = torch.as_tensor(typ, dtype=torch.int64)
    b = torch.as_tensor(box, dtype=torch.float32)
    rc = cfg.rcut + SKIN

    def port_e(p):
        nlist, _ = neighbors.brute_force_neighbors(
            p, t, neighbors.NeighborSpec(rc, (128, 256)), b)
        mixed, sub, _, _ = dpa2.compact(p, nlist, b, cfg, cfg.sections)
        rij, nmask = dp_model.gather_rij(p, mixed, b)
        return dpa2.atomic_energy(weights_one, cfg, rij, nmask, t, mixed,
                                  sub), nlist

    i = 1
    d = x - x[i]
    d = d - b * torch.round(d / b)
    r = torch.linalg.vector_norm(d, dim=-1)
    e0, _ = port_e(x)
    step = torch.tensor([0.3, -0.15, 0.15])
    best = None
    for k in torch.nonzero((r > 7.0) & (r < 9.0))[:8, 0].tolist():
        moved = torch.remainder(x.index_add(0, torch.tensor([k]),
                                            step[None]), b)
        de = float(port_e(moved)[0][i] - e0[i])
        if best is None or abs(de) > abs(best[1]):
            best = (k, de, moved)
    k, de, moved = best
    assert 7.0 < float(r[k]) < 9.0
    assert abs(de) > 3e-6
    model = ref.Reference(raw, weights_one, CPU)
    de_ref = float(model.atomic_energies(moved, t, b, neighbor_table(
        moved, b, rc))[i] - model.atomic_energies(x, t, b, neighbor_table(
            x, b, rc))[i])
    assert de == pytest.approx(de_ref, rel=0.05)
    _, nlist = port_e(moved)
    e, f, _, _ = dpa2.energy_forces(weights_one, cfg, moved, nlist, t, b)
    _close(e, f, *model.energy_forces(moved, t, b,
                                      neighbor_table(moved, b, rc)))


@pytest.mark.parametrize("engine", ["scan", "outer"])
def test_a_trajectory_on_each_engine_matches_the_reference(system, weights,
                                                           engine):
    x, t, b, pos, typ, box = system
    pot = api.make_potential("dpa2", CFG)
    steps, seed = 12, 7
    res = api.Simulation(api.SimulationSpec(
        potential=pot, ensemble="nve", steps=steps, dt_fs=0.5,
        rebuild_every=6, thermo_every=1, skin=SKIN, seed=seed,
        engine=engine)).run(weights, pos, typ, box, device="cpu")
    model = _model(weights)
    mass = torch.as_tensor(ref_md.masses(CFG.type_map, typ),
                           dtype=torch.float32)
    vel = ref_md.start_velocities(seed, mass, 330.0)
    traj = ref_md.nve(model, x, vel, t, b, mass, 0.5, steps, SKIN)
    pe = np.asarray([row["pe"] for row in res.thermo])
    assert np.max(np.abs(pe - traj.pe)) / len(pos) < 1e-7
    dpos = res.final_pos - traj.pos.numpy()
    dpos -= box * np.round(dpos / box)
    assert np.max(np.abs(dpos)) < 1e-5
    assert np.max(np.abs(res.final_vel - traj.vel.numpy())) < 1e-7
    assert res.section_slots == CFG.sections
    assert res.stress.shape == (steps, 3, 3)


def test_the_engines_give_the_same_stress(system, weights_one):
    pos, typ, box = system[3:]
    out = {}
    for engine in ("scan", "outer"):
        out[engine] = api.Simulation(api.SimulationSpec(
            potential=api.make_potential("dpa2", CFG), ensemble="nve",
            steps=6, dt_fs=0.5, rebuild_every=3, skin=SKIN, seed=3,
            engine=engine)).run(weights_one, pos, typ, box, device="cpu")
    assert np.allclose(out["scan"].stress, out["outer"].stress, rtol=0,
                       atol=1e-9)
    assert np.abs(out["scan"].stress).max() > 0


@pytest.mark.parametrize("caps", [(120, 40), (160, 64), (120, 48)])
def test_the_result_does_not_depend_on_the_capacities(system, weights_one,
                                                      caps):
    x, t, b = system[:3]
    nlist = _list(x, t, b)
    e0, f0, v0, _ = dpa2.energy_forces(weights_one, CFG, x, nlist, t, b)
    e, f, v, excess = dpa2.energy_forces(weights_one, CFG, x, nlist, t, b,
                                         caps=caps)
    assert (excess < 0).all()
    assert float(e) == pytest.approx(float(e0), rel=1e-6)
    assert torch.allclose(f, f0, rtol=0, atol=1e-6 * float(f0.abs().max()))
    assert torch.allclose(v, v0, rtol=1e-5, atol=1e-5)


def test_invariant_under_slot_order_rotation_and_translation(system,
                                                             weights_one):
    x, t, b = system[:3]
    mixed, sub, _, _ = dpa2.compact(x, _list(x, t, b), b, CFG, CFG.sections)
    rij, nmask = dp_model.gather_rij(x, mixed, b)
    e0 = dpa2.atomic_energy(weights_one, CFG, rij, nmask, t, mixed, sub)
    pot = api.make_potential("dpa2", CFG)
    assert torch.equal(pot.atomic_energy(weights_one, rij, nmask, t,
                                         mixed=mixed, sub=sub), e0)
    with pytest.raises(ValueError):
        pot.atomic_energy(weights_one, rij, nmask, t)
    # both sections' slots shuffled: the first's by a permutation (the
    # second's indices follow it), the second's by another
    gen = torch.Generator().manual_seed(1)
    n1, n2 = mixed.shape[1], sub.shape[1]
    p1 = torch.stack([torch.randperm(n1, generator=gen) for _ in range(len(x))])
    p2 = torch.stack([torch.randperm(n2, generator=gen) for _ in range(len(x))])
    inverse = torch.argsort(p1, dim=1)
    sub_p = torch.gather(sub, 1, p2)
    sub_p = torch.where(sub_p >= 0, torch.gather(
        inverse, 1, torch.clamp(sub_p, min=0)), -1)
    e_perm = dpa2.atomic_energy(
        weights_one, CFG,
        torch.gather(rij, 1, p1[..., None].expand(-1, -1, 3)),
        torch.gather(nmask, 1, p1), t, torch.gather(mixed, 1, p1), sub_p)
    assert torch.allclose(e_perm, e0, rtol=0, atol=1e-5)
    q, _ = torch.linalg.qr(torch.randn(3, 3, generator=gen))
    e_rot = dpa2.atomic_energy(weights_one, CFG, rij @ q, nmask, t, mixed,
                               sub)
    assert torch.allclose(e_rot, e0, rtol=0, atol=1e-5)
    shift = torch.tensor([3.1, -7.7, 5.3])
    moved = torch.remainder(x + shift, b)
    e_a = dpa2.energy_forces(weights_one, CFG, x, _list(x, t, b), t, b)[0]
    e_b = dpa2.energy_forces(weights_one, CFG, moved, _list(moved, t, b), t,
                             b)[0]
    assert float(e_b) == pytest.approx(float(e_a), rel=1e-6)


def test_make_potential_wants_a_dpa2_config():
    with pytest.raises(ValueError):
        api.make_potential("dpa2", DPA1Config())
    pot = api.make_potential("dpa2", CFG)
    assert pot.sel == (CFG.sel, CFG.sel) and pot.slots == (40, 20)
    assert pot.section_names == ("repinit", "repformer")
    assert pot.with_layout((64, 96)).with_capacities((48, 24)).slots == \
        (48, 24)
    assert pot.with_capacities((48, 24)).with_layout((64, 96)).sel == \
        (64, 96)
    assert api.make_potential("dpa1", DPA1Config()).capacities == (120,)


def test_compact_reports_each_sections_excess(system):
    x, t, b = system[:3]
    nlist = _list(x, t, b)
    inside = [(neighbor_table(x, b, rc) >= 0).sum(dim=1)
              for rc in (CFG.rcut, CFG.repformer_rcut)]
    mixed, sub, excess, live = dpa2.compact(x, nlist, b, CFG, (60, 6))
    assert excess.tolist() == [int(inside[0].max()) - 60,
                               int(inside[1].max()) - 6]
    assert excess[0] < 0 < excess[1]
    assert live.tolist() == [int(inside[0].sum()), int(inside[1].sum())]
    assert ((sub >= 0).sum(dim=1) == torch.clamp(inside[1], max=6)).all()
    # the second section's slots point at pairs within its cut-off
    rij, _ = dp_model.gather_rij(x, mixed, b)
    at = torch.clamp(sub, min=0)
    r = torch.linalg.vector_norm(torch.gather(
        rij, 1, at[..., None].expand(-1, -1, 3)), dim=-1)
    assert (r[sub >= 0] < CFG.repformer_rcut).all()
    # a first section that cannot hold its pairs: both counts stay exact
    _, sub, excess, _ = dpa2.compact(x, nlist, b, CFG, (8, 60))
    assert excess.tolist() == [int(inside[0].max()) - 8,
                               int(inside[1].max()) - 60]
    assert int(sub.max()) < 8


def _escalations(calls):
    return [s.attrs for s in calls[-1].spans if s.name == "model.escalate"]


@pytest.mark.parametrize("section", ["repinit", "repformer"])
@pytest.mark.parametrize("engine,where", [("scan", "build"),
                                          ("scan", "segment"),
                                          ("outer", "chunk")])
def test_an_overflowing_section_grows_alone(system, weights, section,
                                            engine, where):
    """One section a slot too small at the start grows at the host build
    (to the policy's next size, with room for the run); one
    that fits there but not later in the run (a capacity of exactly the
    most pairs an atom has at the start, at 10,000 K) runs its segment or
    chunk again, grown. Only that section grows, and the run equals one
    with room to spare."""
    x, t, b, pos, typ, box = system
    which = CFG.SECTIONS.index(section)
    rc = (CFG.rcut, CFG.repformer_rcut)[which]
    inside = int((neighbor_table(x, b, rc) >= 0).sum(dim=1).max())
    roomy = (120, 60)
    start = list(roomy)
    start[which] = inside - 1 if where == "build" else inside
    spec = dict(ensemble="nve", steps=12, dt_fs=1.0, temp_k=10000.0,
                rebuild_every=12, thermo_every=1, skin=SKIN, seed=0,
                engine=engine)
    pot = api.make_potential("dpa2", CFG)
    want = api.Simulation(api.SimulationSpec(
        potential=pot.with_capacities(roomy), **spec)).run(
            weights, pos, typ, box, device="cpu")
    res = api.Simulation(api.SimulationSpec(
        potential=pot.with_capacities(tuple(start)), **spec)).run(
            weights, pos, typ, box, device="cpu")
    grown = _escalations(obs.calls(1))
    assert grown and {g["where"] for g in grown} == {where}, grown
    assert {g["section"] for g in grown} == {section}
    assert res.section_slots[which] > start[which]
    assert res.section_slots[1 - which] == start[1 - which]
    assert res.escalations >= len(grown)
    pe, pe_want = ([row["pe"] for row in r.thermo] for r in (res, want))
    assert np.allclose(pe, pe_want, rtol=1e-6, atol=0)
    assert np.allclose(res.final_pos, want.final_pos, rtol=0, atol=1e-5)


def test_each_host_build_counts_both_sections(system, weights):
    """``model.section`` once a section at each host build, named, with
    its counters; the evaluation's spans carry theirs."""
    pos, typ, box = system[3:]
    api.Simulation(api.SimulationSpec(
        potential=api.make_potential("dpa2", CFG), ensemble="nve", steps=4,
        dt_fs=0.5, rebuild_every=2, skin=SKIN, seed=1,
        engine="scan")).run(weights, pos, typ, box, device="cpu")
    spans = obs.calls(1)[-1].spans
    counts = [s.attrs for s in spans if s.name == "model.section"]
    assert [c["section"] for c in counts] == ["repinit", "repformer"] * 2
    assert all(c["atoms"] == len(pos) and c["excess"] < 0 < c["live"]
               for c in counts)
    assert [c["slots"] for c in counts[:2]] == list(CFG.sections)
    reps = [s.attrs for s in spans if s.name == "dpa2.repformer"]
    # the first force, then one evaluation a step
    assert len(reps) == 5 and reps[0] == {"layers": 6, "slots": 20}
    assert sum(s.name == "dpa2.repinit" for s in spans) == 5
    assert [s.attrs for s in spans if s.name == "dpa2.force"][0] == \
        {"atoms": len(pos), "slots": CFG.sections}


def test_the_python_engine_refuses_an_overflowing_section(system, weights):
    pos, typ, box = system[3:]
    pot = api.DPA2Potential(CFG, capacity=(60, 4), nbr_sel=(64, 128))
    with pytest.raises(RuntimeError, match="overflow"):
        api.Simulation(api.SimulationSpec(
            potential=pot, steps=2, rebuild_every=2, skin=SKIN,
            engine="python")).run(weights, pos, typ, box, device="cpu")


def test_the_tf32_control_leaves_the_tolerance(system, weights):
    x, t, b = system[:3]
    e, f = _reference(weights, x, t, b)
    e_tf32, f_tf32 = _reference(weights, x, t, b, precision="tf32")
    assert abs(e_tf32 - e) > 100 * E_RTOL * abs(e)
    assert float((f_tf32 - f).abs().max()) > 20 * F_RTOL * float(
        f.abs().max())


def test_the_parameters_drawn_by_the_port_run_the_model(system):
    """``init_params`` gives the layout the reference's weights have."""
    x, t, b = system[:3]
    params = api.make_potential("dpa2", CFG).init_params(
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
    e, f, _, _ = dpa2.energy_forces(params, CFG, x, _list(x, t, b), t, b)
    assert math.isfinite(float(e)) and torch.isfinite(f).all()
