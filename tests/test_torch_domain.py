"""The port's distributed MD (``repro_torch.md.domain``) on the CPU.

At the reference harness's config (``tests/distributed/run_md_dist.py``:
embed (8, 16, 32), fit (32, 32, 32), rcut 4, sel (64,), rcut_halo 4.5,
fcc_copper jittered from numpy seed 0) one distributed step under
``LocalComm`` is held against the reference's single-process
``dp_energy_forces`` in every decomposition x neighbor mode on a ``(4,)``
slab and a ``(2, 2)`` brick topology, at the harness's tolerances: PE
1e-4 + 1e-5 |E|, forces 1e-6 abs, virial 2e-3 relative. The host-side and
per-brick pieces (partition, slab cell list, split/merge) are held equal
to the reference's; migration, the segment runner, the outer program, the
static no-ops and ``DistComm`` on gloo are held to the port's own step loop
and single-process engine, bit for bit where the arithmetic is the same.

The reference's distributed step kicks twice with one force; the port's is
velocity Verlet with the force carried (``domain.py``), so one step from
rest at dt = 1e-3 gives v = dt/2 F/m and the carried force is F.
"""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import DPConfig as JaxDPConfig  # noqa: E402
from repro.core import dp_energy_forces as jax_energy_forces  # noqa: E402
from repro.core import init_dp_params as jax_init_params  # noqa: E402
from repro.md import api as jax_api  # noqa: E402
from repro.md import domain as jax_domain  # noqa: E402
from repro.md import driver as jax_driver  # noqa: E402
from repro.md import integrator as jax_integrator  # noqa: E402
from repro.md import lattice as jax_lattice  # noqa: E402
from repro.md import neighbors as jax_neighbors  # noqa: E402
from repro.md import slab_cells as jax_slab_cells  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.types import DPConfig  # noqa: E402
from repro_torch.md import (  # noqa: E402
    api, comm, domain, driver, integrator, neighbors, slab_cells, stepper)
from repro_torch.md.topology import Topology  # noqa: E402

import _torch_dist_worker  # noqa: E402

torch.set_num_threads(1)

CPU = "cpu"
CFG_KW = dict(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(64,), type_map=("Cu",),
              embed_widths=(8, 16, 32), axis_neuron=4, fit_widths=(32, 32, 32))
CFG = DPConfig(**CFG_KW)
MASS = (63.546,)
RC_HALO = 4.5
# topology -> (fcc cells, atom capacity, halo capacity), as the harness
CASES = {(4,): ((8, 2, 2), 48, 40), (2, 2): ((4, 4, 3), 96, 96)}


@pytest.fixture(scope="module")
def model():
    p_jax = jax_init_params(jax.random.PRNGKey(0), JaxDPConfig(**CFG_KW))
    return p_jax, bridge.params_from_numpy(jax.tree.map(np.asarray, p_jax),
                                           CPU)


def _atoms(cells, jitter=0.05, seed=0):
    pos, typ, box = jax_lattice.fcc_copper(*cells)
    rng = np.random.default_rng(seed)
    pos = np.mod(pos + rng.normal(0, jitter, pos.shape), box)
    return pos.astype(np.float32), typ, np.asarray(box, float)


def _spec(topology, box, **kw):
    _, cap, hc = CASES[topology]
    return domain.DomainSpec.for_topology(tuple(box), topology, cap, hc,
                                          RC_HALO, **kw)


def _boxt(box):
    return torch.tensor(np.asarray(box, np.float32))


@pytest.fixture(scope="module")
def reference(model):
    """Per topology: the atoms and the reference's E, F, W of them."""
    p_jax, _ = model
    out = {}
    for topo, (cells, _, _) in CASES.items():
        pos, typ, box = _atoms(cells)
        nl, _ = jax_neighbors.brute_force_neighbors(
            jnp.asarray(pos), jnp.asarray(typ),
            jax_neighbors.NeighborSpec(rcut_nbr=RC_HALO, sel=(64,)),
            jnp.asarray(box))
        e, f, w = jax_energy_forces(p_jax, JaxDPConfig(**CFG_KW),
                                    jnp.asarray(pos), nl, jnp.asarray(typ),
                                    jnp.asarray(box, jnp.float32))
        out[topo] = (pos, typ, box, float(e), np.asarray(f), np.asarray(w))
    return out


@pytest.mark.parametrize("neighbor", ["brute", "cells"])
@pytest.mark.parametrize("decomp", ["slots", "atoms"])
@pytest.mark.parametrize("topology", [(4,), (2, 2)])
def test_one_step_matches_single_process_reference(topology, decomp,
                                                   neighbor, model,
                                                   reference):
    _, params = model
    pos, typ, box, e_ref, f_ref, w_ref = reference[topology]
    spec = _spec(topology, box)
    state, ovf = domain.partition_atoms(pos, np.zeros_like(pos), typ, spec)
    assert ovf <= 0
    lc = comm.LocalComm(spec.n_slabs, 2, device=CPU)
    step = domain.make_distributed_md_step(CFG, spec, lc, MASS, 1e-3,
                                           decomp=decomp, neighbor=neighbor)
    (new, _, _, _), th = step(params, state, (), _boxt(box), ())
    for key in ("halo_overflow", "nbr_overflow", "geom_overflow"):
        assert int(th[key]) <= 0, key
    assert int(th["n_atoms"]) == len(pos)
    assert abs(float(th["pe"]) - e_ref) < 1e-4 + 1e-5 * abs(e_ref)
    w = th["stress"].numpy() * float(np.prod(box))
    w_err = np.abs(w - w_ref).max() / max(1.0, np.abs(w_ref).max())
    assert w_err < 2e-3, w_err
    # from rest with a zero carried force: x unchanged, v = dt/2 F/m
    mask, p0 = state.mask.numpy(), state.pos.numpy()
    f_err = v_err = 0.0
    for s in range(spec.n_slabs):
        for i in np.nonzero(mask[s])[0]:
            j = int(np.argmin(np.sum((pos - p0[s, i]) ** 2, 1)))
            f_err = max(f_err, np.abs(new.force[s, i].numpy()
                                      - f_ref[j]).max())
            f_est = new.vel[s, i].numpy() * MASS[0] / (
                0.5e-3 * integrator.FORCE_TO_ACC)
            v_err = max(v_err, np.abs(f_est - f_ref[j]).max())
    assert f_err < 1e-6 and v_err < 1e-6, (f_err, v_err)


def _brick_frame_atoms(rng, topology, box, n, mask_frac=0.8):
    """Random atoms over a brick's frame: [-rc, w + rc) on decomposed axes
    (the owned atoms and the ghost shell), the whole box elsewhere."""
    shape = topology or (4,)
    pos = np.empty((n, 3), np.float32)
    for a in range(3):
        if a < len(shape):
            w = box[a] / shape[a]
            pos[:, a] = rng.uniform(-RC_HALO, w + RC_HALO, n)
        else:
            pos[:, a] = rng.uniform(0, box[a], n)
    mask = rng.random(n) < mask_frac
    return pos, mask


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("topology", [None, (4,), (2, 2), (2, 2, 2)])
def test_slab_cell_list_equals_reference(topology, dynamic):
    rng = np.random.default_rng(3)
    box = (24.0, 16.0, 12.0)
    shape = topology or (4,)
    cfg_j = JaxDPConfig(ntypes=2, rcut=4.0, rcut_smth=2.0, sel=(24, 40),
                        type_map=("O", "H"))
    cfg_t = DPConfig(ntypes=2, rcut=4.0, rcut_smth=2.0, sel=(24, 40),
                     type_map=("O", "H"))
    n, n_c, start = 260, 40, 12
    pos, mask = _brick_frame_atoms(rng, topology, box, n)
    typ = rng.integers(0, 2, n)
    lo = np.array([w * 1.0 for w in (6.0, 8.0, 6.0)], np.float32)
    kw = dict(box=box, slab_width=box[0] / shape[0], rc_halo=RC_HALO,
              n_centers=n_c, cell_capacity=24, topology=topology)
    fn_j = jax_slab_cells.make_slab_neighbor_fn(cfg_j, **kw)
    fn_t = slab_cells.make_slab_neighbor_fn(cfg_t, **kw)
    call = {}
    if dynamic:
        scale = np.array([0.97, 0.98, 0.99], np.float32)
        b = np.asarray(box, np.float32) * scale
        widths = [b[a] / shape[a] for a in range(len(shape))]
        call_j = dict(box=jnp.asarray(b),
                      widths=[jnp.float32(w) for w in widths])
        call = dict(box=torch.from_numpy(b),
                    widths=[torch.tensor(w) for w in widths])
    else:
        call_j = {}
    nl_j, ovf_j = fn_j(jnp.asarray(pos), jnp.asarray(typ, jnp.int32),
                       jnp.asarray(mask), jnp.asarray(lo), start, **call_j)
    nl_t, ovf_t = fn_t(torch.from_numpy(pos), torch.from_numpy(typ),
                       torch.from_numpy(mask), torch.from_numpy(lo), start,
                       **call)
    assert int(ovf_t) == int(ovf_j)
    np.testing.assert_array_equal(nl_t.numpy(), np.asarray(nl_j))


def test_slab_cell_list_flags_a_box_below_its_grid():
    fn = slab_cells.make_slab_neighbor_fn(CFG, (24.0, 16.0, 12.0), 6.0,
                                          RC_HALO, 8, topology=(4,))
    pos, mask = _brick_frame_atoms(np.random.default_rng(0), (4,),
                                   (24.0, 16.0, 12.0), 30)
    box = torch.tensor([24.0, 8.0, 12.0])
    _, ovf = fn(torch.from_numpy(pos), torch.zeros(30, dtype=torch.int64),
                torch.from_numpy(mask), torch.zeros(3), 0, box=box,
                widths=[box[0] / 4])
    assert int(ovf) >= int(neighbors.GRID_INVALID)


@pytest.mark.parametrize("sel", [(48,), (12,)])
def test_brute_force_amask_equals_reference(sel):
    pos, typ, box = _atoms((2, 2, 2), jitter=0.1, seed=1)
    amask = np.random.default_rng(2).random(len(pos)) < 0.7
    kw = dict(rcut_nbr=4.0, sel=sel)
    nl_j, ovf_j = jax_neighbors.brute_force_neighbors(
        jnp.asarray(pos), jnp.asarray(typ), jax_neighbors.NeighborSpec(**kw),
        jnp.asarray(box, jnp.float32), jnp.asarray(amask))
    nl_t, ovf_t = neighbors.brute_force_neighbors(
        torch.from_numpy(pos), torch.from_numpy(typ).long(),
        neighbors.NeighborSpec(**kw), _boxt(box), torch.from_numpy(amask))
    assert int(ovf_t) == int(ovf_j)
    np.testing.assert_array_equal(nl_t.numpy(), np.asarray(nl_j))
    assert (nl_t.numpy()[~amask] == -1).all()
    assert not np.isin(np.nonzero(~amask)[0], nl_t.numpy()).any()


def _brick(rng, cap, n_live, box, width, dim, face):
    """One brick's padded arrays with atoms around [face, face + width)."""
    pos = np.zeros((cap, 3), np.float32)
    vel = np.zeros((cap, 6), np.float32)
    live = np.sort(rng.choice(cap, n_live, replace=False))
    pos[live] = rng.uniform(0, box, (n_live, 3))
    pos[live, dim] = rng.uniform(face - 2.0, face + width + 2.0, n_live)
    vel[live] = rng.normal(size=(n_live, 6))
    typ = np.zeros(cap, np.int32)
    typ[live] = rng.integers(0, 2, n_live)
    mask = np.zeros(cap, bool)
    mask[live] = True
    return pos, vel, typ, mask


@pytest.mark.parametrize("coord", [0, 1, 3])
@pytest.mark.parametrize("hc", [6, 40])
def test_split_and_merge_equal_reference(coord, hc):
    """One axis of the migration sweep: split a brick into stayers and the
    two send packets, then merge two neighbors' packets into it (periodic
    wrap at the box ends, capacity overflow reported)."""
    rng = np.random.default_rng(coord + 10 * hc)
    box = np.array([32.0, 12.0, 12.0])
    spec_kw = dict(box=tuple(box), n_slabs=4, atom_capacity=48,
                   halo_capacity=hc, rcut_halo=RC_HALO)
    spec_t, spec_j = domain.DomainSpec(**spec_kw), \
        jax_domain.DomainSpec(**spec_kw)
    width, face = 8.0, coord * 8.0
    pos, vel, typ, mask = _brick(rng, 48, 30, box, 8.0, 0, face)
    t_args = [torch.from_numpy(x) for x in (pos, vel, typ.astype(np.int64),
                                            mask)]
    got = domain.split_migrants(*t_args, spec_t, torch.tensor(face),
                                torch.tensor(width), 0)
    want = jax_domain.split_migrants(*[jnp.asarray(x) for x in
                                       (pos, vel, typ, mask)], spec_j,
                                     jnp.float32(face), jnp.float32(width), 0)
    flat_g = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), got, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    flat_w = jax.tree.leaves(want)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, np.asarray(w))

    # arrivals: the packets two neighbors would send, in the brick's frame
    in_l = _brick(rng, hc, min(hc, 4), box, 2.0, 0, face - 2.0)
    in_r = _brick(rng, hc, min(hc, 5), box, 2.0, 0, face + width)
    if coord == 0:                      # the left packet comes across the wrap
        in_l[0][in_l[3], 0] += box[0]
    pk = [(p, v, t, m) for p, v, t, m in (in_l, in_r)]
    stay_t, stay_j = got[0], want[0]
    out_t = domain.merge_arrivals(
        stay_t, *[tuple(torch.from_numpy(x.astype(np.int64)
                                         if x.dtype == np.int32 else x)
                        for x in p) for p in pk],
        coord, spec_t, torch.from_numpy(box.astype(np.float32)), 0)
    out_j = jax_domain.merge_arrivals(
        stay_j, *[tuple(jnp.asarray(x) for x in p) for p in pk], coord,
        spec_j, jnp.asarray(box, jnp.float32), 0)
    (arr_t, ovf_t), (arr_j, ovf_j) = out_t, out_j
    assert int(ovf_t) == int(ovf_j)
    for g, w in zip(arr_t, arr_j):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("topology", [(4,), (2, 2)])
def test_migration_conserves_atoms_bounds_and_carried_force(topology,
                                                            reference):
    """Push atoms across faces (diagonally on the 2x2 bricks: two hops);
    every atom ends inside its brick, none is lost, and the carried force
    travels with its atom (here: a marker equal to the pre-shift position)."""
    pos, typ, box, *_ = reference[topology]
    spec = _spec(topology, box)
    state, _ = domain.partition_atoms(pos, np.zeros_like(pos), typ, spec)
    shift = torch.zeros_like(state.pos)
    shift[:, :4, 0] = 1.5
    if len(topology) > 1:
        shift[:, :4, 1] = 1.5
    marker = state.pos.clone()
    state = state._replace(pos=(state.pos + shift) * state.mask[..., None],
                           force=marker + shift)
    lc = comm.LocalComm(spec.n_slabs, 1, device=CPU)
    new, ovf = domain.make_migration_step(spec, lc)(state, _boxt(box))
    assert int(ovf) <= 0
    assert int(new.mask.sum()) == int(state.mask.sum()) == len(pos)
    p, m = new.pos.numpy(), new.mask.numpy()
    topo = Topology(topology)
    for r in range(spec.n_slabs):
        for a, c in enumerate(topo.coords_of(r)):
            w = spec.brick_widths[a]
            x = p[r, m[r], a]
            assert np.all((x >= c * w - 1e-4) & (x < (c + 1) * w + 1e-4)), r
    d = new.force.numpy() - p
    d = d - box * np.round(d / box)
    assert np.abs(d[m]).max() < 1e-4
    assert not p[~m].any() and not new.force.numpy()[~m].any()


def _md_setup(topology, model, seed=2, temp=330.0):
    """Atoms of a (2, 2)-sized box with Maxwell-Boltzmann velocities."""
    pos, typ, box = _atoms(CASES[topology][0], jitter=0.02, seed=seed)
    masses = torch.full((len(pos),), MASS[0])
    vel = integrator.init_velocities(torch.Generator().manual_seed(seed),
                                     masses, temp).numpy()
    spec = _spec(topology, box)
    state, ovf = domain.partition_atoms(pos, vel, typ, spec)
    assert ovf <= 0
    return pos, typ, box, vel, spec, state


def _equal_states(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_segment_runner_equals_step_loop_bit_for_bit(model):
    _, params = model
    *_, box, _, spec, state0 = _md_setup((2, 2), model)
    lc = comm.LocalComm(spec.n_slabs, 2, device=CPU)
    step = domain.make_distributed_md_step(CFG, spec, lc, MASS, 0.5,
                                           decomp="atoms", neighbor="cells")
    boxt = _boxt(box)
    state0 = step.prime(params, state0, boxt)
    state, pes = state0, []
    for _ in range(6):
        (state, _, _, _), th = step(params, state, (), boxt, ())
        pes.append(th["pe"])
    (seg, _, _, _), th_seg = domain.make_segment_runner(step)(
        state0, params, 6, box=boxt)
    domain.check_segment_thermo(th_seg)
    assert th_seg["pe"].shape == (6,)
    assert torch.equal(th_seg["pe"], torch.stack(pes))
    _equal_states(seg, state)


@pytest.mark.parametrize("decomp,neighbor", [("atoms", "cells"),
                                             ("slots", "brute")])
def test_outer_equals_segment_loop_bit_for_bit(decomp, neighbor, model):
    """Migration + steps per segment in one pass over the ranks against the
    host loop of migration step + segment runner."""
    _, params = model
    *_, box, _, spec, state0 = _md_setup((2, 2), model)
    lc = comm.LocalComm(spec.n_slabs, 2, device=CPU)
    kw = dict(decomp=decomp, neighbor=neighbor)
    step = domain.make_distributed_md_step(CFG, spec, lc, MASS, 0.5, **kw)
    boxt = _boxt(box)
    state0 = step.prime(params, state0, boxt)
    run_segment = domain.make_segment_runner(step)
    migrate = domain.make_migration_step(spec, lc)
    ref = state0
    for _ in range(3):
        ref, movf = migrate(ref, boxt)
        assert int(movf) <= 0
        (ref, _, _, _), th_ref = run_segment(ref, params, 4, box=boxt)
    prog = domain.make_outer_md_program(CFG, spec, lc, MASS, 0.5, **kw)
    out, _, box_out, _, th = prog.run(state0, params, 3, 4)
    domain.check_segment_thermo(th)
    assert th["pe"].shape == (3, 4) and th["mig_overflow"].shape == (3, 2)
    assert torch.equal(th["pe"][-1], th_ref["pe"])
    _equal_states(out, ref)
    assert torch.equal(box_out, boxt)
    assert int(out.mask.sum()) == int(state0.mask.sum())


def test_static_no_ops_are_bit_exact(model):
    """Friction 0 is NVE, compressibility 0 a fixed box, through the outer
    program: the same trajectory bit for bit, generators untouched."""
    _, params = model
    *_, box, _, spec, state0 = _md_setup((2, 2), model)
    lc = comm.LocalComm(spec.n_slabs, 1, device=CPU)
    boxt = _boxt(box)

    def run(ensemble=None, barostat=None):
        prog = domain.make_outer_md_program(
            CFG, spec, lc, MASS, 0.5, ensemble=ensemble, barostat=barostat)
        ens = prog.init_ensemble_state(CPU)
        baro = prog.init_barostat_state(CPU)
        gens = [g.get_state() for g in stepper.generators_of((ens, baro))]
        st = prog.prime(params, state0, boxt)
        st, ens, b, baro, th = prog.run(st, params, 2, 3, ens, boxt, baro)
        domain.check_segment_thermo(th)
        assert all(torch.equal(g.get_state(), s) for g, s in zip(
            stepper.generators_of((ens, baro)), gens))
        return st, b, th

    nve = run()
    for ens, baro in [(api.NVTLangevin(friction=0.0, seed=7), None),
                      (None, api.BerendsenBarostat(
                          compressibility_per_gpa=0.0)),
                      (None, api.StochasticCellRescaleBarostat(
                          compressibility_per_gpa=0.0, seed=5))]:
        st, b, th = run(ens, baro)
        _equal_states(st, nve[0])
        assert torch.equal(b, boxt)
        assert torch.equal(th["pe"], nve[2]["pe"])


def test_langevin_bricks_draw_their_own_noise(model):
    """Finite friction: every brick draws, the model shards of one brick
    draw the same (their states stay replicated), and atoms are kept."""
    _, params = model
    *_, box, _, spec, state0 = _md_setup((2, 2), model)
    lc = comm.LocalComm(spec.n_slabs, 2, device=CPU)
    prog = domain.make_outer_md_program(
        None, spec, lc, MASS, 1.0, decomp="slots",
        potential=api.LJPotential(sel=(64,), rcut_lj=4.0),
        ensemble=api.NVTLangevin(friction=0.05, seed=3))
    ens = prog.init_ensemble_state(CPU)
    seeds = [e["gen"].initial_seed() for e in ens]
    assert len(set(seeds)) == spec.n_slabs
    before = [e["gen"].get_state() for e in ens]
    st, ens, _, _, th = prog.run(prog.prime({}, state0, _boxt(box)), {}, 2,
                                 3, ens, _boxt(box))
    domain.check_segment_thermo(th)
    assert all(not torch.equal(e["gen"].get_state(), b)
               for e, b in zip(ens, before))
    assert int(st.mask.sum()) == int(state0.mask.sum())
    assert torch.isfinite(th["pe"]).all()


def test_trajectory_follows_the_single_process_engine(model, monkeypatch):
    """20 steps at dt 1 fs from the same positions and velocities: the
    distributed run (migration every 10 steps) against the reference's
    single-process driver (fed the same velocities) and the port's
    single-process scan engine, thermo at rtol 1e-5."""
    p_jax, params = model
    pos, typ, box, vel, spec, state0 = _md_setup((2, 2), model, seed=0)
    lc = comm.LocalComm(spec.n_slabs, 2, device=CPU)
    prog = domain.make_outer_md_program(CFG, spec, lc, MASS, 1.0,
                                        decomp="slots", neighbor="cells")
    boxt = _boxt(box)
    st, _, _, _, th = prog.run(prog.prime(params, state0, boxt), params, 2,
                               10, (), boxt)
    domain.check_segment_thermo(th)
    assert (th["n_atoms"] == len(pos)).all()
    sim = api.SimulationSpec(api.DPPotential(CFG, nsel_norm=CFG.nsel),
                             api.NVE(), steps=20, dt_fs=1.0, temp_k=330.0,
                             rebuild_every=10, thermo_every=1, skin=0.5,
                             seed=0)
    res = driver.run_simulation(sim, params, pos, typ, box, device=CPU)
    monkeypatch.setattr(jax_integrator, "init_velocities",
                        lambda key, masses, temp_k: jnp.asarray(vel))
    res_j = jax_driver.run_simulation(jax_api.SimulationSpec(
        jax_api.DPPotential(JaxDPConfig(**CFG_KW), nsel_norm=CFG.nsel),
        jax_api.NVE(), steps=20, dt_fs=1.0, temp_k=330.0, rebuild_every=10,
        thermo_every=1, skin=0.5, seed=0), p_jax, pos, typ, box)
    for r in (res, res_j):
        assert [row["step"] for row in r.thermo] == list(range(1, 21))
        for key in ("pe", "ke"):
            np.testing.assert_allclose(
                th[key].reshape(-1).numpy(),
                np.array([row[key] for row in r.thermo]), rtol=1e-5,
                err_msg=key)


def test_geometry_and_capacity_flags_reach_the_check(model):
    _, params = model
    *_, box, _, spec, state0 = _md_setup((4,), model)
    lc = comm.LocalComm(spec.n_slabs, 1, device=CPU)
    prog = domain.make_outer_md_program(CFG, spec, lc, MASS, 0.5)
    bad = _boxt([4 * 4.0, box[1], box[2]])
    _, _, _, _, th = prog.run(state0, params, 1, 1, box=bad)
    with pytest.raises(RuntimeError, match="geom_overflow"):
        domain.check_segment_thermo(th)
    tight = domain.DomainSpec.for_topology(tuple(box), (4,), 48, 4, RC_HALO)
    prog = domain.make_outer_md_program(CFG, tight, lc, MASS, 0.5)
    _, _, _, _, th = prog.run(state0, params, 1, 1, box=_boxt(box))
    with pytest.raises(RuntimeError, match="halo_overflow by"):
        domain.check_segment_thermo(th)
    with pytest.raises(RuntimeError, match=r"per-axis worst: \[0, 3\]"):
        domain.check_segment_thermo({"mig_overflow": torch.tensor(
            [[0, 3], [0, 1]], dtype=torch.int32)})
    with pytest.raises(ValueError, match="divide by the model axis"):
        domain.make_local_md_step(
            CFG, domain.DomainSpec.for_topology(tuple(box), (4,), 47, 40,
                                                RC_HALO), 2, MASS, 1.0,
            decomp="atoms")


def test_local_comm_collectives_under_thread_switching():
    """Eight ranks, many collectives with a tiny switch interval: every
    psum/pmax/ppermute gives the value a lost or mixed message would break;
    a ppermute with no source gives zeros; a rank's error is re-raised."""
    lc = comm.LocalComm(4, 2, device=CPU, timeout=60.0)
    topo = Topology((4,))

    def body(rank):
        bad = 0
        for it in range(60):
            x = torch.tensor([float(rank.rank + it)])
            s = rank.psum(x, comm.SPATIAL)
            want = sum(q * 2 + rank.model_index + it for q in range(4))
            bad += int(s.item() != want)
            bad += int(rank.pmax(x, comm.MODEL).item()
                       != rank.spatial_index * 2 + 1 + it)
            (got,) = rank.ppermute((x,), topo.plus_ring(0))
            src = (rank.spatial_index - 1) % 4
            bad += int(got.item() != src * 2 + rank.model_index + it)
        (z,) = rank.ppermute((torch.ones(2),), [(0, 1)])
        bad += int(rank.spatial_index != 1 and z.abs().sum().item() != 0)
        return bad

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        assert set(lc.run(body).values()) == {0}
    finally:
        sys.setswitchinterval(old)

    def fails(rank):
        if rank.rank == 5:
            raise KeyError("rank five")
        rank.psum(torch.zeros(1), comm.SPATIAL)
        return rank.rank

    with pytest.raises(KeyError, match="rank five"):
        lc.run(fails)


def test_launch_counters_survive_concurrent_ranks():
    """The kernels' launch counters (the dp_fused pair's, the force
    reduction's, DPA-1's attention pair's and the environment matrix
    pair's, as a replay adds them) are read-modify-writes shared by every
    rank thread: more threads than cores, a tiny switch interval, and not
    one update lost."""
    from repro_torch.kernels.dp_fused import attention, env, force, ops

    n_threads, per = 2 * (os.cpu_count() or 4) + 1, 500
    before = (ops.fwd_launches, ops.bwd_launches, force.force_launches,
              attention.attn_fwd_launches, attention.attn_bwd_launches,
              env.env_fwd_launches, env.env_bwd_launches)
    threads = [threading.Thread(target=lambda: [
                   stepper.count_replay((1, 2, 3, 4, 5, 6, 7))
                   for _ in range(per)])
               for _ in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = (ops.fwd_launches - before[0], ops.bwd_launches - before[1],
           force.force_launches - before[2],
           attention.attn_fwd_launches - before[3],
           attention.attn_bwd_launches - before[4],
           env.env_fwd_launches - before[5], env.env_bwd_launches - before[6])
    (ops.fwd_launches, ops.bwd_launches, force.force_launches,
     attention.attn_fwd_launches, attention.attn_bwd_launches,
     env.env_fwd_launches, env.env_bwd_launches) = before
    assert got == tuple(i * n_threads * per for i in range(1, 8))


def test_md_run_cli_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import md_run

    md_run.main(["--device", "cpu", "--local-ranks", "4", "--nx", "6",
                 "--steps", "6", "--rebuild-every", "3"])
    md_run.main(["--device", "cpu", "--local-ranks", "4", "--topology",
                 "2x2", "--nx", "4", "--nyz", "4", "--steps", "4",
                 "--rebuild-every", "2", "--engine", "scan", "--potential",
                 "lj"])
    md_run.main(["--device", "cpu", "--nx", "3", "--steps", "2"])
    out = capsys.readouterr().out
    assert out.count("atoms 216") == 1 and out.count("atoms 256") == 1
    assert "single process, 108 atoms" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        md_run.main(["--local-ranks", "4"])


@pytest.mark.parametrize("decomp,n_model", [("atoms", 1), ("slots", 2)])
def test_dist_comm_on_gloo_equals_local_comm(decomp, n_model, tmp_path):
    """2 x n_model gloo processes (DistComm) against as many threads
    (LocalComm): the same per-brick code, the same trajectory bit for bit.
    The (2,) x 2 slots grid holds the model-axis subgroups and the T sum
    with its identity backward (psum_same_grad) over gloo."""
    _torch_dist_worker.spawn(
        _torch_dist_worker.worker,
        (_torch_dist_worker.free_port(), str(tmp_path), n_model, decomp),
        2 * n_model, 240)
    got = np.load(tmp_path / "dist.npz")
    lc = comm.LocalComm(2, n_model, device=CPU)
    st, th = _torch_dist_worker.dist_case(lc, decomp)
    np.testing.assert_array_equal(got["pe"], th["pe"].numpy())
    whole = domain.gather_state(st, lc)
    for k, v in whole._asdict().items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
