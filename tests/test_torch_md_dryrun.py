"""The port's MD dry run against the reference's, on the CPU.

``geometry`` and ``dp_model_flops`` are plain Python copied from
``repro.launch.md_dryrun``: every paper cell on both production grids, as a
slab column and as a 2-D brick topology, must give the reference's
``DomainSpec`` (its fields; the port derives ``cell_capacity`` where the
reference fixes it) and useful FLOPs on every rung. The reference's module
sets ``XLA_FLAGS`` to 512 host devices when imported, so it is imported
inside the test, after this process's JAX backend exists, and the variable
is put back. Its ``lower_md_cell`` (256-512 devices) is never called here.

The port's ``lower_md_cell`` traces under fake CPU tensors at a tiny size
(a tiny model on a 2 x 2 grid); no full-size trace runs here. The real run
of a rank stands a periodic brick in for the ring: its model shard's
energy must equal the single-process energy of the same atoms in the
periodic block, which only holds if the halo from its own far faces is
placed right.
"""

import json
import os

import pytest
torch = pytest.importorskip("torch")

from repro_torch.core import dp_model  # noqa: E402
from repro_torch.core.types import DPConfig  # noqa: E402
from repro_torch.launch import md_dryrun as md  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.md import api, comm as comm_mod, domain, neighbors, stepper  # noqa: E402

torch.set_num_threads(1)

TINY = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(48,),
                type_map=("Cu",), embed_widths=(8, 16, 32), axis_neuron=4,
                fit_widths=(24, 24, 24), table_lower=-1.0, table_upper=9.0)
TINY_CELL = md.MDCell("tiny", TINY, 1100, 1.0, (63.546,), 4 / 3.634**3)
GRID = mesh_mod.RankGrid(("data", "model"), (2, 2))
# (spatial ranks, topology): both production grids as a slab column and as
# a 2-D brick shape; 4x4 cannot hold 32 ranks in either package
_GRIDS = [(16, None), (16, "4x4"), (32, None), (32, "4x8"), (32, "4x4")]


def _reference():
    import jax

    jax.devices()                     # this process's backend exists first
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import md_dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


@pytest.mark.parametrize("grid", range(len(_GRIDS)))
@pytest.mark.parametrize("cell", ["cu", "cu_strong", "h2o"])
def test_geometry_and_model_flops_equal_reference(cell, grid):
    from repro.md.topology import Topology as RefTopology

    ref = _reference()
    n_slabs, topo = _GRIDS[grid]
    port_cell = md.CELLS[cell]
    ref_cell = {"cu": ref.CU, "cu_strong": ref.CU_STRONG,
                "h2o": ref.H2O}[cell]
    assert (port_cell.name, port_cell.atoms_per_chip, port_cell.dt_fs,
            port_cell.masses, port_cell.density) == (
        ref_cell.name, ref_cell.atoms_per_chip, ref_cell.dt_fs,
        ref_cell.masses, ref_cell.density)
    shape = RefTopology.parse(topo).shape if topo else None
    if shape is not None and RefTopology(shape).n_ranks != n_slabs:
        with pytest.raises(AssertionError):
            ref.geometry(ref_cell, n_slabs, 16, topology=shape)
        with pytest.raises(AssertionError):
            md.geometry(port_cell, n_slabs, 16, topology=shape)
        return
    want, cap_w = ref.geometry(ref_cell, n_slabs, 16, topology=shape)
    got, cap_g = md.geometry(port_cell, n_slabs, 16, topology=shape)
    assert cap_g == cap_w
    for f in ("box", "n_slabs", "atom_capacity", "halo_capacity",
              "rcut_halo", "topology"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.cell_capacity >= 96
    for impl in md.IMPLS:
        assert md.dp_model_flops(port_cell.cfg, cap_g * n_slabs, impl) == \
            ref.dp_model_flops(ref_cell.cfg, cap_w * n_slabs, impl)
    assert md.IMPLS == ref.IMPLS


def test_production_mesh_shapes():
    pod = mesh_mod.make_production_mesh()
    multi = mesh_mod.make_production_mesh(multi_pod=True)
    assert (pod.shape, pod.size) == ({"data": 16, "model": 16}, 256)
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.size == 512
    assert mesh_mod.batch_axes(pod) == ("data",)
    assert mesh_mod.batch_axes(multi) == ("pod", "data")
    assert mesh_mod.make_local_mesh() == (1, 1)
    with pytest.raises(ValueError):
        mesh_mod.make_local_mesh(2)


def _row_ok(row):
    assert row["status"] == "ok", row
    for k in ("flops/chip", "bytes/chip", "coll_bytes/chip", "mem_GiB",
              "cell_list_GiB", "t_memory"):
        assert row[k] > 0, k
    assert row["mem_GiB"] * 2**30 == row["arg_bytes"] + row["temp_bytes"]
    assert row["atoms_per_chip"] == TINY_CELL.atoms_per_chip
    return row


@pytest.mark.parametrize("impl", md.IMPLS)
def test_fake_cpu_rows_of_a_tiny_cell(impl):
    row = _row_ok(md.lower_md_cell(TINY_CELL, impl, GRID, False,
                                   segment_len=2, device="cpu", sel=(80,)))
    assert row["cell"] == f"dpmd_tiny/{impl}/2x2/sel80"
    assert (row["kernel_flops/chip"] > 0) == (impl == "cheb_pallas")
    # every step exchanges halos (permutes) and reduces thermo (all-reduce)
    assert row["coll_by_kind"]["collective-permute"] > 0
    assert row["coll_by_kind"]["all-reduce"] > 0


def test_fake_cpu_rows_outer_segments_and_lj():
    one = _row_ok(md.lower_md_cell(TINY_CELL, "cheb", GRID, False,
                                   segment_len=2, device="cpu"))
    outer = _row_ok(md.lower_md_cell(TINY_CELL, "cheb", GRID, False,
                                     segment_len=2, outer_segments=2,
                                     device="cpu"))
    assert outer["cell"] == "dpmd_tiny/cheb/2x2/outer2"
    assert outer["steps"] == 4
    # two segments and two migrations: more than twice one segment's bytes
    assert outer["coll_bytes/chip"] > 2 * one["coll_bytes/chip"]
    lj = _row_ok(md.lower_md_cell(TINY_CELL, "mlp", GRID, False,
                                  segment_len=2, potential_name="lj",
                                  device="cpu"))
    assert lj["cell"] == "lj_tiny/2x2"
    assert lj["flops/chip"] < one["flops/chip"]


def test_cli_writes_rows(tmp_path, monkeypatch):
    monkeypatch.setitem(md.CELLS, "cu", TINY_CELL)
    monkeypatch.setattr(mesh_mod, "make_production_mesh",
                        lambda multi_pod=False: GRID)
    out = tmp_path / "rows.json"
    assert md.main(["--device", "cpu", "--system", "cu", "--impl",
                    "cheb_pallas", "--segment-len", "1", "--out",
                    str(out)]) == 0
    (row,) = json.loads(out.read_text())
    assert row["status"] == "ok" and row["impl"] == "cheb_pallas"


def test_real_rank_halo_is_its_own_far_faces():
    """Model shard 0 of rank (0, 0) on a periodic fcc brick, its halo from
    its own faces (``self_image``): the shard's energy equals the
    single-process energy of the same atoms in the periodic block."""
    rank = md.rank_config(TINY_CELL, "cheb", GRID, False, sel=(80,))
    brick, spec, n = md.rank_brick(rank)
    cpu = torch.device("cpu")
    params = md._params(rank, cpu, 0)
    local = md._local(rank, spec)
    dry = comm_mod.DryRunComm(2, 2, self_image=True)
    out = local.forces(dry, params, brick.pos, brick.typ, brick.mask,
                       stepper.pack_box(spec.box, cpu))
    assert int(out.h_ovf) <= 0 and int(out.n_ovf) <= 0
    block = stepper.pack_box((spec.box[0] / 2, spec.box[1], spec.box[2]), cpu)
    pos, typ = brick.pos[:n], brick.typ[:n]
    nlist, ovf = neighbors.brute_force_neighbors(
        pos, typ, neighbors.NeighborSpec(rcut_nbr=TINY.rcut, sel=(80,)),
        block)
    assert int(ovf) <= 0
    rij, nmask = dp_model.gather_rij(pos, nlist, block)
    with torch.no_grad():
        e_i = dp_model.dp_atomic_energy(params, rank.cfg, rij, nmask, typ,
                                        impl="cheb", nsel_norm=80)
    centers = spec.atom_capacity // 2
    torch.testing.assert_close(out.e_local, e_i[:centers].sum(),
                               rtol=1e-5, atol=1e-5)
    # and the whole program runs on it: atoms kept, energy finite
    run = md.run_rank(rank, segment_len=1, device="cpu")
    assert run["n_atoms"] == [n] and run["peak_bytes"] is None
    assert abs(run["pe"][0] - float(out.e_local)) < 1e-2 * abs(
        float(out.e_local))


def test_run_rank_raises_on_neighbor_overflow():
    rank = md.rank_config(TINY_CELL, "mlp", GRID, False)   # sel 48 < 78
    with pytest.raises(RuntimeError, match="nbr_overflow"):
        md.run_rank(rank, segment_len=1, device="cpu")
    assert isinstance(rank.ensemble, api.NVE)


def test_self_image_migration_reenters_across_the_far_face():
    """With its halo from its own faces, an atom that leaves the brick
    through one face comes back through the other, one brick width on."""
    rank = md.rank_config(TINY_CELL, "cheb", GRID, False, sel=(80,))
    brick, spec, n = md.rank_brick(rank)
    width = spec.box[0] / spec.topology[0]
    pos = brick.pos.clone()
    pos[0, 0] = -0.25                 # out through the low face
    pos[1, 0] = width + 0.25          # out through the high face
    moved = brick._replace(pos=pos)
    dry = comm_mod.DryRunComm(2, 2, self_image=True)
    out, ovf = domain._migrate_brick(dry, moved, spec,
                                     stepper.pack_box(spec.box, "cpu"))
    assert int(ovf.max()) <= 0 and int(out.mask.sum()) == n
    got = out.pos[out.mask]
    want = pos[:n].clone()
    want[0, 0] += width
    want[1, 0] -= width
    key = lambda p: sorted(map(tuple, p.tolist()))   # noqa: E731
    assert key(got) == key(want)
