"""The port's brick geometry against the reference: ``Topology`` (rings,
rank <-> coordinate maps, widths, ``parse`` and its errors) and the host-side
``DomainSpec`` helpers (validation, capacity escalation, sel padding)."""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core.types import DPConfig as JaxDPConfig  # noqa: E402
from repro.md import domain as jax_domain  # noqa: E402
from repro.md import stepper as jax_stepper  # noqa: E402
from repro.md.topology import Topology as JaxTopology  # noqa: E402
from repro_torch.core.types import DPConfig  # noqa: E402
from repro_torch.md import domain, stepper  # noqa: E402
from repro_torch.md.topology import Topology  # noqa: E402

torch.set_num_threads(1)

SHAPES = [(2,), (4,), (5,), (2, 2), (2, 4), (3, 2), (2, 2, 2), (2, 3, 4)]


@pytest.mark.parametrize("shape", SHAPES)
def test_rings_and_coordinates_equal_reference(shape):
    t, j = Topology(shape), JaxTopology(shape)
    assert (t.ndim, t.n_ranks, t.axes, t.strides, t.label()) == \
        (j.ndim, j.n_ranks, j.axes, j.strides, j.label())
    for r in range(t.n_ranks):
        assert t.coords_of(r) == j.coords_of(r)
        assert t.rank_of(t.coords_of(r)) == r
        for a in t.axes:
            assert t.coord_along(r, a) == j.coord_along(r, a)
    for a in t.axes:
        assert t.plus_ring(a) == j.plus_ring(a)
        assert t.minus_ring(a) == j.minus_ring(a)
        for step in (-2, 3):
            assert t.ring(a, step) == j.ring(a, step)
    box = (30.0, 21.0, 17.5)
    assert t.widths(box) == j.widths(box)


def test_coord_along_takes_integer_tensors():
    t = Topology((2, 3, 4))
    ranks = torch.arange(t.n_ranks)
    for a in t.axes:
        assert t.coord_along(ranks, a).tolist() == \
            [t.coords_of(r)[a] for r in range(t.n_ranks)]


@pytest.mark.parametrize("text", ["2x2x2", "2,4", "4", 4, (2, 3), [3, 2],
                                  "2X3", "2x"])
def test_parse_equals_reference(text):
    assert Topology.parse(text).shape == JaxTopology.parse(text).shape
    assert Topology.parse(Topology.parse(text)).shape == \
        Topology.parse(text).shape


@pytest.mark.parametrize("bad", [(1, 4), (2, 2, 2, 2), (), (2, 0), "1", "x"])
def test_parse_errors_equal_reference(bad):
    with pytest.raises(ValueError) as jerr:
        JaxTopology.parse(bad)
    with pytest.raises(ValueError) as terr:
        Topology.parse(bad)
    assert str(terr.value) == str(jerr.value)


def _specs(topology, **kw):
    args = dict(box=(29.0, 14.5, 11.0), atom_capacity=48, halo_capacity=40,
                rcut_halo=4.5, **kw)
    return (domain.DomainSpec.for_topology(topology=topology, **args),
            jax_domain.DomainSpec.for_topology(topology=topology, **args))


@pytest.mark.parametrize("topology", [(4,), (2, 2), (2, 3), "2x2x2"])
def test_domain_spec_geometry_equals_reference(topology):
    t, j = _specs(topology)
    assert (t.n_slabs, t.topology, t.slab_width, t.brick_widths) == \
        (j.n_slabs, j.topology, j.slab_width, j.brick_widths)


@pytest.mark.parametrize("topology", [(8,), (2, 4), (2, 2, 3)])
def test_domain_spec_validation_matches_reference(topology):
    t, j = _specs(topology)
    with pytest.raises(AssertionError):
        j.validate()
    with pytest.raises(ValueError, match="halo cutoff"):
        t.validate()
    with pytest.raises(ValueError, match="bricks but n_slabs"):
        domain.DomainSpec(box=(10.0, 10.0, 10.0), n_slabs=3,
                          atom_capacity=8, halo_capacity=8, rcut_halo=1.0,
                          topology=(2, 2))


@pytest.mark.parametrize("box_now", [None, (29.0, 14.5, 11.0),
                                     (23.2, 11.6, 8.8), (31.0, 15.0, 12.0)])
@pytest.mark.parametrize("n_model", [1, 2, 3])
def test_escalation_equals_reference(box_now, n_model):
    t, j = _specs((2, 2))
    pol_t, pol_j = stepper.EscalationPolicy(), jax_stepper.EscalationPolicy()
    got = domain.escalate_capacities(t, pol_t, box_now=box_now,
                                     n_model=n_model)
    want = jax_domain.escalate_capacities(j, pol_j, box_now=box_now,
                                          n_model=n_model)
    assert (got.box, got.atom_capacity, got.halo_capacity, got.topology) == \
        (want.box, want.atom_capacity, want.halo_capacity, want.topology)
    scale = 1.0 if box_now is None else \
        jax_domain.capacity_scale_for_box(j, box_now)
    assert got.cell_capacity == pol_t.grow(t.cell_capacity, scale)
    if box_now is not None:
        assert domain.capacity_scale_for_box(t, box_now) == scale


@pytest.mark.parametrize("sel", [(64,), (46, 92), (7, 3, 5)])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_pad_sel_equals_reference(sel, n_shards):
    kw = dict(ntypes=len(sel), rcut=4.0, rcut_smth=2.0, sel=sel,
              type_map=tuple("ABC"[:len(sel)]))
    got = domain.pad_sel_for(DPConfig(**kw), n_shards)
    want = jax_domain.pad_sel_for(JaxDPConfig(**kw), n_shards)
    assert got.sel == want.sel
    assert dataclasses.replace(got, sel=sel) == DPConfig(**kw)
    assert all(s % n_shards == 0 for s in got.sel)


def test_partition_bins_clamp_both_ends_like_reference():
    t, j = _specs((2, 2))
    pos = np.array([[-0.1, 1.0, 1.0], [28.99, 14.4, 2.0], [14.6, -0.01, 5.0],
                    [3.0, 7.3, 10.9], [29.2, 20.0, 1.0]], np.float32)
    vel = np.arange(15, dtype=np.float32).reshape(5, 3)
    typ = np.zeros(5, np.int32)
    st_t, ovf_t = domain.partition_atoms(pos, vel, typ, t)
    st_j, ovf_j = jax_domain.partition_atoms(pos, vel, typ, j)
    assert ovf_t == ovf_j
    for a, b in zip(st_t[:4], st_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(st_t.mask.sum()) == 5


def _fullest_cell(pos, box, spec):
    """The most atoms (owned + ghost shell, periodic images) any cell of any
    brick frame's static grid holds, binned as ``slab_cells`` bins them."""
    from repro_torch.md import slab_cells

    topo, rc = spec.topo, spec.rcut_halo
    ncs, cs = slab_cells.static_grid(spec.box, spec.slab_width, rc,
                                     spec.topology)
    shifts = np.array(np.meshgrid(*[(-1, 0, 1)] * 3)).reshape(3, -1).T
    images = (pos[None] + shifts[:, None, :] * box).reshape(-1, 3)
    widths = topo.widths(box)
    worst = 0
    for r in range(topo.n_ranks):
        inside = np.ones(len(images), bool)
        idx = []
        for a in range(3):
            x = images[:, a]
            if a < topo.ndim:
                lo = topo.coord_along(r, a) * widths[a]
                inside &= (x >= lo - rc) & (x < lo + widths[a] + rc)
                idx.append(np.clip(((x - lo + rc) / cs[a]).astype(int), 0,
                                   ncs[a] - 1))
            else:
                inside &= (x >= 0) & (x < box[a])
                idx.append(np.floor(x / cs[a]).astype(int) % ncs[a])
        flat = (idx[0] * ncs[1] + idx[1]) * ncs[2] + idx[2]
        worst = max(worst, int(np.bincount(flat[inside]).max()))
    return worst


@pytest.mark.parametrize("topology", [(2, 2, 2), (2, 2), (4,)])
def test_derived_cell_capacity_holds_the_fullest_cell(topology):
    """Copper bricks with rcut_halo 10 A (cells of ~100 atoms, past the
    reference's fixed 96): the derived capacity holds the fullest cell of
    the jittered lattice; smaller cells keep the reference's 96; an
    explicit capacity is kept."""
    from repro_torch.md import lattice

    pos, _, box = lattice.fcc_copper(12, 12, 12)
    box = np.asarray(box, float)
    pos = np.mod(pos + np.random.default_rng(0).normal(0, 0.05, pos.shape),
                 box)
    n_bricks = int(np.prod(topology))
    cap = -(-len(pos) * 11 // (10 * n_bricks))        # 10% over the mean
    spec = domain.DomainSpec.for_topology(tuple(box), topology, cap, cap, 10.0)
    assert spec.cell_capacity == spec.derived_cell_capacity() > 96
    assert _fullest_cell(pos, box, spec) <= spec.cell_capacity
    small = domain.DomainSpec.for_topology(tuple(box), topology, cap, cap, 4.5)
    assert small.cell_capacity == 96
    assert _fullest_cell(pos, box, small) <= 96
    assert dataclasses.replace(spec, cell_capacity=40).cell_capacity == 40
