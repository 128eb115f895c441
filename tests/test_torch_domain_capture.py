"""The distributed outer program's captured segment on the CPU
(``repro_torch.md.domain.StaticSegment``).

On the card :meth:`OuterMDProgram.run` records one segment of every rank
(migration sweeps, then the steps) as a CUDA graph over static carry
buffers and replays it. Here the same segment function runs eagerly
against its own buffers: three calls equal three segments of the eager
program bit for bit, each rank draws from persistent generators of its own
(a restored state draws the same noise again), and no op of a segment
reads a device value on the host, which a capture would refuse.
"""

import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.core import dp_model  # noqa: E402
from repro_torch.core.types import DPConfig  # noqa: E402
from repro_torch.md import (  # noqa: E402
    api, comm, domain, integrator, lattice, stepper)

torch.set_num_threads(1)

CPU = "cpu"
CFG = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(64,),
               type_map=("Cu",), embed_widths=(8, 16, 32), axis_neuron=4,
               fit_widths=(32, 32, 32))
MASS = (63.546,)
LJ = api.LJPotential(sel=(64,), rcut_lj=4.0)


def _setup(seed=2):
    """fcc_copper(4,4,3) in (2, 2) bricks, Maxwell-Boltzmann velocities."""
    pos, typ, box = lattice.fcc_copper(4, 4, 3)
    rng = np.random.default_rng(seed)
    pos = np.mod(pos + rng.normal(0, 0.02, pos.shape), box).astype(
        np.float32)
    masses = torch.full((len(pos),), MASS[0])
    vel = integrator.init_velocities(torch.Generator().manual_seed(seed),
                                     masses, 330.0).numpy()
    spec = domain.DomainSpec.for_topology(tuple(box), (2, 2), 96, 96, 4.5)
    state, ovf = domain.partition_atoms(pos, vel, typ, spec)
    assert ovf <= 0
    return spec, state, torch.tensor(np.asarray(box, np.float32))


@pytest.fixture(scope="module")
def params():
    return dp_model.init_dp_params(torch.Generator().manual_seed(0), CFG,
                                   device=CPU)


def _program(spec, lc, kind, decomp="atoms", neighbor="cells"):
    kw = dict(decomp=decomp, neighbor=neighbor)
    if kind == "npt_scr":
        kw.update(potential=LJ,
                  ensemble=api.NVTLangevin(friction=0.05, seed=3),
                  barostat=api.StochasticCellRescaleBarostat(
                      compressibility_per_gpa=0.05, tau_fs=50.0, seed=5))
    elif kind == "langevin":
        kw.update(potential=LJ,
                  ensemble=api.NVTLangevin(friction=0.05, seed=3))
    return domain.make_outer_md_program(None if kw.get("potential") else CFG,
                                        spec, lc, MASS, 0.5, **kw)


def _equal_states(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("decomp,neighbor,kind", [
    ("atoms", "cells", "nve"), ("slots", "brute", "nve"),
    ("atoms", "cells", "npt_scr")])
def test_static_segment_equals_the_outer_program_bit_for_bit(
        decomp, neighbor, kind, params):
    """The function a CUDA graph records, called three times against its
    static buffers, against three segments of the eager program from the
    same carry: states, box, thermo and the callers' generators."""
    spec, state0, boxt = _setup()
    lc = comm.LocalComm(spec.n_slabs, 2, device=CPU)
    prog = _program(spec, lc, kind, decomp, neighbor)
    p = {} if kind == "npt_scr" else params
    ens = prog.init_ensemble_state(CPU)
    baro = prog.init_barostat_state(CPU)
    start = stepper.snapshot((prog.prime(p, state0, boxt), ens, baro))
    st, ens, baro = stepper.restore(start)
    want, _, box_w, _, th_w = prog.run(st, p, 3, 4, ens, boxt, baro)
    gens_w = [g.get_state() for g in stepper.generators_of((ens, baro))]
    domain.check_segment_thermo(th_w)

    st, ens, baro = stepper.restore(start)
    seg = domain.StaticSegment(prog, p, (st, ens, boxt, baro), 4)
    seg.load(st, ens, boxt, baro)
    ths = [seg.replay() for _ in range(3)]
    seg.store_gens(ens, baro)
    assert seg.graph is None and seg.state.pos is not st.pos
    _equal_states(seg.state, want)
    assert torch.equal(seg.box, box_w)
    assert (kind == "npt_scr") != torch.equal(box_w, boxt)
    for k, v in th_w.items():
        assert torch.equal(torch.cat([t[k] for t in ths]), v), k
    assert all(torch.equal(g.get_state(), s) for g, s in zip(
        stepper.generators_of((ens, baro)), gens_w))


def test_persistent_generators_draw_per_brick_and_restore():
    """Every rank draws from its own generator; the model shards of one
    brick stay equal and the bricks differ; the callers take the lead
    shards' states; a fresh state draws fresh noise and a restored one the
    same noise again, bit for bit."""
    spec, state0, boxt = _setup()
    lc = comm.LocalComm(spec.n_slabs, 2, device=CPU)
    prog = _program(spec, lc, "langevin")
    ens = prog.init_ensemble_state(CPU)
    start = stepper.snapshot((prog.prime({}, state0, boxt), ens))
    st, ens = stepper.restore(start)
    seg = domain.StaticSegment(prog, {}, (st, ens, boxt, ()), 3)
    gens = [seg.trees[r][0]["gen"] for r in range(lc.n_ranks)]
    assert len({id(g) for g in gens}) == lc.n_ranks
    assert not {id(g) for g in gens} & {id(e["gen"]) for e in ens}

    seg.load(st, ens, boxt, ())
    before = [g.get_state() for g in gens]
    seg.replay()
    after = [g.get_state() for g in gens]
    assert not any(torch.equal(a, b) for a, b in zip(after, before))
    for b in range(spec.n_slabs):
        assert torch.equal(after[2 * b], after[2 * b + 1])
    assert len({bytes(after[2 * b].numpy())
                for b in range(spec.n_slabs)}) == spec.n_slabs
    vel = seg.state.vel.clone()
    assert int(seg.state.mask.sum()) == int(state0.mask.sum())
    seg.store_gens(ens, ())
    assert all(torch.equal(e["gen"].get_state(), after[2 * b])
               for b, e in enumerate(ens))

    seg.load(start.carry[0], ens, boxt, ())     # the noise moves on
    seg.replay()
    assert not torch.equal(seg.state.vel, vel)
    st, ens = stepper.restore(start)             # and comes back
    seg.load(st, ens, boxt, ())
    seg.replay()
    assert torch.equal(seg.state.vel, vel)


def test_a_dropped_program_takes_its_segments_along():
    """No reference cycle between a program and its segments: on the card
    a dropped program's graphs and their memory pool go with it, before
    any garbage collection (a later phase needs that memory)."""
    spec, state0, boxt = _setup()
    prog = _program(spec, comm.LocalComm(spec.n_slabs, 2, device=CPU),
                    "langevin")
    ens = prog.init_ensemble_state(CPU)
    prog._graphs[3] = domain.StaticSegment(prog, {}, (state0, ens, boxt, ()),
                                           3)
    refs = (weakref.ref(prog), weakref.ref(prog._graphs[3]))
    gc.disable()
    try:
        del prog
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


_aten = torch.ops.aten
# ops that read a device value on the host or size their output by data
_SYNCS = {_aten._local_scalar_dense, _aten.item, _aten.nonzero,
          _aten.masked_select, _aten._unique2, _aten.unique_consecutive,
          _aten.unique_dim}
_COPIES = {_aten._to_copy, _aten.copy_, _aten._copy_from}


class NoHostSync(TorchDispatchMode):
    """Raises on an op that would make the host wait for the device: a
    scalar read, an output sized by the data, a copy to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in _SYNCS:
            raise AssertionError(f"host sync: {func}")
        if packet in _COPIES:
            src = args[0] if packet is _aten._to_copy else args[1]
            dst = (kwargs.get("device") if packet is _aten._to_copy
                   else args[0].device)
            if (dst is not None and torch.device(dst).type == "cpu"
                    and src.device.type != "cpu"):
                raise AssertionError(f"copy to the host: {func}")
        return func(*args, **kwargs)


class GuardedComm(comm.LocalComm):
    """LocalComm whose ranks run under :class:`NoHostSync` (a dispatch mode
    holds for the thread that enters it only)."""

    def run(self, fn):
        def guarded(rank):
            with NoHostSync():
                return fn(rank)
        return super().run(guarded)


@pytest.mark.parametrize("kind", ["nve", "npt_scr"])
def test_a_segment_reads_nothing_on_the_host(kind, params):
    """One segment of migration and two steps on every rank, the DP model
    through the brick cell list, and a Langevin + stochastic cell rescale
    run: no op of it would wait for the device."""
    with pytest.raises(AssertionError, match="host sync"):
        with NoHostSync():
            int(torch.ones(()))
    spec, state0, boxt = _setup()
    lc = GuardedComm(spec.n_slabs, 2, device=CPU)
    prog = _program(spec, lc, kind)
    p = {} if kind == "npt_scr" else params
    ens = prog.init_ensemble_state(CPU)
    baro = prog.init_barostat_state(CPU)
    st = prog.prime(p, state0, boxt)
    seg = domain.StaticSegment(prog, p, (st, ens, boxt, baro), 2)
    seg.load(st, ens, boxt, baro)
    with NoHostSync():
        th = seg.replay()
    domain.check_segment_thermo(th)
    assert th["pe"].shape == (1, 2)
    assert int(seg.state.mask.sum()) == int(state0.mask.sum())
