"""The distributed outer program's captured segment on the CPU
(``repro_torch.md.domain.StaticSegment``).

On the card :meth:`OuterMDProgram.run` records one segment of every rank
this process runs (migration sweeps, then the steps) as a CUDA graph over
static carry buffers and replays it: all ranks of a ``LocalComm``, the one
rank of a ``DistComm`` process. Here the same segment function runs
eagerly against its own buffers: three calls equal three segments of the
eager program bit for bit, each rank draws from persistent generators of
its own (a restored state draws the same noise again), and no op of a
segment reads a device value on the host, which a capture would refuse.
Under ``DistComm`` the same holds on gloo processes (worker in
``tests/_torch_dist_worker.py``), against ``LocalComm`` too, with every
process escalating together and a capture that fails on one process
raising on all of them.
"""

import gc
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dp_model  # noqa: E402
from repro_torch.core.types import DPConfig  # noqa: E402
from repro_torch.md import (  # noqa: E402
    api, comm, domain, integrator, lattice, stepper)

import _torch_dist_worker as worker  # noqa: E402
from _torch_dist_worker import NoHostSync  # noqa: E402

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


def test_release_graphs_drops_every_recorded_graph(monkeypatch):
    """NCCL destroys no communicator while a graph that recorded its calls
    lives, and a failed run's frames may still hold its programs:
    ``release_graphs`` drops the graph of every live segment (which then
    runs eagerly), and the registry keeps no segment alive."""
    spec, state0, boxt = _setup()
    prog = _program(spec, comm.LocalComm(spec.n_slabs, 2, device=CPU),
                    "langevin")
    ens = prog.init_ensemble_state(CPU)
    seg = domain.StaticSegment(prog, {}, (state0, ens, boxt, ()), 3)
    graph = object()
    monkeypatch.setattr(stepper, "capture_graph",
                        lambda *a, **k: (graph, {}, (0, 0)))
    seg.capture()
    assert seg.graph is graph
    domain.release_graphs()
    assert seg.graph is None
    seg.capture()
    ref = weakref.ref(seg)
    del seg
    gc.collect()
    assert ref() is None


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


# ------------------------------------------------ one process per rank (gloo)

_SPAWNED = {}


def _spawned(n_model, decomp, tmp_path_factory):
    """The capture worker's results, rank by rank, for 2 x ``n_model``
    gloo processes (spawned once per grid); the 2-process grid runs the
    guard, escalation and failure cases too."""
    key = (n_model, decomp)
    if key not in _SPAWNED:
        out = tmp_path_factory.mktemp(f"dist_capture_{n_model}")
        worker.spawn(worker.capture_worker,
                     (worker.free_port(), str(out), n_model, decomp,
                      n_model == 1), 2 * n_model, 180)
        _SPAWNED[key] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                         for r in range(2 * n_model)]
    return _SPAWNED[key]


def _equal_whole(a, b):
    for f, x, y in zip(domain.SlabState._fields, a, b):
        assert torch.equal(x, y), f


@pytest.mark.parametrize("kind", ["nve", "langevin"])
@pytest.mark.parametrize("decomp,n_model", [("atoms", 1), ("slots", 2)])
def test_dist_static_segment_equals_eager_dist_comm_and_local_comm(
        decomp, n_model, kind, tmp_path_factory):
    """Each gloo process's segment (its own rank's, on its static buffers),
    called three times, against three segments of the eager DistComm
    program in that process (bit for bit, checked there: states, box,
    thermo, generators), and the gathered result against the same segment
    on a LocalComm of the same grid, bit for bit. In the (2,) x 2 slots
    grid, model shard 1's rank is not its brick's lowest."""
    runs = _spawned(n_model, decomp, tmp_path_factory)
    for r, got in enumerate(runs):
        assert got[kind][1] == [], (r, got[kind][1])
    lc = comm.LocalComm(2, n_model, device=CPU)
    want, bad = worker.static_case(lc, decomp, kind)
    assert bad == []
    got = runs[0][kind][0]
    _equal_whole(got["state"], want["state"])
    for k in ("pe", "ke"):
        assert torch.equal(got[k], want[k]), k
    # each process's brick's generators == LocalComm's for that brick
    for r, run in enumerate(runs):
        b = r // n_model
        assert all(torch.equal(x, y) for x, y in zip(
            run[kind][0]["gens"], want["gens"][b:b + 1])), r


def test_dist_segment_reads_nothing_on_the_host(tmp_path_factory):
    """Under DistComm, one segment of each process's rank runs under the
    dispatch mode that refuses host reads, gloo calls included."""
    for r, got in enumerate(_spawned(1, "atoms", tmp_path_factory)):
        assert got["guard"] == [], (r, got["guard"])


def test_dist_overflow_escalates_every_process_together(tmp_path_factory):
    """A halo capacity too small for the bricks, through the captured
    path's control flow: every process sees the same flags, escalates the
    same times and builds a new program (a capture and a replay each), and
    the passing run equals LocalComm's escalation bit for bit."""
    runs = _spawned(1, "atoms", tmp_path_factory)
    esc = [got["escalation"] for got in runs]
    assert len(esc[0]["tried"]) >= 2
    assert all(e["tried"] == esc[0]["tried"] for e in esc)
    assert all(e["counts"] == [(1, 1)] * len(esc[0]["tried"]) for e in esc)
    want = worker.escalation_case(comm.LocalComm(2, 1, device=CPU))
    assert want["tried"] == esc[0]["tried"]
    assert torch.equal(esc[0]["pe"], want["pe"])
    _equal_whole(esc[0]["state"], want["state"])


@pytest.mark.parametrize("where", ["warm-up", "capture"])
def test_dist_failed_capture_raises_on_every_process(where,
                                                     tmp_path_factory):
    """Rank 1's capture fails (after its warm-up's collectives, or in its
    recording): rank 1 raises its own error and rank 0, which got through,
    raises too, before any replay, within the spawn's deadline."""
    runs = _spawned(1, "atoms", tmp_path_factory)
    errors = [got[f"fail_{where}"] for got in runs]
    assert "refused on this process" in errors[1]
    assert errors[0] == f"the segment's {where} failed on another process"


def test_md_run_under_torchrun_counts_every_process(tmp_path):
    """md_run under torchrun on 2 gloo processes: the outer engine stays
    eager on the CPU and the last line sums the captures, replays and
    capture seconds over both processes (0 here), gathered once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"),
        OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.md_run",
         "--device", "cpu", "--nx", "6", "--nyz", "3", "--steps", "4",
         "--rebuild-every", "2", "--potential", "lj"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.count("us/step/atom") == 1
    assert ("graph captures 0, replays 0, capture 0.000 s over 2 processes"
            in r.stdout), r.stdout
