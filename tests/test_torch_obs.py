"""The port's span recorder (``repro_torch.obs``) and the spans and counters
of the single-process driver.

The recorder alone (nesting, call ids, threads, its bound, disabled), then
``run_simulation`` on a small FCC crystal under a Lennard-Jones potential
with each engine: each call's spans, the loop and capture spans against
``wall_s`` and ``capture_s``, the neighbour counters that say which
capacity overflowed, the escalation rule that grows only that capacity
(a run escalated by its bins is the run at the layout that grows both),
and the same results with the recorder disabled.

The last test needs an NVIDIA GPU and skips without one: with a profiler
over a captured run, the profile holds no row of the port's spans, and on
the profiler's timebase each ``outer.replay`` span holds its graph launch.
The file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_obs.py
"""

import dataclasses
import functools
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import dp_model  # noqa: E402
from repro_torch.core.types import DPA1Config, DPConfig  # noqa: E402
from repro_torch.md import (  # noqa: E402
    api, driver, integrator, lattice, neighbors, stepper)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# several pytest workers share the cores; the tensors here are small
torch.set_num_threads(1)

ENGINES = ("scan", "outer", "python")
# every call's spans, by engine; the outer engine on a card adds
# outer.capture and outer.replay
SPANS = {
    "scan": {"nbr.build", "model.first_force", "driver.loop",
             "driver.segment", "driver.fetch", "md.result"},
    "outer": {"nbr.build", "model.first_force", "driver.loop",
              "outer.chunk", "outer.fetch", "md.result"},
    "python": {"model.first_force", "driver.loop", "md.result"},
}


@pytest.fixture(autouse=True)
def fresh_recorder():
    obs.reset()
    obs.enable()
    yield
    obs.reset()
    obs.enable()


def _system():
    """256 Cu atoms, 3 cells of 4.85 A a side at rcut 4 + skin 0.5: 42
    neighbours an atom, about 10 atoms a cell."""
    return lattice.fcc_copper(4, 4, 4)


def _run(engine, sel=(48,), device="cpu", steps=12, seed=0):
    pos, typ, box = _system()
    spec = api.SimulationSpec(
        api.LJPotential(rcut_lj=4.0, sel=sel), api.NVE(), steps=steps,
        rebuild_every=5, thermo_every=1, skin=0.5, seed=seed, engine=engine,
        chunk_segments=2)
    return api.Simulation(spec).run({}, pos, typ, box, device=device)


def _small_bins(monkeypatch, capacity):
    monkeypatch.setattr(neighbors, "NeighborSpec", functools.partial(
        neighbors.NeighborSpec, cell_capacity=capacity))


# --------------------------------------------------------------- recorder

def test_spans_nest_under_their_parents_and_their_call():
    with obs.span("outside") as a:
        pass
    with obs.root("call", n=1) as r:
        with obs.span("outer") as o:
            with obs.span("inner", k=2) as i:
                i.set(filled=7)
    recs = {x.name: x for x in obs.records()}
    assert recs["outside"].call is None and recs["outside"].parent is None
    assert recs["call"].id == recs["call"].call == r.id
    assert recs["outer"].parent == r.id and recs["inner"].parent == o.id
    assert recs["inner"].call == recs["outer"].call == r.id
    assert recs["inner"].attrs == {"k": 2, "filled": 7}
    assert len(recs["call"].attrs["clock"]) == 2
    assert [x.name for x in obs.records()] == ["outside", "inner", "outer",
                                               "call"]
    assert recs["outer"].t0_ns <= recs["inner"].t0_ns \
        <= recs["inner"].t1_ns <= recs["outer"].t1_ns
    (call,) = obs.calls(5)
    assert call.root.name == "call" and call.lost == 0
    assert [s.name for s in call.spans] == ["inner", "outer"]
    assert a.ns >= 0


def test_calls_returns_the_last_k_in_order():
    for i in range(4):
        with obs.root("call", i=i):
            with obs.span("work"):
                pass
    got = obs.calls(2)
    assert [c.root.attrs["i"] for c in got] == [2, 3]
    assert all(len(c.spans) == 1 and c.lost == 0 for c in got)
    assert obs.calls(0) == []


def test_each_thread_keeps_its_own_stack():
    ready = threading.Barrier(2)

    def worker(tag):
        with obs.root("call", tag=tag):
            ready.wait()
            for _ in range(50):
                with obs.span("step", tag=tag):
                    pass
            ready.wait()

    threads = [threading.Thread(target=worker, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    calls = obs.calls(2)
    assert len(calls) == 2
    for c in calls:
        assert c.lost == 0 and len(c.spans) == 50
        assert {s.attrs["tag"] for s in c.spans} == {c.root.attrs["tag"]}
        assert {s.parent for s in c.spans} == {c.root.id}
        assert {s.thread for s in c.spans} == {c.root.thread}


def test_the_bound_drops_the_oldest_and_a_call_counts_its_losses():
    obs.reset(capacity=8)
    with obs.root("call"):
        for _ in range(10):
            with obs.span("step"):
                pass
    assert len(obs.records()) == 8 and obs.dropped() == 3
    (call,) = obs.calls(1)
    assert len(call.spans) == 7 and call.lost == 3
    with obs.root("next"):
        pass
    assert [c.root.name for c in obs.calls(2)] == ["call", "next"]
    assert obs.calls(2)[1].lost == 0 and obs.dropped() == 4


def test_a_disabled_recorder_records_nothing():
    obs.disable()
    with obs.root("call") as r:
        with obs.span("work", a=1) as s:
            s.set(b=2)
        with obs.timed("loop") as t:
            sum(range(1000))
    assert obs.records() == [] and obs.calls(1) == []
    assert r is s                                # the one shared no-op
    assert t.ns > 0 and t.seconds == t.ns * 1e-9  # a timed span still times


# ------------------------------------------------------------------ driver

@pytest.mark.parametrize("engine", ENGINES)
def test_each_call_has_its_spans_and_the_loop_is_wall_s(engine):
    res = _run(engine)
    (call,) = obs.calls(1)
    assert call.lost == 0 and call.root.name == "md.call"
    assert {k: call.root.attrs[k] for k in ("engine", "steps", "atoms")} \
        == {"engine": engine, "steps": 12, "atoms": 256}
    names = [s.name for s in call.spans]
    assert set(names) == SPANS[engine]
    for once in ("model.first_force", "driver.loop", "md.result"):
        assert names.count(once) == 1
    loop = [s for s in call.spans if s.name == "driver.loop"]
    assert sum(s.ns for s in loop) * 1e-9 == res.wall_s
    # every span lies inside the call, and the engine's own in the loop
    inner = {"driver.segment", "driver.fetch", "outer.chunk", "outer.fetch"}
    (lp,) = loop
    for s in call.spans:
        assert call.root.t0_ns <= s.t0_ns <= s.t1_ns <= call.root.t1_ns
        if s.name in inner:
            assert lp.t0_ns <= s.t0_ns <= s.t1_ns <= lp.t1_ns
    captures = [s for s in call.spans if s.name == "outer.capture"]
    assert sum(s.ns for s in captures) * 1e-9 == res.capture_s
    if engine == "scan":    # a host build at each of the two boundaries
        assert names.count("nbr.build") == 3
        assert names.count("driver.segment") == 3
    if engine == "outer":   # a chunk of 2 segments, then one of 2 steps
        assert names.count("outer.chunk") == names.count("outer.fetch") == 2


@pytest.mark.parametrize("engine", ["scan", "outer"])
def test_small_cell_bins_count_a_bin_escalation(engine, monkeypatch):
    _small_bins(monkeypatch, 8)
    res = _run(engine)
    (call,) = obs.calls(1)
    builds = [s.attrs for s in call.spans if s.name == "nbr.build"]
    first = [b for b in builds if b["overflow"] > 0]
    assert res.escalations >= 1 and first
    assert builds[0]["cell_capacity"] == 8 and builds[0]["bin_excess"] > 0
    assert all(b["bin_excess"] > 0 and b["section_excess"] <= 0
               for b in first)
    assert all(b["overflow"] == max(b["bin_excess"], b["section_excess"])
               for b in builds)


@pytest.mark.parametrize("engine", ["scan", "outer"])
def test_small_sections_count_a_section_escalation(engine):
    res = _run(engine, sel=(24,))
    (call,) = obs.calls(1)
    builds = [s.attrs for s in call.spans if s.name == "nbr.build"]
    over = [b for b in builds if b["overflow"] > 0]
    assert res.escalations >= 1 and builds[0]["section_excess"] == 42 - 24
    assert over and all(b["section_excess"] > 0 and b["bin_excess"] <= 0
                        for b in over)
    assert [b["attempt"] for b in builds[:len(over) + 1]] \
        == list(range(len(over) + 1))
    assert builds[len(over)]["sel"] == res.sel


@pytest.mark.parametrize("overflow", ["bins", "section"])
def test_only_the_capacity_that_overflowed_grows(overflow, monkeypatch):
    # bins of 8 hold ~10 atoms a cell; 24 slots hold 42 neighbours
    if overflow == "bins":
        _small_bins(monkeypatch, 8)
    res = _run("scan", sel=(48,) if overflow == "bins" else (24,))
    (call,) = obs.calls(1)
    builds = [s.attrs for s in call.spans if s.name == "nbr.build"]
    grew = [b["grew"] for b in builds if b["overflow"] > 0]
    assert res.escalations == len(grew) >= 1
    assert all("grew" not in b for b in builds if b["overflow"] <= 0)
    if overflow == "bins":
        assert grew == [("cell",)] * len(grew) and res.sel == (48,)
        assert builds[-1]["cell_capacity"] > 8
    else:
        assert grew == [("sel",)] * len(grew) and res.sel[0] >= 42
        assert {b["cell_capacity"] for b in builds} == {64}


@pytest.mark.parametrize("excess,grew", [
    ((0, 6), ("cell",)), ((18, -50), ("sel",)), ((18, 6), ("sel", "cell")),
    (None, ("sel", "cell")), ((18,), ("sel",))],
    ids=["bins", "section", "both", "unknown", "brute_force"])
@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_escalate_grows_what_overflowed(excess, grew, scale):
    policy = stepper.EscalationPolicy()
    spec = neighbors.NeighborSpec(rcut_nbr=4.5, sel=(24, 40), cell_capacity=8)
    got, names = policy.escalate(spec, excess, scale)
    assert names == grew and got.rcut_nbr == spec.rcut_nbr
    assert got.sel == (tuple(policy.grow(s, scale) for s in spec.sel)
                       if "sel" in grew else spec.sel)
    assert got.cell_capacity == (policy.grow(8, scale) if "cell" in grew
                                 else 8)
    assert policy.grow(24, 2.5) == 64 != policy.grow(24)


def test_the_volume_fold_is_taken_once():
    # a launch box 2.5x the volume: the first escalation grows both by 2.5,
    # the later ones grow the sections alone by the policy's 1.6
    pos, typ, box = _system()
    spec = neighbors.NeighborSpec(rcut_nbr=4.5, sel=(8,), cell_capacity=8)
    cfg = api.LJPotential(rcut_lj=4.0, sel=(8,)).layout_cfg()
    build = stepper.build_neighbors_escalating(
        cfg, spec, box, torch.as_tensor(pos, dtype=torch.float32),
        torch.as_tensor(typ), ref_box=np.asarray(box) * 2.5 ** (1 / 3))
    builds = [r.attrs for r in obs.records() if r.name == "nbr.build"]
    assert [(b["sel"], b["cell_capacity"], b.get("grew")) for b in builds] \
        == [((8,), 8, ("sel", "cell")), ((24,), 24, ("sel",)),
            ((40,), 24, ("sel",)), ((64,), 24, None)]
    assert build.escalations == 3 and build.spec.sel == (64,)


def test_a_run_escalated_by_its_bins_is_the_run_at_the_grown_layout(
        monkeypatch):
    # a small DP model, its descriptor normalised by its own 48 slots: the
    # bins' escalation keeps 48 slots where growing both took 80
    cfg = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(48,),
                   type_map=("Cu",), embed_widths=(8, 16, 32), axis_neuron=4,
                   fit_widths=(24, 24, 24))
    params = dp_model.init_dp_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    pot = api.make_potential("dp", cfg)
    pos, typ, box = _system()
    runs = []
    for start, cap in ((pot, 8), (pot.with_layout((80,)), 16)):
        _small_bins(monkeypatch, cap)
        spec = api.SimulationSpec(start, api.NVE(), steps=12, rebuild_every=5,
                                  thermo_every=1, skin=0.5, engine="scan")
        runs.append(api.Simulation(spec).run(params, pos, typ, box,
                                             device="cpu"))
    a, b = runs
    assert (a.escalations, a.sel, b.escalations, b.sel) == (1, (48,), 0, (80,))
    assert len(a.thermo) == len(b.thermo) == 12
    for ra, rb in zip(a.thermo, b.thermo):
        for key in ("pe", "ke", "etot"):
            np.testing.assert_allclose(ra[key], rb[key], rtol=1e-6,
                                       atol=1e-6, err_msg=key)
    np.testing.assert_allclose(a.final_pos, b.final_pos, atol=1e-6)
    np.testing.assert_allclose(a.final_vel, b.final_vel, atol=1e-7)
    # the forces at the end, each at its own run's layout
    forces = []
    for res in runs:
        x = torch.as_tensor(res.final_pos, dtype=torch.float32)
        nspec = neighbors.NeighborSpec(rcut_nbr=4.5, sel=res.sel,
                                       cell_capacity=16)
        build = stepper.build_neighbors_escalating(
            pot.layout_cfg(), nspec, box, x, torch.as_tensor(typ))
        assert build.escalations == 0
        forces.append(pot.with_layout(res.sel).energy_forces(
            params, x, torch.as_tensor(typ), build.nlist,
            box=stepper.pack_box(box, torch.device("cpu")))[1])
    np.testing.assert_allclose(forces[0].numpy(), forces[1].numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("cells", [3, 2], ids=["cell_list", "brute_force"])
def test_filled_slots_are_the_lists(cells):
    pos, typ, box = lattice.fcc_copper(cells + 1, cells + 1, cells + 1)
    rng = np.random.default_rng(0)
    pos = np.mod(pos + rng.normal(0, 0.1, pos.shape), box)
    spec = neighbors.NeighborSpec(rcut_nbr=4.5 if cells == 3 else 6.0,
                                  sel=(24,), cell_capacity=8)
    cfg = api.LJPotential(rcut_lj=4.0, sel=(24,)).layout_cfg()
    build = stepper.build_neighbors_escalating(
        cfg, spec, box, torch.as_tensor(pos, dtype=torch.float32),
        torch.as_tensor(typ))
    builds = [r.attrs for r in obs.records() if r.name == "nbr.build"]
    assert len(builds) == build.escalations + 1
    assert builds[-1]["filled"] == int((build.nlist >= 0).sum())
    assert builds[-1]["overflow"] <= 0 < builds[0]["overflow"]
    if cells == 2:          # brute force: no bins to overflow
        assert all(b["bin_excess"] is None for b in builds)


@pytest.mark.parametrize("engine", ENGINES)
def test_results_are_the_same_with_the_recorder_disabled(engine,
                                                         monkeypatch):
    # escalations of both kinds, but the per-step loop takes no escalation
    escalating = engine != "python"
    if escalating:
        _small_bins(monkeypatch, 8)
    runs = []
    for on in (True, False):
        (obs.enable if on else obs.disable)()
        runs.append(_run(engine, sel=(24,) if escalating else (48,), seed=3))
    assert obs.calls(2)[-1].root.attrs["engine"] == engine
    a, b = runs
    assert a.thermo == b.thermo
    for k in ("final_pos", "final_vel", "final_box", "stress"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for k in ("host_syncs", "overflow_checks", "overflow_worst", "sel",
              "escalations", "graph_captures", "graph_replays"):
        assert getattr(a, k) == getattr(b, k), k


# --------------------------------------------------------- the replay rule

ONE_ATTEMPT = stepper.EscalationPolicy(max_attempts=1)
# tests/test_torch_dpa1.py's narrow DPA-1 on water(1, 1, 1)
DPA1_CFG = DPA1Config(ntypes=2, rcut=4.0, rcut_smth=0.5, sel=40,
                      type_map=("O", "H"), embed_widths=(4, 8, 16),
                      axis_neuron=4, tebd_dim=8, attn=16, attn_layer=2,
                      fit_widths=(16, 16, 16))


def _small_dp():
    """A small DP copper model, its descriptor normalised by 48 slots."""
    cfg = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(48,),
                   type_map=("Cu",), embed_widths=(8, 16, 32), axis_neuron=4,
                   fit_widths=(24, 24, 24))
    return cfg, dp_model.init_dp_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")


def _water():
    from mdbench.systems import water

    pos, typ, box = water.water((1, 1, 1), 0)
    return np.mod(pos, box).astype(np.float32), typ, box


@pytest.mark.parametrize("cause", ["list", "section"])
@pytest.mark.parametrize("engine", ["scan", "outer"])
def test_a_run_gives_up_once_the_attempts_are_spent(engine, cause):
    """With one attempt, a run that overflows at its first host build stops
    there, its grown capacity untried: a list of 4 slots (the outer chunk
    replay's set-up) after one build, a DPA-1 section of 8 slots (the
    section escalation's, its list roomy) after one growth. Either engine
    raises the host build's error, before its loop."""
    if cause == "list":
        cfg, params = _small_dp()
        pot = api.make_potential("dp", cfg).with_layout((4,))
        ensemble = api.NVTLangevin(temp_k=330.0, friction=0.1, seed=7)
        (pos, typ, box), skin = lattice.fcc_copper(3, 3, 3), 0.5
        error = "neighbor capacity overflow persists after 1 escalations"
    else:
        pot = api.DPA1Potential(DPA1_CFG, capacity=8, nbr_sel=(64, 128))
        params = pot.init_params(torch.Generator().manual_seed(0), "cpu")
        ensemble, (pos, typ, box), skin = api.NVE(), _water(), 2.0
        error = "the model's section overflows after 1 escalations"
    spec = api.SimulationSpec(pot, ensemble, steps=12, rebuild_every=4,
                              thermo_every=1, skin=skin, engine=engine,
                              escalation=ONE_ATTEMPT)
    with pytest.raises(RuntimeError, match=error):
        api.Simulation(spec).run(params, pos, typ, box, device="cpu")
    (call,) = obs.calls(1)
    names = [s.name for s in call.spans]
    assert "driver.loop" not in names
    if cause == "list":
        assert names.count("nbr.build") == 1
    else:
        assert names.count("model.section") == 1
        assert [s.attrs["where"] for s in call.spans
                if s.name == "model.escalate"] == ["build"]


def test_an_outer_chunk_gives_up_once_the_attempts_are_spent(monkeypatch):
    """The outer chunk replay's set-up: a list built at 48 slots, the engine
    told 4. The chunk's in-graph rebuilds overflow; it runs again at 8
    slots, overflows again, and with one replay allowed the run stops,
    each attempt restored from its own snapshot."""
    cfg, params = _small_dp()
    pot = api.make_potential("dp", cfg)
    pos_np, typ_np, box_np = lattice.fcc_copper(3, 3, 3)
    pos = torch.tensor(pos_np, dtype=torch.float32)
    typ = torch.tensor(typ_np).long()
    boxt = stepper.pack_box(box_np, torch.device("cpu"))
    masses = torch.full((len(pos),), lattice.MASS["Cu"])
    vel = torch.as_tensor(integrator.init_velocities(
        torch.Generator().manual_seed(0), masses, 330.0))
    ens = api.NVTLangevin(temp_k=330.0, friction=0.1, seed=7)
    spec_ok = neighbors.NeighborSpec(rcut_nbr=cfg.rcut + 0.5, sel=cfg.sel)
    build_ok = stepper.build_neighbors_escalating(cfg, spec_ok, box_np, pos,
                                                  typ)
    _, f0, _ = pot.energy_forces(params, pos, typ, build_ok.nlist, box=boxt)
    small = stepper.NeighborBuild(
        build_ok.nlist, dataclasses.replace(cfg, sel=(4,)),
        dataclasses.replace(spec_ok, sel=(4,)), 0)
    carry = stepper.OuterCarry(pos, vel, f0, torch.zeros((), dtype=torch.int32),
                               ens.init_state("cpu"), boxt, ())
    taken = []
    snapshot = stepper.snapshot
    monkeypatch.setattr(stepper, "snapshot",
                        lambda c: taken.append(1) or snapshot(c))
    with pytest.raises(RuntimeError, match="neighbor capacity overflow "
                       r"persists after 1 chunk replays \(last spec: "
                       r"sel=\(16,\)"):
        driver._run_md_outer(pot, ens, params, carry, typ, box_np, masses,
                             small, torch.device("cpu"), steps=40, dt_fs=1.0,
                             rebuild_every=10, thermo_every=20,
                             chunk_segments=8, escalation=ONE_ATTEMPT)
    recs = obs.records()
    assert [r.attrs["attempt"] for r in recs if r.name == "outer.chunk"] \
        == [0, 1]
    assert [r.name for r in recs].count("outer.restore") == len(taken) == 2


@pytest.mark.parametrize("case", ["scan", "outer", "scan_section"])
def test_a_snapshot_is_taken_only_where_a_replay_can_be(case, monkeypatch):
    """A sectionless potential on the scan engine takes no snapshot; the
    outer engine takes one an attempt (here a squeeze through a cell count
    replays a chunk on a re-derived grid); a potential with a section of
    its own takes one a scan segment's attempt."""
    taken = []
    snapshot = stepper.snapshot
    monkeypatch.setattr(stepper, "snapshot",
                        lambda c: taken.append(1) or snapshot(c))
    if case == "scan_section":
        pot = api.DPA1Potential(DPA1_CFG, nbr_sel=(64, 128))
        params = pot.init_params(torch.Generator().manual_seed(0), "cpu")
        spec = api.SimulationSpec(pot, api.NVE(), steps=8, rebuild_every=4,
                                  thermo_every=1, skin=2.0, engine="scan")
        (pos, typ, box) = _water()
    else:
        params, (pos, typ, box) = {}, lattice.fcc_copper(4, 4, 4)
        spec = api.SimulationSpec(
            api.LJPotential(sel=(64,), rcut_lj=4.0),
            api.BerendsenThermostat(temp_k=50.0, tau_fs=50.0),
            barostat=api.BerendsenBarostat(pressure_gpa=120.0, tau_fs=30.0,
                                           compressibility_per_gpa=0.01),
            steps=120, temp_k=50.0, skin=0.5, rebuild_every=5,
            thermo_every=20, engine=case)
    res = api.Simulation(spec).run(params, pos, typ, box, device="cpu")
    (call,) = obs.calls(1)
    attempts = [s.attrs["attempt"] for s in call.spans
                if s.name == "outer.chunk"]
    segments = [s for s in call.spans if s.name == "driver.segment"]
    if case == "scan":
        assert taken == [] and len(segments) == 24
    elif case == "outer":
        assert res.grid_rebuilds > 0 and max(attempts) >= 1
        assert len(taken) == len(attempts)
    else:
        assert len(taken) == len(segments) == 2


# -------------------------------------------------------------- on a card

@pytest.mark.cuda
def test_no_profile_row_is_the_ports_and_replays_hold_their_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from torch.profiler import ProfilerActivity, profile

    from mdbench import spans

    _run("outer", device="cuda", steps=20)          # warms the card
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = _run("outer", device="cuda", steps=40)
    (call,) = obs.calls(1)
    mine = {s.name for s in call.spans} | {call.root.name}
    assert {"outer.capture", "outer.replay"} <= mine
    events = list(prof.events())
    assert not [e.name for e in events if e.name in mine]
    assert not [e.name for e in events
                if getattr(e, "is_user_annotation", False)]
    captures = [s for s in call.spans if s.name == "outer.capture"]
    assert sum(s.ns for s in captures) * 1e-9 == res.capture_s > 0

    start = spans.trace_start_ns(prof)
    on_trace = spans.span_intervals([call], start)
    replays = [(a, b) for a, b, n in on_trace if n == "outer.replay"]
    launches = sorted((e.time_range.start, e.time_range.end) for e in events
                      if e.name == "cudaGraphLaunch")
    assert len(replays) == len(launches) == res.graph_replays > 0
    for (a, b), (la, lb) in zip(sorted(replays), launches):
        assert a - 100.0 <= la <= lb <= b + 100.0, (a, b, la, lb)
