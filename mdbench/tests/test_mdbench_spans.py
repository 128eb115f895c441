"""The readers of the port's own spans and counters (``mdbench/spans.py``
and seven readers under ``metrics/``), on synthetic call records, on a
synthetic profile whose device rows and spans overlap in known ways, and
on the spans of real calls of the port on the CPU.

    python -m pytest -q mdbench/tests/test_mdbench_spans.py
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from mdbench import manifest, spans  # noqa: E402
from repro_torch import obs  # noqa: E402

READERS = ("nbr.fill_share", "nbr.cell_escalations", "nbr.sel_escalations",
           "nbr.build_ms", "model.first_force_ms",
           "driver.call_overhead_share", "device.idle_unspanned")

PERF0 = 1_000_000_000           # the roots' perf_counter_ns at their clock
EPOCH0 = 1_700_000_000 * 10**9  # ... and time_ns
MS = 1_000_000


def _read(name, run):
    return manifest.reader(name).read(run)


def _rec(name, t0_ms, t1_ms, call=1, id_=None, **attrs):
    return obs.Record(name, id_ or hash((name, t0_ms)) % 10**9, call, call,
                      PERF0 + t0_ms * MS, PERF0 + t1_ms * MS, attrs, 0)


def _build(t0, t1, attempt, sel, overflow, section, bins, filled, atoms=10):
    return _rec("nbr.build", t0, t1, attempt=attempt, atoms=atoms, sel=sel,
                cell_capacity=64, overflow=overflow, section_excess=section,
                bin_excess=bins, filled=filled)


def _call(spans_, t1_ms=10, lost=0, call=1):
    root = obs.Record("md.call", call, None, call, PERF0, PERF0 + t1_ms * MS,
                      {"clock": (PERF0, EPOCH0), "spans": len(spans_) + 1},
                      0)
    return obs.Call(root, list(spans_), lost)


def _run(calls, n_calls=None, profile=None, stretch=None):
    return SimpleNamespace(calls=[None] * (n_calls or len(calls)),
                           extra={spans.KEY: calls}, profile=profile,
                           stretch=stretch)


def _escalating_call():
    """Two bin escalations, then a section one, then the accepted build;
    one segment's build later; loop 6 of 10 ms."""
    return _call([
        _build(0.0, 0.5, 0, (8,), 30, 0, 30, 70),
        _build(0.5, 1.0, 1, (16,), 10, 0, 10, 150),
        _build(1.0, 1.5, 2, (24,), 4, 4, -3, 240),
        _build(1.5, 2.5, 3, (40,), 0, 0, -9, 280),
        _rec("model.first_force", 2.5, 3.5),
        _rec("driver.loop", 3.5, 9.5),
        _build(6.0, 7.0, 0, (40,), -2, 0, -9, 300),
        _rec("md.result", 9.5, 10.0)])


def test_readers_on_synthetic_calls():
    run = _run([_escalating_call(), _escalating_call()])
    assert _read("nbr.cell_escalations", run) == 2.0
    assert _read("nbr.sel_escalations", run) == 1.0
    # accepted builds: 280 and 300 filled of 10 atoms x 40 slots, twice
    assert _read("nbr.fill_share", run) == pytest.approx(
        100.0 * 580 / 800)
    assert _read("nbr.build_ms", run) == pytest.approx(3.5)
    assert _read("model.first_force_ms", run) == pytest.approx(1.0)
    assert _read("driver.call_overhead_share", run) == pytest.approx(40.0)


def test_brute_force_builds_count_no_bin_escalation():
    call = _call([_build(0, 1, 0, (8,), 5, 5, None, 80),
                  _build(1, 2, 1, (16,), 0, 0, None, 130),
                  _rec("driver.loop", 2, 9)])
    run = _run([call])
    assert _read("nbr.cell_escalations", run) == 0.0
    assert _read("nbr.sel_escalations", run) == 1.0
    assert _read("nbr.fill_share", run) == pytest.approx(100 * 130 / 160)


def test_readers_find_nothing_where_calls_lack_their_spans():
    # the per-step engine: no host-side build
    call = _call([_rec("model.first_force", 0, 1), _rec("driver.loop", 1, 9),
                  _rec("md.result", 9, 10)])
    run = _run([call])
    for name in ("nbr.fill_share", "nbr.cell_escalations",
                 "nbr.sel_escalations", "nbr.build_ms"):
        assert _read(name, run) is None, name
    assert _read("model.first_force_ms", run) == pytest.approx(1.0)
    # a call without its loop span
    assert _read("driver.call_overhead_share", _run([_call([])])) is None


@pytest.mark.parametrize("why", ["no_recorder", "a_call_lost_spans",
                                 "a_root_missing", "no_calls"])
def test_every_reader_returns_none(why, monkeypatch):
    monkeypatch.setattr(spans, "recorder", lambda: None)
    calls = [_escalating_call()]
    stretch = _stretch([(0, 10)])
    if why == "no_recorder":        # a program without the recorder
        run = _run(calls, profile=stretch[0], stretch=stretch[1])
        run.extra.clear()
    elif why == "a_call_lost_spans":
        fake = SimpleNamespace(calls=lambda k: [calls[0]._replace(lost=1)])
        monkeypatch.setattr(spans, "recorder", lambda: fake)
        run = _run(calls, profile=stretch[0], stretch=stretch[1])
        run.extra.clear()
    elif why == "a_root_missing":   # two calls in the window, one root kept
        fake = SimpleNamespace(calls=lambda k: calls[-k:])
        monkeypatch.setattr(spans, "recorder", lambda: fake)
        run = _run(calls, n_calls=2, profile=stretch[0], stretch=stretch[1])
        run.extra.clear()
    else:
        run = _run([], profile=stretch[0], stretch=stretch[1])
        run.calls = []
        run.extra.clear()
    for name in READERS:
        assert _read(name, run) is None, name


# ------------------------------------------------- the profiler's timebase

def _stretch(device_us, t0_ms=0.0, t1_ms=10.0, start_ns=EPOCH0):
    """A profile summary with device rows at ``device_us`` (us from the
    trace's start) and a stretch from ``t0_ms`` to ``t1_ms`` of the roots'
    perf clock, with the trace started at ``start_ns``."""
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(trace_start_ns=lambda: start_ns)))
    stretch = SimpleNamespace(prof=prof, t0=(PERF0 + t0_ms * MS) / 1e9,
                              t1=(PERF0 + t1_ms * MS) / 1e9)
    return {"spans": [(a, b, "k") for a, b in device_us]}, stretch


def test_idle_unspanned_on_a_synthetic_profile(capsys):
    # stretch 0-10 ms; device busy 0-4 and 6-7 ms; one span 3-5 ms and the
    # root over all: idle 4-6 and 7-10 ms (5 ms), of it 4-5 under the span
    profile, stretch = _stretch([(0, 4000), (6000, 7000)])
    call = _call([_rec("outer.fetch", 3, 5)])
    run = _run([call], profile=profile, stretch=stretch)
    assert _read("device.idle_unspanned", run) == pytest.approx(40.0)
    assert "outer.fetch 1.000" in capsys.readouterr().out


def test_idle_unspanned_moves_spans_by_the_clock_pair():
    # the trace started 2 ms (epoch) after the root's clock pair: the span
    # at 3-5 ms of the perf clock lies at 1-3 ms of the trace, and the
    # stretch's start at 0
    profile, stretch = _stretch([(0, 1000), (4000, 8000)], t0_ms=2.0,
                                t1_ms=10.0, start_ns=EPOCH0 + 2 * MS)
    call = _call([_rec("outer.replay", 3, 5), _rec("outer.fetch", 9, 11)])
    run = _run([call], profile=profile, stretch=stretch)
    # stretch 0-8 ms of the trace; idle 1-4 ms, of it 1-3 under the
    # replay: 1 of 8 ms idle outside spans (the fetch, cut at the
    # stretch's end, lies under a device row)
    assert _read("device.idle_unspanned", run) == pytest.approx(12.5)


def test_interval_helpers():
    u = spans.union([(5, 7), (0, 2), (1, 3), (6, 9), (12, 20)], 0, 15)
    assert u == [(0, 3), (5, 9), (12, 15)]
    assert spans.length(u) == 10
    assert spans.gaps(u, 0, 16) == [(3, 5), (9, 12), (15, 16)]
    assert spans.overlap(u, [(2, 6), (8, 13)]) == 1 + 1 + 1 + 1
    assert spans.to_trace_us(PERF0 + 5 * MS, (PERF0, EPOCH0),
                             EPOCH0 - MS) == pytest.approx(6000.0)


# ------------------------------------------------ the port's own calls

def test_readers_on_the_ports_calls():
    from repro_torch.md import api, lattice

    torch.set_num_threads(1)
    obs.reset()
    pos, typ, box = lattice.fcc_copper(4, 4, 4)
    spec = api.SimulationSpec(api.LJPotential(rcut_lj=4.0, sel=(24,)),
                              api.NVE(), steps=6, rebuild_every=3,
                              thermo_every=1, skin=0.5, engine="scan")
    res = [api.Simulation(spec).run({}, pos, typ, box, device="cpu")
           for _ in range(3)]
    run = SimpleNamespace(calls=[None, None], extra={}, profile=None,
                          stretch=None)
    manifest.reader("nbr.fill_share").measure(run)
    assert len(run.extra[spans.KEY]) == 2
    # 42 neighbours an atom in (24 -> 40 -> 64) slots
    assert res[-1].sel == (64,)
    assert _read("nbr.sel_escalations", run) == 2.0
    assert _read("nbr.cell_escalations", run) == 0.0
    assert 60.0 < _read("nbr.fill_share", run) <= 100.0 * 42 / 64
    assert _read("nbr.build_ms", run) > 0
    assert _read("model.first_force_ms", run) > 0
    assert 0 < _read("driver.call_overhead_share", run) < 100
    assert _read("device.idle_unspanned", run) is None   # no profile
