"""The DPA-2 family (``reference/dpa2.py``) and its cell on the CPU: the
weights' digest and the config, the counts of work against a hand count,
the six readers on synthetic calls and extras, and a tiny copy of the cell
(``water(1, 1, 1)``, 192 atoms, narrow widths, all six layers) run to
``correct: true``, failing an altered force, and its control failing.

    python -m pytest -q mdbench/tests
"""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from conftest import TINY_TRAFFIC  # noqa: E402
from mdbench import control, cost, inputs, manifest, spans  # noqa: E402
from mdbench import run as bench_run  # noqa: E402
from repro_torch import obs  # noqa: E402

# ``inputs.weights_digest`` of the dpa2_water weights drawn on the CPU from
# model_seed 0: a change to the draw changes the model every run holds
DPA2_WATER_DIGEST = \
    "dd46eb11698feb757cf943cddf592fa2c957a344b10251dc567bece07655cc5f"

TINY_DPA2 = {
    "name": "tiny_dpa2", "source": "test", "family": "dpa2", "ntypes": 2,
    "type_map": ["O", "H"], "tebd_dim": 8, "rcut": 4.0, "rcut_smth": 0.5,
    "sel": 40, "repinit_widths": [4, 8, 16], "repinit_axis": 4,
    "repformer_rcut": 3.0, "repformer_rcut_smth": 2.0, "repformer_sel": 20,
    "repformer_layers": 6, "g1_dim": 16, "g2_dim": 8, "attn2_hidden": 8,
    "attn2_heads": 4, "repformer_axis": 4, "fit_widths": [16, 16, 16],
    "dtype": "float32", "env_scale": "unit", "model_seed": 0}

# rcut + skin stays under half the 12.42 A box
TINY_DPA2_TRAFFIC = dict(
    TINY_TRAFFIC, entry="simulation_dpa2", dt_fs=0.5, steps=12,
    rebuild_every=6, skin=2.0, check={"follow_steps": 12},
    system={"kind": "water", "cells": [1, 1, 1], "orientation_seed": 0})

# set from the tiny cell's own readings on the CPU: the port against the
# reference at most 1.2e-9 / 3.7e-9 / 0 / 3.9e-10 (pe_rows, vel_end,
# pos_end, pe_end) over five seeds, the emulated TF32 control at the least
# 1.9e-5 / 1.5e-8 / 9.5e-7 / 1.9e-5 over three; ke_rows is left out (the
# control read 7.4e-10, under the port's 7.1e-9: float32 sums of the KE)
TINY_DPA2_LIMITS = {"pe_rows": 1e-7, "vel_end": 8e-9, "pos_end": 5e-7,
                    "pe_end": 1e-7}


@pytest.fixture
def dpa2_cell(tiny_base):
    path, base = tiny_base
    (base / "configs" / "tiny_dpa2.json").write_text(json.dumps(TINY_DPA2))
    (base / "traffic" / "tiny_dpa2.json").write_text(
        json.dumps(TINY_DPA2_TRAFFIC))
    (base / "limits" / "tiny_dpa2.json").write_text(
        json.dumps({"limits": TINY_DPA2_LIMITS}))
    bench = json.loads(path.read_text())
    bench["configs"].append({"name": "tiny_dpa2", "source": "test",
                             "file": "mdbench/configs/tiny_dpa2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_dpa2", "config": "tiny_dpa2",
                               "traffic": "tiny_dpa2", "chips": 1,
                               "why": "test"})
    path.write_text(json.dumps(bench))
    return manifest.load("tiny_dpa2", path, base)


def test_the_dpa2_water_weights_are_the_ones_drawn_before():
    cell = manifest.load("dpa2.h2o.1card")
    assert cell.family.__name__ == "mdbench_family_dpa2"
    w = inputs.weights(cell.config, int(cell.config["model_seed"]),
                       torch.device("cpu"))
    assert inputs.weights_digest(w) == DPA2_WATER_DIGEST
    # tebd, repinit's three layers, W0, g2's embedding; six layers of 7
    # dense layers (4 with a bias), LayerNorm and two residual vectors; the
    # fitting's hidden layers with two idt and its head, ebias
    leaves = dict(inputs._leaves(w))
    assert len(leaves) == 2 + 2 * 3 + 1 + 2 + 6 * (11 + 2 + 2) \
        + (2 * 3 + 2) + 2 + 1
    assert float(w["repformers"][0]["g1_res"].std()) == pytest.approx(
        0.01, rel=0.3)
    with pytest.raises(ValueError):
        inputs.weights(cell.config, 0, torch.device("cpu"), torch.ones(2, 4))


def test_the_ports_config_takes_every_field_the_file_gives():
    from repro_torch.core.types import WATER_DPA2, DPA2Config

    config = manifest.load("dpa2.h2o.1card").config
    cfg = manifest.config_for(DPA2Config, config)
    assert cfg == WATER_DPA2
    assert cfg.sections == (120, 40) and cfg.repinit_dim == 1200
    assert cfg.g1_mlp_dim == 640 and cfg.g1_dim + cfg.tebd_dim == 136
    fields = {f for f in DPA2Config.__dataclass_fields__}
    assert fields <= set(config)


# ------------------------------------------------------- counts of work

TINY_COUNT = {"ntypes": 2, "tebd_dim": 1, "rcut": 2.0,
              "repformer_rcut": 1.0, "repinit_widths": [2, 4],
              "repinit_axis": 1, "repformer_layers": 1, "g1_dim": 2,
              "g2_dim": 1, "attn2_hidden": 1, "attn2_heads": 1,
              "repformer_axis": 1, "fit_widths": [3]}


def test_the_counts_of_work_by_hand():
    """One layer, g1 2, g2 1, one head of 1, axis 1; two atoms with 1 and 3
    neighbours in the repformers' list (sum n 4, sum n^2 10).

    A layer forward: per atom v1 2 x 2 x 2 = 8, v3's input 2 x 1 x 3 x 2 =
    12, grrg and drrd 2 x 3 x 1 x 3 = 18, the rest 8 x 2 = 16 (54); per
    slot u1 2, q and k 4, v 2, the output 2, LayerNorm and the rest 10,
    v2 2 x 1 x 2 + 2 x 2 = 8, the switches 2 x 2 + 1 = 5, H 2 x 3 x 3 = 18
    (51); per pair 1 x (2 + 8 + 2) = 12; once g2's embedding 2 a slot and
    the gates 8 a pair: 3 (54 x 2 + 51 x 4 + 12 x 10 + 2 x 4 + 8 x 10) =
    1560. Bytes a layer: per atom 4 x 5 x 2 = 40 an atom (80), per slot
    4 x ((2 + 4 + 2) + (3 + 8 + 2)) = 84 (336), the weights 4 x 33 twice
    (264): 680."""
    family = manifest.family({"family": "dpa2"})
    assert family.weights_per_layer(TINY_COUNT) == 33
    assert family.repformer_cost(TINY_COUNT, 2, 4, 10) == (680.0, 1560.0)
    # a whole evaluation: per repinit slot 30 + 3 x 2 + N's second layer
    # 2 x 2 x 4 = 16 + T 8 x 4 = 32 (84); per atom D 2 x 4 x 1 x 4 = 32,
    # W0 2 x 4 x 2 = 16, the fitting 2 (3 x 3 + 3) = 24 (72); x 3; the
    # repformers' pairs of slots at 4^2 / 2 = 8, a lower bound of the 10
    # they are; six repinit pairs
    flops = family.force_eval_flops(TINY_COUNT, 2, 6, 4)
    rep = family.repformer_cost(TINY_COUNT, 2, 4, 8)[1]
    assert flops == 3 * (2 * 72 + 6 * 84) + rep
    assert flops < 3 * (2 * 72 + 6 * 84) + family.repformer_cost(
        TINY_COUNT, 2, 4, 10)[1]
    # without the repformers' count: a uniform density, (1 / 2)^3 of 6
    assert family.force_eval_flops(TINY_COUNT, 2, 6) == \
        family.force_eval_flops(TINY_COUNT, 2, 6, 0.75)
    # the published widths: ~38 MFLOP an atom at 84 and 27 neighbours,
    # the six repformer layers ~86% of it
    cfg = manifest.load("dpa2.h2o.1card").config
    per_atom = family.force_eval_flops(cfg, 1000, 84_000, 27_000,
                                       27_000 * 27) / 1000
    assert 3.3e7 < per_atom < 4.3e7
    share = family.repformer_cost(cfg, 1000, 27_000, 27_000 * 27)[1] \
        / 1000 / per_atom
    assert 0.8 < share < 0.9


# --------------------------------------------------------------- readers

PERF0, EPOCH0, MS = 10**9, 1_700_000_000 * 10**9, 10**6


def _rec(name, t_ms, **attrs):
    return obs.Record(name, hash((name, t_ms)) % 10**9, 1, 1,
                      PERF0 + int(t_ms * MS), PERF0 + int((t_ms + 1) * MS),
                      attrs, 0)


def _call(spans_):
    root = obs.Record("md.call", 1, None, 1, PERF0, PERF0 + 20 * MS,
                      {"clock": (PERF0, EPOCH0), "spans": len(spans_) + 1},
                      0)
    return obs.Call(root, list(spans_), 0)


def _section(t, section, live, slots, excess, atoms=10):
    return _rec("model.section", t, section=section, atoms=atoms,
                slots=slots, live=live, excess=excess)


def test_the_section_readers_on_synthetic_calls():
    grown = _call([_section(0, "repinit", 500, 120, -10),
                   _section(0.1, "repformer", 90, 8, 10),
                   _rec("model.escalate", 1, section="repformer",
                        where="build", excess=10, slots=8, grown=16),
                   _section(2, "repinit", 500, 120, -10),
                   _section(2.1, "repformer", 90, 16, -2),
                   _rec("model.escalate", 3, section="repinit",
                        where="segment", excess=1, slots=120, grown=192),
                   _section(5, "repinit", 500, 192, -40),
                   _section(5.1, "repformer", 60, 8, 0)])
    calm = _call([_section(0, "repinit", 500, 120, -10),
                  _section(0.1, "repformer", 60, 8, 0)])
    run = SimpleNamespace(calls=[None, None], extra={spans.KEY: [grown,
                                                                 calm]})
    # the repformers' accepted counts: 90 of 10 x 16, 60 of 10 x 8, twice
    assert manifest.reader("dpa2.sub_fill_share").read(run) == \
        pytest.approx(100.0 * 210 / 320)
    assert manifest.reader("dpa2.escalations").read(run) == 1.0
    # a program without the model's sections: nothing to read
    bare = SimpleNamespace(calls=[None], extra={spans.KEY: [_call([])]})
    for name in ("dpa2.sub_fill_share", "dpa2.escalations"):
        assert manifest.reader(name).read(bare) is None
    # a program without the recorder: nothing either
    lost = SimpleNamespace(calls=[None], extra={spans.KEY: None})
    for name in ("dpa2.sub_fill_share", "dpa2.escalations"):
        assert manifest.reader(name).read(lost) is None


def test_the_timing_readers_and_the_roofline():
    cell = manifest.load("dpa2.h2o.1card")
    run = SimpleNamespace(cell=cell, extra={}, calls=[None], window_s=2.0,
                          atoms=24_000, steps=30,
                          check=SimpleNamespace(live_pairs=[700_000,
                                                            1_300_000]))
    for name in ("dpa2.force_ms", "dpa2.repformer_ms",
                 "dpa2.repformer_roofline", "dpa2.step.mfu"):
        assert manifest.reader(name).read(run) is None
    run.extra.update(dpa2_force_ms=300.0, dpa2_repformer_ms=240.0,
                     dpa2_sub_pairs=(648_000.0, 648_000.0 * 28))
    assert manifest.reader("dpa2.force_ms").read(run) == 300.0
    assert manifest.reader("dpa2.repformer_ms").read(run) == 240.0
    nbytes, ops = cell.family.repformer_cost(cell.config, 24_000, 648_000.0,
                                             648_000.0 * 28)
    assert ops / cost.PEAK_FP32_FLOPS > nbytes / cost.HBM_BYTES_PER_S
    assert manifest.reader("dpa2.repformer_roofline").read(run) == \
        pytest.approx(100.0 * ops / cost.PEAK_FP32_FLOPS / 0.240)
    flops = cell.family.force_eval_flops(cell.config, 24_000, 2_000_000,
                                         648_000.0, 648_000.0 * 28)
    assert manifest.reader("dpa2.step.mfu").read(run) == pytest.approx(
        100.0 * flops * 31 / 2.0 / cost.PEAK_FP32_FLOPS)


def test_the_roofline_counts_the_pairs_of_the_last_call(dpa2_cell):
    from mdbench.reference.shared import neighbor_table

    pos, typ, box = inputs.system(dpa2_cell.traffic["system"],
                                  dpa2_cell.base)
    run = SimpleNamespace(cell=dpa2_cell, extra={}, box=box,
                          device=torch.device("cpu"),
                          calls=[SimpleNamespace(pos=pos)],
                          entry=SimpleNamespace(repformer_eval=None))
    manifest.reader("dpa2.repformer_roofline", dpa2_cell.base).measure(run)
    n = (neighbor_table(torch.as_tensor(pos), torch.as_tensor(
        box, dtype=torch.float32), TINY_DPA2["repformer_rcut"]) >= 0) \
        .sum(dim=1)
    assert run.extra["dpa2_sub_pairs"] == (float(n.sum()),
                                           float((n * n).sum()))
    # the mfu reader reads the same count, and makes it where absent
    again = SimpleNamespace(**{**vars(run), "extra": {}})
    manifest.reader("dpa2.step.mfu", dpa2_cell.base).measure(again)
    assert again.extra == run.extra


# ----------------------------------------------------- the tiny cell

def test_the_tiny_cell_is_correct(dpa2_cell):
    out = bench_run.run_cell(dpa2_cell, 2**31 + 4243, 0.2, False,
                             device="cpu")
    assert out["correct"], out["checks"]
    assert {k: v["limit"] for k, v in out["checks"].items()} == \
        TINY_DPA2_LIMITS
    assert out["metrics"]["us_per_step_atom"]["value"] > 0


def test_the_tiny_cell_fails_an_altered_force(dpa2_cell, monkeypatch):
    from repro_torch.core import dp_model

    forces = dp_model.energy_forces_from_rij

    def altered(*a, **k):
        e, f, v = forces(*a, **k)
        f = f.clone()
        f[0, 0] += 0.01
        return e, f, v
    monkeypatch.setattr(dp_model, "energy_forces_from_rij", altered)
    out = bench_run.run_cell(dpa2_cell, 2**31 + 98, 0.0, False, device="cpu")
    assert not out["correct"], out["checks"]


def test_the_tiny_cells_control_fails(dpa2_cell):
    numbers, out = control.control_outcome(dpa2_cell, 2**31 + 6, "cpu")
    assert not out.correct, out.line()
    assert math.isfinite(numbers["pe_end"])
