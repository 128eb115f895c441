"""The DPA-1 family (``reference/dpa1.py``) and its cell on the CPU: the
weights' digest, the counts of work against a hand count, the readers on
synthetic calls and extras, and a tiny copy of the cell (``water(1, 1, 1)``,
192 atoms, narrow widths) run to ``correct: true``, failing an altered
force, and its control failing.

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

# ``inputs.weights_digest`` of the dpa1_water weights drawn on the CPU from
# model_seed 0: a change to the draw changes the model every run holds
DPA1_WATER_DIGEST = \
    "4569b44c395ed253d6e797751dcfccdc85840de93f69e027c8b3fa4502306708"

TINY_DPA1 = {
    "name": "tiny_dpa1", "source": "test", "family": "dpa1", "ntypes": 2,
    "rcut": 4.0, "rcut_smth": 0.5, "sel": 40, "type_map": ["O", "H"],
    "embed_widths": [4, 8, 16], "axis_neuron": 4, "tebd_dim": 8,
    "attn": 16, "attn_layer": 2, "attn_dotr": True,
    "fit_widths": [16, 16, 16], "dtype": "float32", "env_scale": "unit",
    "model_seed": 0}

# rcut + skin stays under half the 12.42 A box
TINY_DPA1_TRAFFIC = dict(
    TINY_TRAFFIC, entry="simulation_dpa1", dt_fs=0.5, steps=12,
    rebuild_every=6, skin=2.0, check={"follow_steps": 12},
    system={"kind": "water", "cells": [1, 1, 1], "orientation_seed": 0})

# set from the tiny cell's own readings on the CPU: the port against the
# reference at most 2.4e-8 / 6.2e-9 / 7.5e-9 / 1.2e-7 / 1.6e-8 over five
# seeds, the emulated TF32 control at the least 3.2e-5 / 8.6e-8 / 7.2e-7 /
# 2.9e-6 / 2.8e-5 over three
TINY_DPA1_LIMITS = {"pe_rows": 1e-6, "ke_rows": 3e-8, "vel_end": 5e-8,
                    "pos_end": 1e-6, "pe_end": 1e-6}


@pytest.fixture
def dpa1_cell(tiny_base):
    path, base = tiny_base
    (base / "configs" / "tiny_dpa1.json").write_text(json.dumps(TINY_DPA1))
    (base / "traffic" / "tiny_dpa1.json").write_text(
        json.dumps(TINY_DPA1_TRAFFIC))
    (base / "limits" / "tiny_dpa1.json").write_text(
        json.dumps({"limits": TINY_DPA1_LIMITS}))
    bench = json.loads(path.read_text())
    bench["configs"].append({"name": "tiny_dpa1", "source": "test",
                             "file": "mdbench/configs/tiny_dpa1.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_dpa1", "config": "tiny_dpa1",
                               "traffic": "tiny_dpa1", "chips": 1,
                               "why": "test"})
    path.write_text(json.dumps(bench))
    return manifest.load("tiny_dpa1", path, base)


def test_the_dpa1_water_weights_are_the_ones_drawn_before():
    cell = manifest.load("dpa1.h2o.1card")
    assert cell.family.__name__ == "mdbench_family_dpa1"
    w = inputs.weights(cell.config, int(cell.config["model_seed"]),
                       torch.device("cpu"))
    assert inputs.weights_digest(w) == DPA1_WATER_DIGEST
    # tebd, N_s, N_t, two attention layers (in, out, LayerNorm), the
    # fitting's hidden layers with two idt and its head, dstd and ebias
    leaves = dict(inputs._leaves(w))
    assert len(leaves) == 2 + 2 * 3 + 2 * 3 + 2 * 6 + (2 * 3 + 2) + 2 + 2
    assert leaves["/fit/hidden/1/idt"].std() > 0


def test_the_ports_config_takes_every_field_the_file_gives():
    from repro_torch.core.types import WATER_DPA1, DPA1Config

    cfg = manifest.config_for(DPA1Config, manifest.load(
        "dpa1.h2o.1card").config)
    assert cfg == WATER_DPA1
    assert cfg.descriptor_dim + cfg.tebd_dim == 1608


# ------------------------------------------------------- counts of work

TINY_COUNT = {"ntypes": 2, "embed_widths": [2, 4], "attn": 2,
              "attn_layer": 1, "axis_neuron": 2, "tebd_dim": 1,
              "fit_widths": [3, 3]}


def test_the_counts_of_work_by_hand():
    """M = 4, attn 2, one layer; two atoms with 1 and 3 neighbours
    (sum n 4, sum n^2 10).

    Attention, a layer forward: per slot q/k/v 2 x 4 x 6 = 48, their norms
    10 x 2 = 20, the output 2 x 2 x 4 = 16, residual and LayerNorm 8 x 4 =
    32 (116); per pair q.k 4, the softmax and gates 8, weights x v 4 (16);
    the gates once 8 a pair; x 3: 3 (116 x 4 + (16 + 8) x 10) = 2112.
    Bytes: 4 x (8 + 4 + 12 + 8) = 128 a slot, the weights 4 x (24 + 6 + 8
    + 12) = 200 twice: 912."""
    family = manifest.family({"family": "dpa1"})
    nbytes, ops = family.attention_cost(TINY_COUNT, 4, 10)
    assert (nbytes, ops) == (912.0, 2112.0)
    # a whole evaluation from the totals alone: per slot 30 + N_s (4 + 16)
    # + 3 M + 8 M = 94; per atom the descriptor 2 x 4 x 2 x 4 = 64 and the
    # fitting 2 (9 x 3 + 3 x 3 + 3) = 78; x 3; the attention's pairs of
    # slots at 4^2 / 2 = 8, a lower bound of the 10 they are
    flops = family.force_eval_flops(TINY_COUNT, 2, 4)
    assert flops == 3 * (2 * 142 + 4 * 94) + 3 * (116 * 4 + 24 * 8)
    assert flops < 3 * (2 * 142 + 4 * 94) + family.attention_cost(
        TINY_COUNT, 4, 10)[1]
    # the published widths: ~128 MFLOP an atom at 90 live neighbours
    cfg = manifest.load("dpa1.h2o.1card").config
    per_atom = family.force_eval_flops(cfg, 1000, 90_000) / 1000
    assert 7e7 < per_atom < 1.3e8


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


def _section(t, live, slots, excess, atoms=10):
    return _rec("model.section", t, atoms=atoms, slots=slots, live=live,
                excess=excess)


def test_the_section_readers_on_synthetic_calls():
    grown = _call([_section(0, 90, 8, 10),
                   _rec("model.escalate", 1, where="build", excess=10,
                        slots=8, grown=16),
                   _section(2, 90, 16, -2), _section(5, 60, 8, 0)])
    calm = _call([_section(0, 60, 8, 0)])
    run = SimpleNamespace(calls=[None, None], extra={spans.KEY: [grown,
                                                                 calm]})
    # accepted counts: 90 of 10 x 16, 60 of 10 x 8, 60 of 10 x 8
    assert manifest.reader("dpa1.rcut_fill_share").read(run) == \
        pytest.approx(100.0 * 210 / 320)
    assert manifest.reader("dpa1.rcut_escalations").read(run) == 0.5
    # a program without the model's section: nothing to read
    bare = SimpleNamespace(calls=[None], extra={spans.KEY: [_call([])]})
    for name in ("dpa1.rcut_fill_share", "dpa1.rcut_escalations"):
        assert manifest.reader(name).read(bare) is None


def test_the_timing_readers_and_the_roofline():
    cell = manifest.load("dpa1.h2o.1card")
    run = SimpleNamespace(cell=cell, extra={}, calls=[None], window_s=2.0,
                          atoms=24_000, steps=30,
                          check=SimpleNamespace(live_pairs=[700_000,
                                                            1_460_000]))
    for name in ("dpa1.force_ms", "dpa1.attn_ms", "dpa1.attn_roofline"):
        assert manifest.reader(name).read(run) is None
    run.extra.update(dpa1_force_ms=150.0, dpa1_attn_ms=60.0,
                     dpa1_pairs=(2.16e6, 2.16e6 * 92))
    assert manifest.reader("dpa1.force_ms").read(run) == 150.0
    assert manifest.reader("dpa1.attn_ms").read(run) == 60.0
    nbytes, ops = cell.family.attention_cost(cell.config, 2.16e6,
                                             2.16e6 * 92)
    assert ops / cost.PEAK_FP32_FLOPS > nbytes / cost.HBM_BYTES_PER_S
    assert manifest.reader("dpa1.attn_roofline").read(run) == \
        pytest.approx(100.0 * ops / cost.PEAK_FP32_FLOPS / 0.060)
    flops = cell.family.force_eval_flops(cell.config, 24_000, 2_160_000)
    assert manifest.reader("dpa1.step.mfu").read(run) == pytest.approx(
        100.0 * flops * 31 / 2.0 / cost.PEAK_FP32_FLOPS)


def test_the_roofline_counts_the_pairs_of_the_last_call(dpa1_cell):
    from mdbench.reference.shared import neighbor_table

    pos, typ, box = inputs.system(dpa1_cell.traffic["system"],
                                  dpa1_cell.base)
    run = SimpleNamespace(cell=dpa1_cell, extra={}, box=box,
                          device=torch.device("cpu"),
                          calls=[SimpleNamespace(pos=pos)],
                          entry=SimpleNamespace(attention_eval=None))
    manifest.reader("dpa1.attn_roofline").measure(run)
    n = (neighbor_table(torch.as_tensor(pos), torch.as_tensor(
        box, dtype=torch.float32), TINY_DPA1["rcut"]) >= 0).sum(dim=1)
    assert run.extra["dpa1_pairs"] == (float(n.sum()),
                                       float((n * n).sum()))
    assert run.extra["dpa1_pairs"][1] > run.extra["dpa1_pairs"][0] ** 2 \
        / len(pos)


# ----------------------------------------------------- the tiny cell

def test_the_tiny_cell_is_correct(dpa1_cell):
    out = bench_run.run_cell(dpa1_cell, 2**31 + 4243, 0.2, False,
                             device="cpu")
    assert out["correct"], out["checks"]
    assert {k: v["limit"] for k, v in out["checks"].items()} == \
        TINY_DPA1_LIMITS
    assert out["metrics"]["us_per_step_atom"]["value"] > 0


def test_the_tiny_cell_fails_an_altered_force(dpa1_cell, monkeypatch):
    from repro_torch.core import dp_model

    forces = dp_model.energy_forces_from_rij

    def altered(*a, **k):
        e, f, v = forces(*a, **k)
        f = f.clone()
        f[0, 0] += 0.01
        return e, f, v
    monkeypatch.setattr(dp_model, "energy_forces_from_rij", altered)
    out = bench_run.run_cell(dpa1_cell, 2**31 + 98, 0.0, False, device="cpu")
    assert not out["correct"], out["checks"]


def test_the_tiny_cells_control_fails(dpa1_cell):
    numbers, out = control.control_outcome(dpa1_cell, 2**31 + 6, "cpu")
    assert not out.correct, out.line()
    assert math.isfinite(numbers["pe_end"])
