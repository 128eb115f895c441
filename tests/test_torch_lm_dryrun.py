"""The LM dry run (``repro_torch.launch.dryrun``) on fake CPU tensors over a
fake process group: per-rank counts of a DTensor program held to
arithmetic, tiny cells traced end to end, and the reference's row keys and
``model_flops``.

Every test that opens a process group closes it (``fake_process_group``
destroys it on exit; the ``no_group`` fixture checks), so the next test in
the same worker starts without one. The reference's ``launch.dryrun``
sets ``XLA_FLAGS`` to 512 host devices when imported, so it is imported
inside the tests with ``XLA_FLAGS`` restored.
"""

from __future__ import annotations

import dataclasses
import os

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.analysis import op_cost
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankGrid
from repro_torch.models import build
from repro_torch.models.lm_types import ASSIGNED_SHAPES, ShapeSpec
from repro_torch.sharding import plans, state
from repro_torch.train import tree

torch.set_num_threads(1)

GRID = RankGrid(("data", "model"), (2, 2))
CPU = torch.device("cpu")
# the reference's row: RooflineReport.row() and dryrun.py:259-270
REF_UPDATE_KEYS = {"cell", "status", "t_lower_s", "t_compile_s", "arg_bytes",
                   "temp_bytes", "out_bytes", "alias_bytes", "coll_by_kind",
                   "coll_count"}
PORT_KEYS = {"bound_time", "trace_s", "traced_layers", "hw", "hbm_bytes",
             "fits_hbm", "flops_by_dtype"}


def _reference():
    import jax

    jax.devices()                     # this process's backend exists first
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


@pytest.fixture(autouse=True)
def no_group():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _cell(kind):
    cfg = configs.get_reduced("qwen3-1.7b")
    shape = {"train": ShapeSpec("train_tiny", 32, 8, "train"),
             "decode": ShapeSpec("decode_tiny", 64, 8, "decode")}[kind]
    return cfg, shape, dryrun.lower_cell(cfg, shape, GRID, False,
                                         verbose=False, device="cpu")


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_tiny_cells_are_ok(kind):
    from repro.analysis import roofline as ref_rl

    _, _, row = _cell(kind)
    assert row["status"] == "ok", row.get("error")
    ref_report = ref_rl.RooflineReport(
        "x", 1, 1.0, 1.0, ref_rl.CollectiveStats({}, 0.0, 0.0, 0), 1.0,
        1.0, 1.0, 0.0, 0.0, 1.0, ref_rl.HW_V5E)
    assert set(row) == set(ref_report.row()) | REF_UPDATE_KEYS | PORT_KEYS
    assert row["cell"] == f"qwen3-1.7b-reduced/{kind}_tiny/2x2"
    assert row["flops/chip"] > 0 and row["mem_GiB"] > 0
    assert row["bound_time"] == max(row["t_compute"], row["t_memory"],
                                    row["t_ici"] + row["t_dcn"])
    assert row["coll_count"] > 0 and row["coll_by_kind"]
    # bf16 cells: the products run in bf16 and take the H100's bf16 peak
    by = row["flops_by_dtype"]
    assert set(by) == {"bfloat16"}
    assert sum(by.values()) == row["flops/chip"]
    assert row["t_compute"] == row["flops/chip"] / 989e12


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cut_depth_carries_every_count_to_the_full_trace(kind):
    """``depth=2`` (2 and 3 layers traced, carried to 5) gives the row of
    the 5-layer trace: every count and the peak."""
    cfg = dataclasses.replace(configs.get_reduced("qwen3-1.7b"), n_layers=5)
    shape = ShapeSpec(f"{kind}_tiny", 64 if kind == "decode" else 32, 8,
                      kind)
    full = dryrun.lower_cell(cfg, shape, GRID, False, verbose=False,
                             device="cpu")
    cut = dryrun.lower_cell(cfg, shape, GRID, False, verbose=False,
                            device="cpu", depth=2)
    assert full["status"] == cut["status"] == "ok"
    assert (full["traced_layers"], cut["traced_layers"]) == ([5], [2, 3])
    for key in ("flops/chip", "bytes/chip", "coll_bytes/chip", "t_compute",
                "t_memory", "t_ici", "t_dcn", "mem_GiB", "arg_bytes",
                "temp_bytes", "alias_bytes", "coll_by_kind", "coll_count",
                "flops_by_dtype", "bound_time"):
        assert cut[key] == pytest.approx(full[key], rel=1e-12, abs=0), key
    assert cut["dominant"] == full["dominant"]
    with pytest.raises(ValueError, match="at least 2"):
        dryrun.lower_cell(cfg, shape, GRID, False, verbose=False,
                          device="cpu", depth=1)


def test_train_arg_bytes_are_the_shards_of_the_plan():
    """A rank's arguments: its shards of the params and both moments (f32),
    the 0-d step and count (int32), its rows of tokens and labels."""
    cfg, shape, row = _cell("train")
    shapes = build(cfg).init(torch.Generator(), device="meta")
    plan = plans.make_plan(GRID, "train")
    specs = plans.param_shardings(plan, shapes)
    leaves, paths = tree.flatten_with_paths(shapes)
    params = sum(x.numel() * 4 // plan.axis_size(
        tuple(a for e in specs[p] if e for a in ((e,) if isinstance(e, str)
                                                 else e)))
                 for x, p in zip(leaves, paths))
    batch = 2 * shape.global_batch * shape.seq_len * 4 // plan.axis_size(
        plan.batch_axes)
    assert row["arg_bytes"] == 3 * params + 2 * 4 + batch
    assert row["alias_bytes"] == row["arg_bytes"]     # the donated state


def _traced(fn, *args):
    return op_cost.analyze_fn(fn, *args)


def test_sharded_matmul_flops_and_collectives_are_the_ranks():
    """x (256, 64) split over data by rows, w (64, 128) FSDP-split over data
    and TP-split over model: the local matmul, the weight's all-gather over
    data and its gradient's reduce-scatter back, each by arithmetic."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    b, d, f = 256, 64, 128
    with dryrun.fake_process_group(GRID.size):
        mesh = state.device_mesh(GRID, CPU)
        with FakeTensorMode():
            x = plans_place(torch.zeros(b, d), mesh, ("data", None))
            w = plans_place(torch.zeros(d, f), mesh, ("data", "model"))

            def matmul(x, w):
                return x @ w.redistribute(mesh, (Replicate(), Shard(1)))

            def grad_back(g):
                return g.redistribute(mesh, (Shard(0), Shard(1)))

            mm = _traced(matmul, x, w)
            g = plans_place(torch.zeros(d, f), mesh, (None, "model"))
            g = type(g).from_local(g.to_local(), mesh, (Partial(), Shard(1)),
                                   run_check=False)
            rs = _traced(grad_back, g)
    assert mm.flops == 2 * b * d * f / GRID.size
    assert mm.coll_bytes["all-gather"] == d * (f // 2) * 4
    assert mm.coll_count == 1
    assert rs.coll_bytes["reduce-scatter"] == d * (f // 2) * 4
    assert rs.coll_wire_ici == d * (f // 2) * 4 * (2 - 1) / 2


def plans_place(full, mesh, spec):
    return state.place(full, mesh, spec)


def test_model_flops_equal_the_reference():
    ref = _reference()
    from repro import configs as ref_configs

    for arch in configs.ALIASES:
        for shape in ASSIGNED_SHAPES:
            assert dryrun.model_flops(configs.get(arch), shape) == \
                ref.model_flops(ref_configs.get(arch), shape), (arch, shape)


def test_skip_reasons_and_input_specs_equal_the_reference():
    ref = _reference()
    from repro import configs as ref_configs
    from repro.models import build as ref_build

    for arch in configs.ALIASES:
        cfg, rcfg = configs.get(arch), ref_configs.get(arch)
        for shape in ASSIGNED_SHAPES:
            assert dryrun.cell_skip_reason(cfg, shape, build(cfg)) == \
                ref.cell_skip_reason(rcfg, shape, ref_build(rcfg))
            got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                   for k, v in dryrun.input_specs(cfg, shape).items()}
            want = {k: (tuple(v.shape), str(v.dtype))
                    for k, v in ref.input_specs(rcfg, shape).items()}
            assert got == want, (arch, shape.name)


def test_state_specs_equal_the_reference():
    """_generic_state_spec at the reference's cases; a KV cache's specs."""
    ref = _reference()
    from repro.sharding import plans as ref_plans

    class FakeMesh:
        def __init__(self, grid):
            self.shape, self.axis_names = grid.shape, grid.axis_names

    for multi in (False, True):
        grid = dryrun.mesh_mod.make_production_mesh(multi_pod=multi)
        pp = plans.make_plan(grid, "serve")
        rp = ref_plans.Plan(mesh=FakeMesh(grid), mode="serve")
        for shape, batch in (((6, 128, 1500, 8, 64), 128), ((128, 768), 128),
                             ((1, 4096), 1), ((12, 32, 4, 256, 256), 32),
                             ((128, 3, 4096), 128)):
            want = tuple((e,) if isinstance(e, str) else e
                         for e in ref._generic_state_spec(rp, shape, batch))
            got = tuple((e,) if isinstance(e, str) else e
                        for e in dryrun._generic_state_spec(pp, shape, batch))
            assert got == want, (shape, batch)


def test_failed_cell_is_a_row_and_the_cli_exits_1(capsys, monkeypatch):
    row = dryrun.lower_cell(configs.get_reduced("qwen3-1.7b"),
                            ShapeSpec("bogus", 32, 8, "no-such-kind"), GRID,
                            False, verbose=False, device="cpu")
    assert row["status"] == "failed" and "no-such-kind" in row["error"]
    assert dryrun.main(["--device", "cpu", "--arch", "qwen3-1.7b",
                        "--shape", "long_500k"]) == 0
    assert "0 ok, 1 skipped, 0 FAILED" in capsys.readouterr().out
    monkeypatch.setattr(dryrun, "lower_cell", lambda *a, **k: row)
    assert dryrun.main(["--device", "cpu", "--arch", "qwen3-1.7b",
                        "--shape", "train_4k"]) == 1
    assert "0 ok, 0 skipped, 1 FAILED" in capsys.readouterr().out
