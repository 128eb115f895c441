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
from repro_torch.sharding import ctx, plans, state
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


def test_constrain_reduce_scatters_a_partial_gradient():
    """A residual split over the sequence gathered whole over ``model``
    (``transformer._block_kv``'s normed input) before a model-split
    product: the gradient arrives a partial sum over ``model`` and is
    reduce-scattered straight back into the sequence split, by arithmetic;
    never all-reduced whole and then sliced (twice the bytes)."""
    b, s, d, f = 4, 32, 64, 128
    rules = ctx.ActivationRules(mesh=GRID, batch_axes=("data",),
                                shard_seq=True)
    with dryrun.fake_process_group(GRID.size):
        mesh = state.device_mesh(GRID, CPU)
        with FakeTensorMode():
            x = plans_place(torch.zeros(b, s, d), mesh,
                            ("data", "model", None))
            w = plans_place(torch.zeros(d, f), mesh, (None, "model"))

            def grad_of_x(x, w):
                x = x.detach().requires_grad_(True)
                with ctx.activation_rules(rules):
                    h = ctx.constrain(x, "batch", None, None) @ w
                return torch.autograd.grad(h, [x], torch.ones_like(h))[0]

            cost = _traced(grad_of_x, x, w)
    rows = b // 2 * s * d * 4                 # a data rank's (b/2, s, d)
    assert cost.coll_bytes["all-gather"] == rows     # the forward's
    assert cost.coll_bytes["reduce-scatter"] == rows
    assert cost.coll_bytes["all-reduce"] == 0 and cost.coll_count == 2


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


# ------------------------------------------- the MoE, ssm, hybrid, encdec

UNEVEN = RankGrid(("data", "model"), (1, 4))     # 2 heads on 4 ranks
FAMILY_CELLS = {
    "moe-train": ("granite-moe-1b-a400m", ShapeSpec("train_tiny", 32, 8,
                                                    "train"), GRID),
    "moe-prefill": ("qwen2-moe-a2.7b", ShapeSpec("prefill_tiny", 32, 8,
                                                 "prefill"), GRID),
    "moe-decode": ("qwen2-moe-a2.7b", ShapeSpec("decode_tiny", 64, 8,
                                                "decode"), UNEVEN),
    "ssm-train-uneven": ("xlstm-125m", ShapeSpec("train_tiny", 32, 8,
                                                 "train"), UNEVEN),
    "ssm-decode-uneven": ("xlstm-125m", ShapeSpec("decode_tiny", 64, 8,
                                                  "decode"), UNEVEN),
    "ssm-long": ("xlstm-125m", ShapeSpec("long_tiny", 256, 1, "decode"),
                 GRID),
    "hybrid-train": ("recurrentgemma-9b", ShapeSpec("train_tiny", 32, 8,
                                                    "train"), GRID),
    "hybrid-prefill-uneven": ("recurrentgemma-9b", ShapeSpec(
        "prefill_tiny", 32, 8, "prefill"), UNEVEN),
    "hybrid-long": ("recurrentgemma-9b", ShapeSpec("long_tiny", 256, 1,
                                                   "decode"), UNEVEN),
    "encdec-train": ("whisper-base", ShapeSpec("train_tiny", 32, 8, "train"),
                     GRID),
    "encdec-decode-uneven": ("whisper-base", ShapeSpec("decode_tiny", 64, 8,
                                                       "decode"), UNEVEN),
}


@pytest.mark.parametrize("cell", FAMILY_CELLS)
def test_family_tiny_cells_are_ok(cell):
    """A tiny cell of each family, REDUCED: on (1, 4) xlstm's and
    recurrentgemma's 2 heads (whisper's 4 in decode: its 4 heads divide)
    and qwen2-moe's experts; batch-1 long-context decode for the recurrent
    families."""
    arch, shape, grid = FAMILY_CELLS[cell]
    row = dryrun.lower_cell(configs.get_reduced(arch), shape, grid, False,
                            verbose=False, device="cpu")
    assert row["status"] == "ok", row.get("error")
    assert row["flops/chip"] > 0 and row["bytes/chip"] > 0
    assert row["mem_GiB"] > 0 and row["coll_count"] > 0
    assert sum(row["flops_by_dtype"].values()) == row["flops/chip"]


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_cut_depth_carries_every_count_for_the_hybrid_family(kind):
    """recurrentgemma's pattern (r, r, l) with its (r, r) tail, 5 periods:
    ``depth=2`` traces the tail + 2 and + 3 periods (8 and 11 layers) and
    carries them to 17, equal to the 17-layer trace in every count and the
    peak."""
    cfg = dataclasses.replace(configs.get_reduced("recurrentgemma-9b"),
                              n_layers=17)
    shape = ShapeSpec(f"{kind}_tiny", 64 if kind == "decode" else 32, 8,
                      kind)
    full = dryrun.lower_cell(cfg, shape, GRID, False, verbose=False,
                             device="cpu")
    cut = dryrun.lower_cell(cfg, shape, GRID, False, verbose=False,
                            device="cpu", depth=2)
    assert full["status"] == cut["status"] == "ok"
    assert (full["traced_layers"], cut["traced_layers"]) == ([17], [8, 11])
    for key in ("flops/chip", "bytes/chip", "coll_bytes/chip", "t_compute",
                "t_memory", "t_ici", "t_dcn", "mem_GiB", "arg_bytes",
                "temp_bytes", "alias_bytes", "coll_by_kind", "coll_count",
                "flops_by_dtype", "bound_time"):
        assert cut[key] == pytest.approx(full[key], rel=1e-12, abs=0), key


def test_expert_parallel_moe_counts_the_ranks_experts():
    """``moe_ffn`` of REDUCED granite-moe (8 experts padded to 16) on rank 0
    of (2, 2), f32, forward: the rank's FLOPs are its router product over
    its rows and the three expert products of its e_pad / 2 experts, each
    over the whole capacity buffer; its all-reduces are the combine's
    partial sum over ``model`` (its rows, f32) and the aux loss's two sums
    over ``data``."""
    from repro_torch.models import moe

    cfg = dataclasses.replace(configs.get_reduced("granite-moe-1b-a400m"),
                              dtype="float32")
    b, s = 4, 32
    e_pad, cap = moe.padded_experts(cfg), moe.capacity(cfg, s)
    d, f, e = cfg.d_model, cfg.moe.d_expert, cfg.moe.n_experts
    with dryrun.fake_process_group(GRID.size):
        mesh = state.device_mesh(GRID, CPU)
        plan = plans.make_plan(GRID, "train")
        rules = ctx.ActivationRules(mesh=GRID,
                                    batch_axes=plan.batch_axes)
        with FakeTensorMode(), ctx.activation_rules(rules):
            p = moe.init_moe_params(torch.Generator(), cfg, torch.float32,
                                    "meta")
            specs = plans.param_shardings(plan, {"ffn": p})
            p = {k: plans_place(torch.zeros(v.shape), mesh, specs[f"ffn/{k}"])
                 for k, v in p.items()}
            x = plans_place(torch.zeros(b, s, d), mesh, ("data", None, None))
            cost = _traced(lambda p, x: moe.moe_ffn(p, cfg, x), p, x)
            local = p["wi"].to_local().shape[0]
    rows = b // 2
    assert local == e_pad // 2
    experts = 3 * 2 * rows * local * cap * d * f
    assert cost.flops == 2 * rows * s * d * e + experts
    assert cost.coll_bytes["all-reduce"] == rows * s * d * 4 + 2 * e * 4
