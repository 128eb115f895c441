"""Multi-pod LM dry run: what one rank of the production grid needs, without
the grid — the counterpart of ``repro.launch.dryrun``.

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    python -m repro_torch.launch.dryrun --device cpu --arch qwen3-1.7b \\
        --shape train_4k --mesh both --out rows.json

The reference lowers and compiles every (arch x shape x mesh) cell over 512
placeholder devices and reads XLA's memory and cost analyses. The port
traces rank 0 of the 16 x 16 or 2 x 16 x 16 grid instead: a fake process
group of the grid's world size (``torch.testing``'s ``FakeStore``, backend
``"fake"``: collectives move no data and return at once) under
``FakeTensorMode`` (nothing is allocated), on fake CUDA tensors by default
or fake CPU tensors with ``--device cpu``. The rank holds its shards of the
state, laid out by the plan (``sharding/plans.py``) as DTensors, and runs
the cell's program under the plan's activation rules:

  train    the donated train step (``make_train_step(..., donate=True)``,
           the in-place AdamW), f32 masters, the reference's cosine LR;
  prefill  ``transformer.prefill`` into a cache of the prompt's length
           (dense/moe token models), else the forward's last logits; bf16
           params (the reference's ``dryrun.py:156-160``), serve plan;
  decode   one ``decode_step`` against a full ``seq_len`` cache, sharded
           by ``cache_shardings``; bf16 params, serve plan.

``analysis/op_cost.analyze_fn`` counts the rank's local ops and the
collectives DTensor issues for them: per-rank peak memory (arguments,
temporaries), FLOPs, bytes, collective bytes by kind. The row carries the
reference's keys (``dryrun.py:259-270``; ``t_lower_s`` is the trace's
seconds and ``t_compile_s`` 0, ``alias_bytes`` the donated state's bytes,
``out_bytes`` 0: the outputs are counted in the peak) and the
roofline's three terms against the H100 (``analysis/roofline.py``; the
compute term takes each product type's FLOPs, ``flops_by_dtype``, at its
own peak: bf16 at 989 TFLOP/s, f32 at 67), plus ``bound_time``. A cell that fails is a ``"failed"`` row with the error and
the CLI exits 1.

Where the port's rule differs from the reference's: the memory, bytes and
collective counts are an eager run's (``op_cost``'s docstring); the
reference's are XLA's after fusion and buffer assignment.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch import configs
from repro_torch.analysis import op_cost, roofline as rl
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import attention as attn_mod
from repro_torch.models import build, transformer
from repro_torch.models.lm_types import ASSIGNED_SHAPES, LMConfig, ShapeSpec
from repro_torch.models.zoo import ModelAPI
from repro_torch.sharding import ctx as sh_ctx
from repro_torch.sharding import plans as plans_mod
from repro_torch.sharding import state as sh_state
from repro_torch.train import optim, tree
from repro_torch.train.steps import TrainState, make_train_step

# --------------------------------------------------------------------- skips

def cell_skip_reason(cfg: LMConfig, shape: ShapeSpec,
                     api: ModelAPI) -> Optional[str]:
    if shape.name == "long_500k" and not api.sub_quadratic:
        return ("full-attention family: a 524288-token KV cache with full "
                "attention is outside the model family semantics "
                "(DESIGN.md §Arch-applicability)")
    if shape.kind == "decode" and not api.has_decode:
        return "encoder-only architecture: no decode step"
    return None


# ------------------------------------------------------------------- specs

def _sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in (``jax.ShapeDtypeStruct``'s counterpart):
    a tensor on the ``meta`` device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: LMConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if shape.kind == "decode":      # one new token against a seq_len cache
        return {"tokens": _sds((b, 1), torch.int32)}
    specs: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        specs["labels"] = _sds((b, s), torch.int32)
    if cfg.frontend == "vision_stub":
        specs["embeds"] = _sds((b, s, cfg.d_model), dt)
    else:
        specs["tokens"] = _sds((b, s), torch.int32)
    if cfg.family == "encdec":
        specs["frames"] = _sds((b, cfg.n_audio_frames, cfg.d_model), dt)
    return specs


def _generic_state_spec(plan, shape: Tuple[int, ...],
                        batch: int) -> plans_mod.Spec:
    """Decode-state leaf: the FIRST dim equal to the batch size shards over
    data(+pod) (caches may carry a leading layer-stack dim), then the
    largest remaining dim shards over model when divisible."""
    spec = [None] * len(shape)
    axes = plan.batch_axes
    for i, d in enumerate(shape):
        if d == batch:
            if batch % plan.axis_size(axes) == 0:
                spec[i] = axes if len(axes) > 1 else axes[0]
            elif batch % plan.axis_size("data") == 0:
                spec[i] = "data"
            break
    rest = [i for i in range(len(shape)) if spec[i] is None]
    if rest:
        big = max(rest, key=lambda i: shape[i])
        if shape[big] % plan.axis_size("model") == 0 and shape[big] > 1:
            spec[big] = "model"
    return tuple(spec)


def cache_shardings(plan, cfg: LMConfig, cache_shapes, batch: int,
                    seq: int) -> list:
    """The spec of every leaf of the decode cache, in ``tree`` order (a
    spec is a tuple, which a tree would take apart): the KV cache's k and v
    by ``kv_cache_spec``, other states by :func:`_generic_state_spec`,
    0-d leaves (the length) replicated."""
    def leaf(x):
        if len(x.shape) == 0:
            return ()
        if isinstance(cache_shapes, attn_mod.KVCache):
            return plans_mod.kv_cache_spec(plan, batch, seq, cfg.n_kv_heads)
        return _generic_state_spec(plan, tuple(x.shape), batch)

    return [leaf(x) for x in tree.leaves(cache_shapes)]


# --------------------------------------------------------------------- cells

def model_flops(cfg: LMConfig, shape: ShapeSpec) -> float:
    n = cfg.n_active_params()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    per_token = 6 * n if shape.kind == "train" else 2 * n
    return float(per_token) * tokens


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0):
    """A process group of ``world_size`` ranks in which this process is
    ``rank`` and every collective returns at once, moving no data;
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _placed(x: torch.Tensor, dmesh, spec) -> torch.Tensor:
    """A fake tensor of ``x``'s shape and dtype laid out by ``spec``."""
    return sh_state.place(torch.zeros(x.shape, dtype=x.dtype), dmesh, spec)


def _zeros(x, dmesh, spec) -> torch.Tensor:
    """Zeros shaped like ``x`` laid out by ``spec``: the rank's shard only
    is allocated (every input of a traced or timed program is zeros)."""
    return sh_ctx.zeros_placed(tuple(x.shape), x.dtype, dmesh,
                               plans_mod.placements(spec, dmesh))


def _params(api, plan, dmesh):
    """The rank's shards of the params, laid out by the plan."""
    shapes = api.init(torch.Generator(), device="meta")
    specs = plans_mod.param_shardings(plan, shapes)
    leaves, paths = tree.flatten_with_paths(shapes)
    return tree.unflatten(shapes, [_zeros(x, dmesh, specs[p])
                                   for x, p in zip(leaves, paths)])


def _batch(specs: Dict[str, torch.Tensor], plan, dmesh):
    """The rank's rows of each input, cut by ``batch_spec``."""
    return {k: _zeros(v, dmesh, plans_mod.batch_spec(plan, v.shape[0],
                                                     v.dim() - 1))
            for k, v in specs.items()}


def _train_program(api, cfg, shape, plan, dmesh, dev):
    params = _params(api, plan, dmesh)
    opt = optim.AdamW(lr=optim.cosine_schedule(3e-4, 2000, 100_000))
    state = TrainState(params=params, opt=opt.init(params),
                       step=torch.zeros((), dtype=torch.int32, device=dev))
    batch = _batch(input_specs(cfg, shape), plan, dmesh)
    return make_train_step(api, opt, donate=True), (state, batch)


def _prefill_program(api, cfg, shape, plan, dmesh, dev):
    params = _params(api, plan, dmesh)
    inputs = _batch(input_specs(cfg, shape), plan, dmesh)
    if cfg.family in ("dense", "moe") and "tokens" in inputs:
        def step(params, inputs):
            with torch.no_grad():
                return transformer.prefill(params, cfg, inputs["tokens"],
                                           shape.seq_len)
    else:
        def step(params, inputs):
            with torch.no_grad():
                logits, _ = api.forward(params, **inputs)
                return logits[:, -1]
    return step, (params, inputs)


def _decode_program(api, cfg, shape, plan, dmesh, dev):
    params = _params(api, plan, dmesh)
    b, s = shape.global_batch, shape.seq_len
    shapes = api.init_cache(api.init(torch.Generator(), device="meta"), b, s)
    specs = cache_shardings(plan, cfg, shapes, b, s)
    cache = tree.unflatten(shapes, [
        _zeros(x, dmesh, sp) for x, sp in zip(tree.leaves(shapes), specs)])
    tokens = _batch(input_specs(cfg, shape), plan, dmesh)["tokens"]

    def step(params, tokens, cache):
        with torch.no_grad():
            return api.decode_step(params, tokens, cache)
    return step, (params, tokens, cache)


_PROGRAMS = {"train": _train_program, "prefill": _prefill_program,
             "decode": _decode_program}


def lower_cell(arch: Union[str, LMConfig], shape: ShapeSpec,
               mesh: mesh_mod.RankGrid, multi_pod: bool,
               verbose: bool = True, device: DeviceLike = "cuda",
               depth: Optional[int] = None) -> Dict[str, Any]:
    """The row of one cell: rank 0's program traced (module docstring).
    ``arch`` is a zoo name or a config (a cut one, in tests). With
    ``depth``, the program is traced at ``depth`` and ``depth + 1`` layers
    (periods of the pattern, for the recurrent families) and every count
    is carried to the config's depth along the line through the two (each
    layer after the first is the same program, so FLOPs, bytes and
    collectives grow by one layer's; the peak and the arguments grow by a
    layer's weights, saved input and cache); the row's ``traced_layers``
    says so. ``depth`` is at least 2: the first layer is not like the
    others (prefill_32k's peak grows by 39.9 MB from 1 to 2 layers and by
    23.1 MB a layer after: the previous layer's k/v shards are still
    alive while a layer runs), so a line through 1 and 2 layers carries
    the peak too high. A DTensor trace costs about a second a layer."""
    if depth is not None and depth < 2:
        raise ValueError(f"depth {depth}: a cut trace needs at least 2 "
                         f"layers (the first layer is not like the others)")
    cfg = arch if isinstance(arch, LMConfig) else configs.get(arch)
    name = (f"{arch if isinstance(arch, str) else cfg.name}/{shape.name}/"
            f"{'x'.join(str(n) for n in mesh.sizes)}")
    api = build(cfg)
    reason = cell_skip_reason(cfg, shape, api)
    if reason is not None:
        return {"cell": name, "status": "skipped", "reason": reason}
    try:
        return _lower(cfg, shape, mesh, multi_pod, name, verbose,
                      resolve_device(device), depth)
    except Exception as e:       # a failed cell is a row, and the CLI exits 1
        traceback.print_exc()
        print(f"[FAIL] {name}: {type(e).__name__}: {e}", flush=True)
        return {"cell": name, "status": "failed",
                "error": f"{type(e).__name__}: {e}"}


def _setup(cfg: LMConfig, shape: ShapeSpec, mesh: mesh_mod.RankGrid):
    """(cfg, api, plan, rules) of a cell: serving cells take bf16 params
    (no optimizer state to feed), as the reference's dry run does."""
    if shape.kind != "train":
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    plan = plans_mod.make_plan(mesh, "train" if shape.kind == "train"
                               else "serve")
    # sequence-parallel residuals: dense family only; decode always enables
    # the seq role (it drives the sequence-sharded KV cache)
    shard_seq = cfg.family == "dense" or shape.kind == "decode"
    rules = sh_ctx.ActivationRules(mesh=mesh, batch_axes=plan.batch_axes,
                                   shard_seq=shard_seq)
    return cfg, build(cfg), plan, rules


def _trace(cfg, shape, mesh, multi_pod, dev):
    """(CostTotals, seconds) of rank 0's program of the cell."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, api, plan, rules = _setup(cfg, shape, mesh)
    per_pod = mesh.size // mesh.shape["pod"] if multi_pod else 0
    with fake_process_group(mesh.size):
        dmesh = sh_state.device_mesh(mesh, dev)
        with FakeTensorMode(), sh_ctx.activation_rules(rules):
            fn, args = _PROGRAMS[shape.kind](api, cfg, shape, plan, dmesh,
                                             dev)
            t0 = time.perf_counter()
            totals = op_cost.analyze_fn(fn, *args, ranks_per_pod=per_pod)
            return totals, time.perf_counter() - t0


def _extrapolate(a, b, n: float):
    """``b + n (b - a)`` of every count of two CostTotals."""
    line = lambda x, y: y + n * (y - x)
    return op_cost.CostTotals(
        flops=line(a.flops, b.flops),
        flops_by_dtype={k: line(a.flops_by_dtype.get(k, 0.0), v)
                        for k, v in b.flops_by_dtype.items()},
        bytes_accessed=line(a.bytes_accessed, b.bytes_accessed),
        coll_bytes={k: line(a.coll_bytes[k], b.coll_bytes[k])
                    for k in b.coll_bytes},
        peak_bytes=line(a.peak_bytes, b.peak_bytes),
        arg_bytes=line(a.arg_bytes, b.arg_bytes),
        coll_wire_ici=line(a.coll_wire_ici, b.coll_wire_ici),
        coll_wire_dcn=line(a.coll_wire_dcn, b.coll_wire_dcn),
        coll_count=int(round(line(a.coll_count, b.coll_count))))


def _period(cfg: LMConfig) -> int:
    """Layers of one repeat of the family's pattern: the unit a depth cut
    takes away (the hybrid family's tail, the layers past the last whole
    period, is kept)."""
    if cfg.family == "ssm":
        return len(cfg.xlstm_pattern)
    if cfg.family == "hybrid":
        return len(cfg.hybrid_pattern)
    return 1


def _lower(cfg, shape, mesh, multi_pod, name, verbose, dev, depth=None):
    step = _period(cfg)
    tail = cfg.n_layers % step
    if depth is None or tail + step * (depth + 1) >= cfg.n_layers:
        totals, seconds = _trace(cfg, shape, mesh, multi_pod, dev)
        traced = [cfg.n_layers]
    else:
        traced = [tail + step * depth, tail + step * (depth + 1)]
        cut = [dataclasses.replace(cfg, n_layers=n) for n in traced]
        seconds = 0.0
        if dev.type == "cuda":
            # the first trace of a cell's shapes in a process also counts a
            # storage that DTensor's sharding propagation makes on fake
            # CUDA tensors when it first meets an op (whisper-base
            # decode_32k: 128 MiB in its 2-layer trace, none in the 3-layer
            # one; none on fake CPU tensors), which the line through the
            # two traces would carry to full depth: a first trace warms
            # the propagation's cache
            seconds = _trace(cut[0], shape, mesh, multi_pod, dev)[1]
        (a, ta), (b, tb) = [_trace(c, shape, mesh, multi_pod, dev)
                            for c in cut]
        totals = _extrapolate(a, b, (cfg.n_layers - traced[1]) // step)
        seconds += ta + tb
    donated = totals.arg_bytes if shape.kind == "train" else 0
    hw = rl.h100() if dev.type == "cuda" else rl.HW_H100
    stats = rl.CollectiveStats(dict(totals.coll_bytes), totals.coll_wire_ici,
                               totals.coll_wire_dcn, totals.coll_count)
    report = rl.make_report(name, mesh.size, totals.flops,
                            totals.bytes_accessed, stats,
                            model_flops(cfg, shape), totals.peak_bytes, hw,
                            flops_by_dtype=totals.flops_by_dtype)
    row = report.row()
    row.update({
        "cell": name, "status": "ok",
        "t_lower_s": round(seconds, 1), "t_compile_s": 0.0,
        "arg_bytes": int(round(totals.arg_bytes)),
        "temp_bytes": int(round(totals.temp_bytes)),
        "out_bytes": 0,
        "alias_bytes": int(round(donated)),
        "coll_by_kind": {k: v for k, v in totals.coll_bytes.items() if v},
        "coll_count": int(totals.coll_count),
        "flops_by_dtype": dict(totals.flops_by_dtype),
        "bound_time": report.bound_time,
        "trace_s": seconds, "traced_layers": traced,
        "hw": hw.name, "hbm_bytes": hw.hbm_bytes,
    })
    if verbose:
        print(f"[ok] {name}: trace {seconds:.1f}s  mem/chip "
              f"{row['mem_GiB']:.2f} GiB  dominant={row['dominant']}  "
              f"t=(c {report.t_compute*1e3:.2f} | m "
              f"{report.t_memory*1e3:.2f} | coll "
              f"{report.t_collective*1e3:.2f}) ms  "
              f"useful={row['useful_ratio']:.2f}", flush=True)
    return row


def run_cell(arch: Union[str, LMConfig], shape: ShapeSpec,
             mesh: mesh_mod.RankGrid,
             device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Rank 0's program of a cell for real on ``device``, the other ranks
    stood in for by the fake process group: its collectives move no data
    and take no time, so the time is the rank's compute alone and the
    values are not the grid's. The params are zeros laid out by the plan.
    On a card, ``peak_bytes`` is the most allocated above what was
    allocated before the program's arguments were built (the trace's
    ``peak_bytes`` counts the same); the program runs twice, the second
    time for ``ms``."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    cfg = arch if isinstance(arch, LMConfig) else configs.get(arch)
    cfg, api, plan, rules = _setup(cfg, shape, mesh)
    with fake_process_group(mesh.size):
        dmesh = sh_state.device_mesh(mesh, dev)
        with sh_ctx.activation_rules(rules):
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated(dev)
            fn, args = _PROGRAMS[shape.kind](api, cfg, shape, plan, dmesh,
                                             dev)
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out = fn(*args)
            if cuda:
                torch.cuda.synchronize(dev)
            first = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated(dev) - base
                    if cuda else None)
            del out
            t0 = time.perf_counter()
            fn(*args)
            if cuda:
                torch.cuda.synchronize(dev)
            again = time.perf_counter() - t0
    return {"peak_bytes": peak, "base_bytes": base if cuda else None,
            "ms_first": first * 1e3, "ms": again * 1e3}


def _arch_ids():
    return [next(a for a, m in configs.ALIASES.items() if m == mod)
            for mod in configs.all_archs()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="arch id (repeatable); default: all 10")
    ap.add_argument("--shape", action="append", default=None,
                    help="shape name (repeatable); default: all 4")
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the fake tensors (cpu traces without a "
                         "card)")
    ap.add_argument("--depth", type=int, default=None,
                    help="trace this many layers (pattern periods, at least "
                         "2) and one more, and carry the counts to the full "
                         "depth (default: trace all)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    archs = args.arch or _arch_ids()
    shapes = [s for s in ASSIGNED_SHAPES
              if args.shape is None or s.name in args.shape]
    meshes = []
    if args.mesh in ("pod", "both"):
        meshes.append((mesh_mod.make_production_mesh(multi_pod=False), False))
    if args.mesh in ("multipod", "both"):
        meshes.append((mesh_mod.make_production_mesh(multi_pod=True), True))

    rows = []
    for mesh, multi in meshes:
        for arch in archs:
            for shape in shapes:
                rows.append(lower_cell(arch, shape, mesh, multi,
                                       device=args.device, depth=args.depth))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=str)
        print(f"wrote {args.out}")
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    failures = sum(r["status"] == "failed" for r in rows)
    print(f"cells: {n_ok} ok, {n_skip} skipped, {failures} FAILED")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
