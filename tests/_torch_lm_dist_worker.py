"""Gloo worker of ``tests/test_torch_lm_dist.py``: 4 CPU processes train
REDUCED qwen3-1.7b sharded on a (data, model) rank grid. Imports no JAX.

Rank 0 writes what the test compares to ``<out>/result.npz``:
  <dtype>/init_equal        the gathered sharded init equals the single
                            device's, bit for bit (1/0)
  <dtype>/placements_equal  every gradient's placements equal its param's
  <dtype>/losses            6 steps on the 2x2 grid
  restart/before, restart/after
                            steps 4-6 on (2,2) straight on, and after a
                            checkpoint at step 3 (written on (2,2) under
                            ``<out>/ckpt``) restored onto (1, 4)
  float32/losses_1x4        6 f32 steps on (1, 4), where the model axis
                            does not divide the 2 kv heads: k/v stay whole
                            on it and their gradient is a partial sum
  grads/<grid>              per leaf, max |sharded - single| / max |single|
                            of the f32 gradients of the first batch
  serve/<grid>/prefill, serve/<grid>/decode
                            max |sharded - single| of f32 logits: prefill
                            of a PROMPT-token prompt into a cache of its
                            length, then DECODE steps into a
                            sequence-split cache of MAX_LEN positions (the
                            serve plan, ``launch/dryrun.cache_shardings``)
  serve/scale               max |single-device logit| over both
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.train import init_or_restore
from repro_torch.models import build, encdec, moe, transformer
from repro_torch.sharding import ctx, plans
from repro_torch.sharding import state as sh_state
from repro_torch.train import checkpoint, optim, tree
from repro_torch.train.steps import init_train_state, make_train_step

LR = 1e-3
STEPS = 6
BATCH, SEQ = 8, 32
LOSS_CHUNK = 16
SEED = 0
DTYPES = ("bfloat16", "float32")
GRIDS = {"2x2": (2, 2), "1x4": (1, 4)}
PROMPT, MAX_LEN, DECODE = 16, 24, 4


def config(dtype: str):
    """REDUCED qwen3-1.7b in ``dtype``. The f32 run takes vocab 512 (503
    in REDUCED), which the model axis divides, so that the vocab-split
    head and loss are held too."""
    cfg = configs.get_reduced("qwen3-1.7b")
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, dtype="float32", vocab=512)
    return cfg


def batches(cfg):
    """The run's batches, numpy from a seed (the same in every process)."""
    rng = np.random.default_rng(11)
    return [{k: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(STEPS)]


def opt():
    return optim.AdamW(lr=lambda s: LR)


def _grid(shape, mode="train"):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    plan = plans.make_plan(sh_state.grid(mesh), mode)
    rules = ctx.ActivationRules(mesh=plan.mesh, batch_axes=plan.batch_axes,
                                shard_seq=mode == "serve")
    return mesh, plan, rules


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grad_errors(api, state, grid, data):
    """Per leaf, max |sharded - single| / max |single| of the gradients of
    ``data[0]``: the sharded ones gathered, the single device's from the
    same init."""
    mesh, plan, rules = grid
    step = make_train_step(api, opt(), loss_chunk=LOSS_CHUNK)
    with ctx.activation_rules(rules):
        _, _, grads = step.loss_and_grads(
            state.params, sh_state.distribute_batch(_torch(data[0]), mesh,
                                                    plan))
    got = sh_state.gather(grads)
    _, _, want = step.loss_and_grads(
        api.init(torch.Generator().manual_seed(SEED), device="cpu"),
        _torch(data[0]))
    return [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(tree.leaves(got), tree.leaves(want))]


def _serve(cfg, grid, params):
    """(prefill, decode) max |sharded - single| of f32 logits, and the
    largest single-device logit (module docstring)."""
    mesh, plan, rules = grid
    api = build(cfg)
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32))
    nxt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (DECODE, BATCH, 1)).astype(np.int32))
    specs = plans.param_shardings(plan, params)
    placed = sh_state.distribute(params, mesh, specs)
    with torch.no_grad():
        want, _ = transformer.prefill(params, cfg, prompt, PROMPT)
        with ctx.activation_rules(rules):
            got, _ = transformer.prefill(
                placed, cfg, sh_state.place(prompt, mesh, plans.batch_spec(
                    plan, BATCH, 1)), PROMPT)
        err_p = float((got.full_tensor() - want).abs().max())
        scale = float(want.abs().max())
        _, cache = transformer.prefill(params, cfg, prompt, MAX_LEN)
        leaves = tree.leaves(cache)
        cspecs = dryrun.cache_shardings(plan, cfg, cache, BATCH, MAX_LEN)
        sharded = tree.unflatten(cache, [
            sh_state.place(x, mesh, s) for x, s in zip(leaves, cspecs)])
        err_d = 0.0
        for t in nxt:
            want, cache = transformer.decode_step(params, cfg, t, cache)
            with ctx.activation_rules(rules):
                got, sharded = transformer.decode_step(
                    placed, cfg, sh_state.place(t, mesh, plans.batch_spec(
                        plan, BATCH, 1)), sharded)
            err_d = max(err_d, float((got.full_tensor() - want).abs().max()))
            scale = max(scale, float(want.abs().max()))
    return err_p, err_d, scale


def _run(api, mesh, plan, rules, state, steps, data):
    step = make_train_step(api, opt(), loss_chunk=LOSS_CHUNK, donate=True)
    losses = []
    with ctx.activation_rules(rules):
        for it in steps:
            b = sh_state.distribute_batch(
                {k: torch.from_numpy(v) for k, v in data[it].items()},
                mesh, plan)
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    return state, losses


def worker(rank: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    res = {}
    mesh, plan, rules = _grid((2, 2))
    for dtype in DTYPES:
        cfg = config(dtype)
        api, data = build(cfg), batches(cfg)
        gen = lambda: torch.Generator().manual_seed(SEED)
        state = init_train_state(api, opt(), gen(), "cpu", mesh=mesh)
        single = api.init(gen(), device="cpu")
        full = sh_state.gather(state.params)
        res[f"{dtype}/init_equal"] = all(
            torch.equal(a, b) for a, b in zip(tree.leaves(full),
                                              tree.leaves(single)))
        step = make_train_step(api, opt(), loss_chunk=LOSS_CHUNK)
        with ctx.activation_rules(rules):
            _, _, grads = step.loss_and_grads(state.params, sh_state.
                                              distribute_batch(
                {k: torch.from_numpy(v) for k, v in data[0].items()},
                mesh, plan))
        res[f"{dtype}/placements_equal"] = all(
            tuple(g.placements) == tuple(p.placements)
            for g, p in zip(tree.leaves(grads), tree.leaves(state.params)))
        if dtype == "float32":
            res["grads/2x2"] = _grad_errors(api, state, (mesh, plan, rules),
                                            data)
        _, res[f"{dtype}/losses"] = _run(api, mesh, plan, rules, state,
                                         range(STEPS), data)

    # f32 on (1, 4): 2 kv heads on a model axis of 4
    cfg = config("float32")
    api, data = build(cfg), batches(cfg)
    grid = _grid(GRIDS["1x4"])
    state = init_train_state(api, opt(), torch.Generator().manual_seed(SEED),
                             "cpu", mesh=grid[0])
    res["grads/1x4"] = _grad_errors(api, state, grid, data)
    _, res["float32/losses_1x4"] = _run(api, *grid, state, range(STEPS),
                                        data)

    # serving: sharded prefill and decode against one device, f32
    params = api.init(torch.Generator().manual_seed(SEED), device="cpu")
    scale = 0.0
    for name, shape in GRIDS.items():
        err_p, err_d, s = _serve(cfg, _grid(shape, "serve"), params)
        res[f"serve/{name}/prefill"], res[f"serve/{name}/decode"] = \
            err_p, err_d
        scale = max(scale, s)
    res["serve/scale"] = scale

    # elastic restart: a checkpoint written on (2, 2) restored on (1, 4)
    cfg = config("bfloat16")
    api, data = build(cfg), batches(cfg)
    ckpt = os.path.join(out, "ckpt")
    state = init_train_state(api, opt(), torch.Generator().manual_seed(SEED),
                             "cpu", mesh=mesh)
    state, _ = _run(api, mesh, plan, rules, state, range(3), data)
    checkpoint.save(ckpt, 3, state)
    _, res["restart/before"] = _run(api, mesh, plan, rules, state,
                                    range(3, STEPS), data)
    mesh_b, plan_b, rules_b = _grid((1, 4))
    restored, s0 = init_or_restore(api, opt(), ckpt, SEED, "cpu", mesh_b)
    assert s0 == 3
    _, res["restart/after"] = _run(api, mesh_b, plan_b, rules_b, restored,
                                   range(3, STEPS), data)
    if rank == 0:
        np.savez(os.path.join(out, "result.npz"),
                 **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()


# ------------------------------------------------- the other four families
#
# ``families`` (the workers of ``test_torch_lm_dist.py``'s ``families``
# fixture): REDUCED granite-moe-1b-a400m (drop-free), qwen2-moe-a2.7b (its
# capacity 1.25: drops, shared experts), xlstm-125m (2 heads: uneven on
# (1, 4)), recurrentgemma-9b and whisper-base, f32 with vocab 512 (the
# vocab split of the lookup, the tied heads and the loss held too), on
# both grids. Rank 0 writes ``<out>/families.npz``, per <arch>/<grid>:
#   init_equal, placements_equal   as the dense run's
#   grads        per leaf, max |sharded - single| / max |single| of the
#                first batch's gradients
#   losses       FAMILY_STEPS steps
#   prefill, decode, scale
#                max |sharded - single| of the last-position logits of a
#                PROMPT-token forward (the MoE family: ``prefill`` into a
#                sequence-split cache) and of DECODE steps (the recurrent
#                families from an empty state, whisper from the cross-KV of
#                the frames, sharded over the batch), and the largest
#                single-device logit
# and moe/out, moe/grads, moe/local, moe/dropped: ``moe_ffn`` of REDUCED
# qwen2-moe at capacity 0.5 on (1, 4) against one device (the output, every
# gradient, each rank's expert count in wi/wg/wo and its capacity buffer).

FAMILY_ARCHS = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b", "xlstm-125m",
                "recurrentgemma-9b", "whisper-base")
FAMILY_STEPS = 3
MOE_SEQ = 64


def family_config(arch: str):
    return dataclasses.replace(configs.get_reduced(arch), dtype="float32",
                               vocab=512)


def family_batches(cfg):
    rng = np.random.default_rng(13)
    out = []
    for _ in range(FAMILY_STEPS):
        b = {k: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
        if cfg.family == "encdec":
            b["frames"] = rng.normal(size=(BATCH, cfg.n_audio_frames,
                                           cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _forward_kw(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


def _family_serve(cfg, grid, params, batch):
    """(prefill, decode) max |sharded - single| and the largest logit."""
    mesh, plan, rules = grid
    api = build(cfg)
    placed = sh_state.distribute(params, mesh,
                                 plans.param_shardings(plan, params))
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32))
    nxt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (DECODE, BATCH, 1)).astype(np.int32))
    frames = batch.get("frames")
    kw = {} if frames is None else {"frames": frames}

    def rows(t):
        return sh_state.place(t, mesh, plans.batch_spec(plan, t.shape[0],
                                                        t.dim() - 1))

    # the dry run's rules: sequence-parallel prefill for the dense family
    # only, the sequence role always on in decode
    whole_seq = dataclasses.replace(rules, shard_seq=False)
    with torch.no_grad():
        if api.prefill is not None:
            want, _ = api.prefill(params, prompt, PROMPT)
            with ctx.activation_rules(whole_seq):
                got, _ = api.prefill(placed, rows(prompt), PROMPT)
            _, cache = api.prefill(params, prompt, MAX_LEN)
        else:
            want = api.forward(params, tokens=prompt, **kw)[0][:, -1]
            with ctx.activation_rules(whole_seq):
                got = api.forward(placed, tokens=rows(prompt), **{
                    k: rows(v) for k, v in kw.items()})[0][:, -1]
            if cfg.family == "encdec":
                cache = encdec.init_cache(params, cfg, BATCH, MAX_LEN, frames)
            else:
                cache = api.init_cache(params, BATCH, MAX_LEN)
        err_p = float((got.full_tensor() - want).abs().max())
        scale = float(want.abs().max())
        if cfg.family == "encdec":      # the cross-KV of sharded frames
            with ctx.activation_rules(rules):
                sharded = encdec.init_cache(placed, cfg, BATCH, MAX_LEN,
                                            rows(frames))
        else:
            cspecs = dryrun.cache_shardings(plan, cfg, cache, BATCH, MAX_LEN)
            sharded = tree.unflatten(cache, [
                sh_state.place(x, mesh, s)
                for x, s in zip(tree.leaves(cache), cspecs)])
        err_d = 0.0
        for t in nxt:
            want, cache = api.decode_step(params, t, cache)
            with ctx.activation_rules(rules):
                got, sharded = api.decode_step(placed, rows(t), sharded)
            err_d = max(err_d, float((got.full_tensor() - want).abs().max()))
            scale = max(scale, float(want.abs().max()))
    return err_p, err_d, scale


def _moe_unit(grid):
    """``moe_ffn`` of REDUCED qwen2-moe at capacity 0.5 (drops) on
    ``grid`` against one device, with a loss that weighs every output."""
    mesh, plan, rules = grid
    base = configs.get_reduced("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(base, dtype="float32", moe=dataclasses.replace(
        base.moe, capacity_factor=0.5))
    p = moe.init_moe_params(torch.Generator().manual_seed(SEED), cfg,
                            torch.float32, "cpu")
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.normal(size=(4, MOE_SEQ, cfg.d_model)).astype(
        np.float32))
    w = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))

    def run(p, x, w):
        p = tree.tree_map(lambda t: t.detach().requires_grad_(True), p)
        x = x.detach().requires_grad_(True)
        out, aux = moe.moe_ffn(p, cfg, x)
        leaves = [x] + tree.leaves(p)
        grads = torch.autograd.grad((out * w).sum() + aux, leaves)
        return out, grads, leaves

    out_w, grads_w, _ = run(p, x, w)
    specs = plans.param_shardings(plan, {"ffn": p})
    placed = sh_state.distribute({"ffn": p}, mesh, specs)["ffn"]
    spec = plans.batch_spec(plan, 4, 2)
    with ctx.activation_rules(rules):
        out, grads, leaves = run(placed, sh_state.place(x, mesh, spec),
                                 sh_state.place(w, mesh, spec))
        grads = sh_state.like_params(list(grads), leaves)
        _, _, keep, _, _ = moe.dispatch(
            moe.route(p, cfg, x)[1], moe.padded_experts(cfg),
            moe.capacity(cfg, MOE_SEQ))
    local = [placed[k].to_local().shape[0] for k in ("wi", "wg", "wo")]
    # the capacity buffer's expert dim: the rank's experts, as it runs them
    seen = []
    orig = moe.expert_ffn

    def spy(wi, *a):
        seen.append(wi.shape[0])
        return orig(wi, *a)

    moe.expert_ffn = spy
    try:
        with ctx.activation_rules(rules), torch.no_grad():
            moe.moe_ffn(placed, cfg, sh_state.place(x, mesh, spec))
    finally:
        moe.expert_ffn = orig
    scale = lambda t: float(t.abs().max())
    return {"moe/out": float((out.full_tensor() - out_w).abs().max())
            / scale(out_w),
            "moe/grads": [float((g.full_tensor() - gw).abs().max())
                          / scale(gw) for g, gw in zip(grads, grads_w)],
            "moe/local": local + seen,
            "moe/e_pad": moe.padded_experts(cfg),
            "moe/dropped": int((~keep).sum())}


def _family(arch, name, grid, res):
    mesh, plan, rules = grid
    cfg = family_config(arch)
    api, data = build(cfg), family_batches(cfg)
    gen = lambda: torch.Generator().manual_seed(SEED)
    state = init_train_state(api, opt(), gen(), "cpu", mesh=mesh)
    single = api.init(gen(), device="cpu")
    key = f"{arch}/{name}"
    res[f"{key}/init_equal"] = all(
        torch.equal(a, b) for a, b in zip(
            tree.leaves(sh_state.gather(state.params)), tree.leaves(single)))
    step = make_train_step(api, opt(), loss_chunk=LOSS_CHUNK)
    with ctx.activation_rules(rules):
        _, _, grads = step.loss_and_grads(
            state.params, sh_state.distribute_batch(_torch(data[0]), mesh,
                                                    plan))
    res[f"{key}/placements_equal"] = all(
        tuple(g.placements) == tuple(p.placements)
        for g, p in zip(tree.leaves(grads), tree.leaves(state.params)))
    _, _, want = step.loss_and_grads(single, _torch(data[0]))
    res[f"{key}/grads"] = [
        float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        for a, b in zip(tree.leaves(sh_state.gather(grads)),
                        tree.leaves(want))]
    _, res[f"{key}/losses"] = _run(api, mesh, plan, rules, state,
                                   range(FAMILY_STEPS), data)
    serve = _grid(GRIDS[name], "serve")
    (res[f"{key}/prefill"], res[f"{key}/decode"],
     res[f"{key}/scale"]) = _family_serve(cfg, serve, single,
                                          _torch(data[0]))


def families(rank: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    res = {}
    grids = {name: _grid(shape) for name, shape in GRIDS.items()}
    for arch in FAMILY_ARCHS:
        for name, grid in grids.items():
            _family(arch, name, grid, res)
    res.update(_moe_unit(grids["1x4"]))
    if rank == 0:
        np.savez(os.path.join(out, "families.npz"),
                 **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()
