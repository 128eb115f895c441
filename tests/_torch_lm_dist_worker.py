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
from repro_torch.models import build, transformer
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
