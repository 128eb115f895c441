"""LM training launcher (``repro.launch.train``): checkpointed, restartable,
on one device or sharded over ``torch.distributed`` ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --steps 300 --batch 8 --seq 128 --loss-chunk 64 \
        --ckpt-dir DIR [--device cpu]
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --model-axis 2 --arch qwen3-1.7b --reduced --steps 20 --batch 8 \
        --seq 32 --loss-chunk 16

One rank (or the CPU with ``--device cpu``): init from ``seed`` on the
device -> the train step with the state donated (in-place AdamW) -> the
token pipeline keyed by step -> ``save_async`` every ``ckpt_every`` steps
and ``save`` at the end -> a restart resumes from the latest checkpoint
under ``ckpt_dir`` (the reference's format, so either package reads what
the other wrote). The LR is the reference's cosine schedule, warmup
max(steps // 20, 5). A log row (loss, grad norm, ms/step over the steps
since the last row) is the only host sync.

Several ranks (a process group initialised by the caller, or by ``main``
under ``torch.distributed.run``: gloo on the CPU, NCCL with one card a
rank): the ranks form a ``(data, model)`` ``DeviceMesh`` with
``model_axis`` ranks on ``model``; the state is laid out by the train plan
(FSDP over ``data``, TP over ``model``) and the step runs under the plan's
activation rules. Every rank draws the same global batch from the
pipeline and keeps its rows; a restart restores onto whatever grid the
ranks form. With one rank this is the single-device loop, unchanged. The
reference's ``setup_overlap_flags`` sets XLA scheduler flags and has no
counterpart.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data.tokens import pipeline_for
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.models import build
from repro_torch.models.lm_types import LMConfig
from repro_torch.models.zoo import ModelAPI
from repro_torch.sharding import ctx as sh_ctx
from repro_torch.sharding import plans
from repro_torch.sharding import state as sh_state
from repro_torch.train import checkpoint, optim
from repro_torch.train.steps import TrainState, init_train_state, \
    make_train_step


def init_or_restore(api: ModelAPI, opt: optim.AdamW,
                    ckpt_dir: Optional[str], seed: int,
                    device: DeviceLike = "cuda", mesh=None
                    ) -> Tuple[TrainState, int]:
    """(state, its step): the latest checkpoint under ``ckpt_dir`` if there
    is one, else a fresh state from ``seed`` (drawn on ``device``). With
    ``mesh`` the state is laid out on it by the train plan."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if not ckpt_dir or checkpoint.latest_step(ckpt_dir) is None:
        return init_train_state(api, opt, gen, dev, mesh=mesh), 0
    # the layout to restore into (shapes only); moments shaped like params
    params = api.init(gen, device="meta")
    step0 = torch.zeros((), dtype=torch.int32)
    like = TrainState(params, optim.AdamWState(params, params, step0), step0)
    place = None
    if mesh is not None:
        place = sh_state.placer(mesh, sh_state.state_specs(
            sh_state.param_specs(params, mesh)))
    return checkpoint.restore(ckpt_dir, like, device=dev, place=place)


def train_loop(arch: Union[str, LMConfig], *, reduced: bool, steps: int,
               global_batch: int, seq_len: int, lr: float = 3e-4,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
               log_every: int = 10, model_axis: int = 1, seed: int = 0,
               verbose: bool = True, loss_chunk: int = 512,
               device: DeviceLike = "cuda"):
    """Train ``arch`` (a name, its REDUCED config if ``reduced``; or a
    config) to ``steps``. Returns (final state, history): a row {"loss",
    "ce", "moe_aux", "grad_norm", "step", "ms"} at the first step run and
    every ``log_every`` steps, "ms" the wall time per step since the last
    row. Under an initialised process group of more than one rank, or with
    ``model_axis`` above 1, the state is sharded over the ranks (the
    module docstring); the returned state is then of DTensors and only
    rank 0 prints."""
    dev = resolve_device(device)
    if isinstance(arch, LMConfig):
        cfg = arch
    else:
        cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    api = build(cfg)
    opt = optim.AdamW(lr=optim.cosine_schedule(lr, max(steps // 20, 5), steps))
    step_fn = make_train_step(api, opt, loss_chunk=loss_chunk, donate=True)
    pipe = pipeline_for(cfg, seq_len, global_batch, seed=seed)

    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = plan = None
    rules = contextlib.nullcontext()
    if world % model_axis:
        raise ValueError(
            f"model_axis={model_axis}: sharding needs a multiple of "
            f"{model_axis} ranks in the process group, not {world} (launch "
            "one process a rank, e.g. under torch.distributed.run)")
    if world > 1 or model_axis > 1:
        mesh = sh_state.device_mesh(sh_state.local_grid(model_axis), dev)
        plan = plans.make_plan(sh_state.grid(mesh), "train")
        rules = sh_ctx.activation_rules(sh_ctx.ActivationRules(
            mesh=plan.mesh, batch_axes=plan.batch_axes))
    verbose = verbose and (mesh is None or dist.get_rank() == 0)

    state, start_step = init_or_restore(api, opt, ckpt_dir, seed, dev, mesh)
    if verbose and start_step:
        print(f"restored checkpoint at step {start_step}", flush=True)

    pending_save = None
    history = []
    synchronize(dev)
    t_row, it_row = time.perf_counter(), start_step
    with rules:
        for it in range(start_step, steps):
            batch = pipe.batch(it, dev)
            if mesh is not None:
                batch = sh_state.distribute_batch(batch, mesh, plan)
            state, metrics = step_fn(state, batch)
            if (it + 1) % log_every == 0 or it == start_step:
                m = {k: float(v) for k, v in metrics.items()}   # syncs
                now = time.perf_counter()
                m["step"] = it + 1
                m["ms"] = (now - t_row) / (it + 1 - it_row) * 1e3
                t_row, it_row = now, it + 1
                history.append(m)
                if verbose:
                    print(f"step {it + 1:6d}  loss {m['loss']:.4f}  "
                          f"gnorm {m['grad_norm']:.3f}  {m['ms']:.0f} "
                          "ms/step", flush=True)
            if ckpt_dir and (it + 1) % ckpt_every == 0:
                if pending_save is not None:
                    pending_save.wait()
                pending_save = checkpoint.save_async(ckpt_dir, it + 1, state)
    if pending_save is not None:
        pending_save.wait()
    if ckpt_dir:
        checkpoint.save(ckpt_dir, steps, state)
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--loss-chunk", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # under torch.distributed.run: one process a rank, the group from env
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1 \
        and not dist.is_initialized()
    if launched:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        state, history = train_loop(
            args.arch, reduced=args.reduced, steps=args.steps,
            global_batch=args.batch, seq_len=args.seq, lr=args.lr,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            model_axis=args.model_axis, loss_chunk=args.loss_chunk,
            device=dev)
        rank = dist.get_rank() if dist.is_initialized() else 0
    finally:
        if launched:
            dist.destroy_process_group()
    if rank == 0:
        print(f"final loss: {history[-1]['loss']:.4f} "
              f"(from {history[0]['loss']:.4f})")
    return state, history


if __name__ == "__main__":
    main()
