"""AdamW with global-norm clipping and the learning-rate schedules, as plain
functions over a parameter tree of tensors (a copy of ``repro.train.optim``).

The semantics are the reference's, not ``torch.optim.AdamW``'s: clipping by
the global norm before the moments (the norm before clipping is returned),
``lr(count)`` read after ``count += 1``, ``eps`` outside the square root of
the bias-corrected second moment, weight decay added to the step (scaled by
``lr``) for leaves with two or more dimensions only, and FP32 moments. The
state is a tree like the parameters', so a checkpoint stores it leaf by leaf.

Sharded params (DTensors) are updated on their local shards: the gradients
and moments have the params' placements, so every element's arithmetic is
the single device's, and only the global norm crosses ranks (a replicated
0-d DTensor, returned as its plain local value).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.sharding.state import local
from repro_torch.train import tree


def _rewrap(like: Any, t: torch.Tensor) -> Any:
    """``t`` (a local shard) as a DTensor laid out as ``like``, when
    ``like`` is one."""
    if not hasattr(like, "device_mesh"):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False)


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor      # 0-d int32


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]     # step -> learning rate
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Any) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        dev = tree.leaves(params)[0].device
        return AdamWState(mu=tree.tree_map(zeros, params),
                          nu=tree.tree_map(zeros, params),
                          count=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any
               ) -> Tuple[Any, AdamWState, torch.Tensor]:
        """Returns (new_params, new_state, grad_norm); nothing is updated in
        place, so the old state stays valid (a checkpoint may still hold
        it)."""
        flat_p = tree.leaves(params)
        gnorm = local(global_norm(tree.leaves(grads)))
        flat_g = [local(g) for g in tree.leaves(grads)]
        g32 = [g.float() for g in flat_g]
        if self.grad_clip > 0:
            scale = torch.clamp(
                self.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            g32 = torch._foreach_mul(g32, scale)
        count = state.count + 1
        cf = count.float()
        b1c = 1.0 - torch.pow(self.b1, cf)
        b2c = 1.0 - torch.pow(self.b2, cf)
        lr = self.lr(count)

        # m = b1 m + (1-b1) g;  v = b2 v + (1-b2) g g
        m = torch._foreach_add(
            torch._foreach_mul([local(x) for x in tree.leaves(state.mu)],
                               self.b1),
            torch._foreach_mul(g32, 1 - self.b1))
        v = torch._foreach_add(
            torch._foreach_mul([local(x) for x in tree.leaves(state.nu)],
                               self.b2),
            torch._foreach_mul(torch._foreach_mul(g32, 1 - self.b2), g32))
        # step = (m / b1c) / (sqrt(v / b2c) + eps)
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(v, b2c)), self.eps)
        step = list(torch._foreach_div(torch._foreach_div(m, b1c), den))
        p32 = [local(p).float() for p in flat_p]
        if self.weight_decay > 0:
            for i, p in enumerate(p32):
                if p.dim() >= 2:
                    step[i] = step[i] + self.weight_decay * p
        new_p = [(p - lr * s).to(old.dtype)
                 for p, s, old in zip(p32, step, flat_p)]
        wrap = lambda xs: tree.unflatten(
            params, [_rewrap(old, x) for old, x in zip(flat_p, xs)])
        return (wrap(new_p), AdamWState(mu=wrap(m), nu=wrap(v), count=count),
                gnorm)

    @torch.no_grad()
    def update_(self, grads: Any, state: AdamWState, params: Any
                ) -> Tuple[Any, AdamWState, torch.Tensor]:
        """``update`` in place: the f32 params, both moments and the grads
        are overwritten, one leaf at a time, so the step holds one leaf's
        temporaries and no second copy of the state (the reference's
        buffer donation). The caller gives up the old state and grads.
        Every value is ``update``'s, bit for bit: the same operations in
        the same order."""
        flat_p = tree.leaves(params)
        if any(p.dtype != torch.float32 for p in flat_p):
            raise ValueError("update_ needs f32 params; use update")
        gnorm = local(global_norm(tree.leaves(grads)))
        scale = (torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12),
                             max=1.0) if self.grad_clip > 0 else None)
        count = state.count + 1
        cf = count.float()
        b1c = 1.0 - torch.pow(self.b1, cf)
        b2c = 1.0 - torch.pow(self.b2, cf)
        lr = self.lr(count)
        for p, g, m, v in zip(*(map(local, tree.leaves(t)) for t in
                                (params, grads, state.mu, state.nu))):
            g = g.float()
            if scale is not None:
                g.mul_(scale)
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_((g * (1 - self.b2)) * g)
            step = (m / b1c).div_(torch.sqrt(v / b2c).add_(self.eps))
            if self.weight_decay > 0 and p.dim() >= 2:
                step.add_(self.weight_decay * p)
            p.sub_(step.mul_(lr))
        return params, AdamWState(mu=state.mu, nu=state.nu,
                                  count=count), gnorm


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in FP32 (of DTensor leaves:
    a replicated 0-d DTensor)."""
    norm = torch.sqrt(sum(torch.sum(x.float() ** 2)
                          for x in tree.leaves(grads)))
    if hasattr(norm, "device_mesh"):
        from torch.distributed.tensor import Replicate

        norm = norm.redistribute(norm.device_mesh,
                                 [Replicate()] * norm.device_mesh.ndim)
    return norm


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step):
        s = step.float()
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return lr


def exp_decay_schedule(start: float, decay_steps: int,
                       decay_rate: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """DeePMD's LR protocol: lr(t) = start * rate^(t / decay_steps)."""
    def lr(step):
        return start * torch.pow(decay_rate, step.float() / decay_steps)
    return lr
