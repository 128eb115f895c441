"""Shared building blocks of the LM zoo (``repro.models.common``), in torch.

Parameters are nested dicts of tensors with the reference's keys. Master
weights are float32; ``dense`` and the MLPs cast them to the activation
dtype on every call (bf16 compute against f32 masters), as the reference
does. Norms compute in float32 whatever the input dtype.

``remat`` is the reference's ``jax.checkpoint`` of a layer (``cfg.remat``):
the layer's activations are recomputed in backward instead of kept.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    """``cfg.dtype`` / ``cfg.param_dtype`` (a name) as a torch dtype."""
    return DTYPES[name]


def truncated_normal_init(gen: torch.Generator, shape: Sequence[int],
                          scale: float, dtype: torch.dtype,
                          device: torch.device) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], times scale / sqrt(shape[0])
    for a matrix (times scale for a vector). Drawn on the generator's
    device, then moved to ``device``."""
    shape = tuple(int(n) for n in shape)
    std = scale / max(1.0, float(shape[0]) ** 0.5) if len(shape) >= 2 \
        else scale
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               bias: bool = False) -> Params:
    p = {"w": truncated_normal_init(gen, (d_in, d_out), 1.0, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Linear layer; the weights are cast to the activation dtype (bf16
    compute against f32 master weights) unless ``dtype`` overrides both."""
    if dtype is not None:
        x = x.to(dtype)
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rms_norm(gamma: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32 whatever the input dtype."""
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * scale * gamma.float()).to(x.dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["g"].float() + p["b"].float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def swiglu_init(gen: torch.Generator, d: int, d_ff: int, dtype,
                device) -> Params:
    return {
        "wi": truncated_normal_init(gen, (d, d_ff), 1.0, dtype, device),
        "wg": truncated_normal_init(gen, (d, d_ff), 1.0, dtype, device),
        "wo": truncated_normal_init(gen, (d_ff, d), 1.0, dtype, device),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["wi"].to(x.dtype)) * (x @ p["wg"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype,
                  device) -> Params:
    return {
        "wi": truncated_normal_init(gen, (d, d_ff), 1.0, dtype, device),
        "bi": torch.zeros((d_ff,), dtype=dtype, device=device),
        "wo": truncated_normal_init(gen, (d_ff, d), 1.0, dtype, device),
        "bo": torch.zeros((d,), dtype=dtype, device=device),
    }


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = gelu(x @ p["wi"].to(x.dtype) + p["bi"].to(x.dtype))
    return h @ p["wo"].to(x.dtype) + p["bo"].to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding on split halves (not interleaved).
    x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (hd/2,)
    ang = positions[..., None].float() * freqs                  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def stack_layers(trees: Sequence[Any]) -> Any:
    """Per-layer parameter trees stacked on a new leading axis, as the
    reference's ``vmap``-ed inits lay them out."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees))


def unstack_layers(tree: Any, n: int) -> list:
    """The ``n`` per-layer views of a tree stacked on its leading axis."""
    if isinstance(tree, dict):
        parts = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def remat(enabled: bool, fn: Callable[..., Any], *args: Any) -> Any:
    """``fn(*args)``, under activation checkpointing when ``enabled`` (a
    model's ``cfg.remat``) and grad mode is on (never while serving under
    ``inference_mode``): only ``args`` are kept for backward, which reruns
    ``fn`` for the rest."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)
