"""Shared building blocks of the LM zoo (``repro.models.common``), in torch.

Parameters are nested dicts of tensors with the reference's keys. Master
weights are float32; ``dense`` and the MLPs cast them to the activation
dtype on every call (bf16 compute against f32 masters), as the reference
does. Norms compute in float32 whatever the input dtype.

``remat`` is the reference's ``jax.checkpoint`` of a layer (``cfg.remat``):
the layer's activations are recomputed in backward instead of kept.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import ctx

Params = Dict[str, Any]
# (path of a stacked leaf, one layer's leaf) -> that layer's leaf laid out
Place = Callable[[str, torch.Tensor], torch.Tensor]

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
    device, then moved to ``device``; on ``meta`` nothing is drawn (a tree
    of shapes)."""
    shape = tuple(int(n) for n in shape)
    std = scale / max(1.0, float(shape[0]) ** 0.5) if len(shape) >= 2 \
        else scale
    t = torch.empty(shape, dtype=torch.float32,
                    device=draw_device(gen, device))
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(device=device, dtype=dtype)


def draw_device(gen: torch.Generator, device) -> torch.device:
    """Where an init draws: the generator's device, or ``meta`` when the
    params are asked for there (shapes only: the generator is not
    touched)."""
    device = torch.device(device)
    return device if device.type == "meta" else gen.device


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


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``table``. A DTensor table is looked up shard by
    shard (:func:`_embed_sharded`), never gathered whole over the vocab:
    DTensor gathers the whole vocab for ``table[ids]``, and the backward of
    its own ``F.embedding`` on a 2-D grid fails (a partial-sum gradient
    cannot be redistributed to the lookup's masked partial sum)."""
    if ctx.is_dtensor(table):
        return _embed_sharded(table, ids)
    return table[ids]


def whole_but(w: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """The DTensor ``w`` gathered over every mesh dim that does not split
    its dim ``dim`` (FSDP's all-gather of a weight before use; its backward
    reduce-scatters the gradient into ``w``'s placements); over every mesh
    dim when ``dim`` is None. A plain tensor as it is."""
    if not ctx.is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    want = [p if isinstance(p, Shard) and p.dim == dim else Replicate()
            for p in w.placements]
    return w if want == list(w.placements) else w.redistribute(
        w.device_mesh, want)


def whole_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The DTensor ``x`` gathered over the mesh dims that split its dim
    ``dim`` (its other splits kept)."""
    from torch.distributed.tensor import Replicate, Shard

    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in x.placements]
    return x if want == list(x.placements) else x.redistribute(
        x.device_mesh, want)


def _embed_sharded(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel lookup: the table is gathered over the mesh dims that
    split its columns (FSDP's all-gather), each rank reads the ids that
    fall in its own rows (zeros for the others), and the output is a
    partial sum over the mesh dims that split the vocab, split over the
    batch as ``ids`` is. The gradient of the local table is a partial sum
    over the mesh dims that split the batch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    rows = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    batch = [isinstance(p, Shard) and p.dim == 0 for p in ids.placements]
    if any(r and b for r, b in zip(rows, batch)):
        raise ValueError("a mesh dim splits both the vocab and the batch: "
                         f"{table.placements}, {ids.placements}")
    whole = whole_but(table, 0)
    local = whole.to_local(grad_placements=[
        Shard(0) if r else (Partial() if b else Replicate())
        for r, b in zip(rows, batch)])
    off, n = ctx.local_range(whole, 0)
    idx = ids.to_local().long() - off
    hit = (idx >= 0) & (idx < n)
    out = torch.where(hit[..., None], local[idx.clamp(0, n - 1)], 0)
    return DTensor.from_local(
        out, mesh, [Partial() if r else (Shard(0) if b else Replicate())
                    for r, b in zip(rows, batch)], run_check=False)


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
    freqs = ctx.like(positions,
                     rope_freqs(x.shape[-1], theta, x.device))   # (hd/2,)
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


def stack_layers(trees: Iterable[Any], path: str = "",
                 place: Optional[Place] = None) -> Any:
    """Per-layer parameter trees stacked on a new leading axis, as the
    reference's ``vmap``-ed inits lay them out. With ``place``, each
    layer's leaves are laid out as the layer is drawn from ``trees``
    (``place(path + "/" + the leaf's keys, leaf)``; a sharded init's
    ``sharding.state.layer_placer`` keeps this rank's shards), so at most
    one layer is whole at a time."""
    if place is not None:
        trees = [_place_layer(t, path, place) for t in trees]
    trees = list(trees)
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees))


def _place_layer(tree: Any, path: str, place: Place) -> Any:
    if isinstance(tree, dict):
        return {k: _place_layer(v, f"{path}/{k}", place)
                for k, v in tree.items()}
    return place(path, tree)


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
    ``fn`` for the rest, under the activation rules of the forward (the
    rules are per thread, and the backward of CUDA tensors runs on
    autograd's device thread)."""
    if enabled and torch.is_grad_enabled():
        rules = ctx.current()

        def rerun(*a):
            with ctx.activation_rules(rules):
                return fn(*a)

        return checkpoint(rerun, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)
