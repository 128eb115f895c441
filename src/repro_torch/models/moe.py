"""Mixture-of-experts FFN (``repro.models.moe``): top-k routing with
sort-based capacity dispatch, in plain torch.

Token-expert assignments are sorted by expert (a stable sort) and placed in
per-expert capacity buffers; an assignment past its expert's capacity is
dropped. The reference's scatter with ``mode="drop"`` becomes a gather
(slot c of an expert's buffer holds the row's c-th assignment to that
expert) and its ``.at[].add`` an ``index_add_``. The reference maps the
dispatch over the batch; here one sort runs along each row of the batch.
On DTensors the experts run expert-parallel: each rank fills and runs the
buffers of its own experts only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.lm_types import LMConfig
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import constrain


def padded_experts(cfg: LMConfig, multiple: int = 16) -> int:
    e = cfg.moe.n_experts
    return -(-e // multiple) * multiple


def capacity(cfg: LMConfig, seq: int) -> int:
    m = cfg.moe
    c = int(seq * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def init_moe_params(gen: torch.Generator, cfg: LMConfig, dtype,
                    device) -> Dict[str, Any]:
    m = cfg.moe
    d = cfg.d_model
    e_pad = padded_experts(cfg)
    tn = common.truncated_normal_init
    p = {
        "router": tn(gen, (d, m.n_experts), 1.0, torch.float32, device),
        # expert FFN weights (SwiGLU), stacked on a padded expert axis
        "wi": tn(gen, (e_pad, d, m.d_expert), 1.0, dtype, device),
        "wg": tn(gen, (e_pad, d, m.d_expert), 1.0, dtype, device),
        "wo": tn(gen, (e_pad, m.d_expert, d), 1.0, dtype, device),
    }
    if m.n_shared > 0:
        p["shared"] = common.swiglu_init(gen, d, m.n_shared * m.d_shared,
                                         dtype, device)
        p["shared_gate"] = tn(gen, (d, 1), 1.0, torch.float32, device)
    return p


def route(p: Dict[str, Any], cfg: LMConfig, x: torch.Tensor,
          router: Optional[torch.Tensor] = None,
          total: Callable[[torch.Tensor], torch.Tensor] = lambda t: t,
          n: Optional[int] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router in f32: (gates (B, S, k) renormalised, expert ids (B, S, k),
    the Switch-style load-balance aux loss over the real experts).

    On shards (``_experts_on_shards``) ``x`` is a rank's rows, ``router``
    its local copy of ``p["router"]``, ``total`` sums a per-expert sum
    over the ranks that split the rows and ``n`` is the whole batch's
    B * S, so the aux loss's means are the whole batch's."""
    m = cfg.moe
    w = p["router"] if router is None else router
    n = x.shape[0] * x.shape[1] if n is None else n
    probs = torch.softmax(x.float() @ w, dim=-1)               # (B, S, E)
    gates, ids = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    one_hot = F.one_hot(ids, m.n_experts).float().sum(-2)      # (B, S, E)
    frac = total(one_hot.sum((0, 1))) / n / m.top_k
    aux = m.n_experts * torch.sum(frac * (total(probs.sum((0, 1))) / n))
    return gates, ids, aux


def dispatch(ids: torch.Tensor, e_pad: int, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor]:
    """Sort-based dispatch metadata, one stable sort per batch row.

    ids: (B, S, k). Returns (se, rank, keep, order, tok_s), each (B, S*k):
    the assignments sorted by expert, each one's rank within its expert,
    whether it fits the capacity, the sort permutation and its token.
    """
    b, s, k = ids.shape
    t = s * k
    dev = ids.device
    e_flat = ids.reshape(b, t)
    tok = torch.arange(s, device=dev).repeat_interleave(k)     # (T,)
    se, order = torch.sort(e_flat, dim=-1, stable=True)
    tok_s = tok[order]
    experts = torch.arange(e_pad, device=dev, dtype=se.dtype)
    starts = torch.searchsorted(se, experts.expand(b, e_pad).contiguous())
    rank = torch.arange(t, device=dev) - starts.gather(1, se)
    return se, rank, rank < cap, order, tok_s


def expert_ffn(wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
               x: torch.Tensor, gates: torch.Tensor, ids: torch.Tensor,
               e0: int, e_pad: int, cap: int) -> torch.Tensor:
    """The routed experts [e0, e0 + wi.shape[0]) on plain tensors: x (B, S,
    d), gates/ids (B, S, k) -> their part of the output (B, S, d); all
    ``e_pad`` experts give the whole output.

    Each row's assignments are sorted by expert (``dispatch``); slot c of
    expert e's capacity buffer holds the row's c-th assignment to e while
    c < cap (the reference's scatter, whose later assignments drop, read
    as a gather), so a rank holds and computes only its experts' buffers.
    The combine adds each slot's output, times its gate, into its token,
    in the sorted order (the reference's ``.at[].add``)."""
    b, s, d = x.shape
    ne, k = wi.shape[0], ids.shape[-1]
    dev = x.device
    se, _, _, order, tok_s = dispatch(ids, e_pad, cap)
    edges = torch.arange(e0, e0 + ne + 1, device=dev, dtype=se.dtype)
    first = torch.searchsorted(se, edges.expand(b, ne + 1).contiguous())
    slot = torch.arange(cap, device=dev)
    valid = slot < (first[:, 1:] - first[:, :-1])[..., None]  # (B, ne, C)
    at = torch.where(valid, first[:, :-1, None] + slot, 0).reshape(b, -1)
    valid = valid.reshape(b, -1)
    tok = tok_s.gather(1, at)                                  # (B, ne*C)
    rows = torch.arange(b, device=dev)[:, None]
    buf = torch.where(valid[..., None], x[rows, tok], 0)
    buf = buf.reshape(b, ne, cap, d)
    h = torch.einsum("becd,edf->becf", buf, wi.to(x.dtype))
    g = torch.einsum("becd,edf->becf", buf, wg.to(x.dtype))
    out_buf = torch.einsum("becf,efd->becd", F.silu(h) * g,
                           wo.to(x.dtype)).reshape(b, ne * cap, d)
    w = (gates.reshape(b, s * k).gather(1, order.gather(1, at))
         * valid).to(x.dtype)
    out = torch.zeros((b * s, d), dtype=x.dtype, device=dev)
    out.index_add_(0, (rows * s + tok).reshape(-1),
                   (out_buf * w[..., None]).reshape(-1, d))
    return out.reshape(b, s, d)


def moe_ffn(p: Dict[str, Any], cfg: LMConfig,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss () float32). A DTensor
    ``x`` runs expert-parallel (:func:`_experts_on_shards`)."""
    m = cfg.moe
    e_pad = padded_experts(cfg)
    cap = capacity(cfg, x.shape[1])          # the whole sequence's
    if ctx.is_dtensor(x):
        out, aux = _experts_on_shards(p, cfg, x, e_pad, cap)
    else:
        gates, ids, aux = route(p, cfg, x)
        out = expert_ffn(p["wi"], p["wg"], p["wo"], x, gates, ids, 0, e_pad,
                         cap)
    if m.n_shared > 0:
        sg = torch.sigmoid(x.float() @ p["shared_gate"]).to(x.dtype)
        # summed whole over the model axis before the product with the
        # gate (as griffin's branches: left to DTensor, the product splits
        # it over the sequence)
        out = out + sg * constrain(common.swiglu(p["shared"], x),
                                   "batch", None, None)
    return out, aux.float()


def _experts_on_shards(p, cfg, x, e_pad, cap):
    """Expert parallelism, the reference's GSPMD layout (the capacity
    buffer's expert axis over the mesh dims that split ``wi``'s experts,
    ``model``): each rank takes its batch rows whole, routes them, fills
    the buffers of its own experts only and runs them against its experts'
    weights (gathered over the FSDP axes, never over the experts). Its
    output is a partial sum over the expert dims, summed as it is laid out
    back as the residual's rows; the gradient of its rows of ``x`` is one
    too, summed over the ranks' experts as it leaves them. (The router runs
    on the rows too: DTensor laid the partial-sum gradient of its product
    out as a strided shard, whose backward product reads a host value.)
    The aux loss's means over (batch, seq) are the whole batch's."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    x = constrain(x, "batch", None, None)
    w = [common.whole_but(p[n], 0) for n in ("wi", "wg", "wo")]
    experts = ctx.split_dims(w[0])
    rows = ctx.split_dims(x)
    if set(experts) & set(rows):
        raise ValueError(f"a mesh dim splits both the batch and the "
                         f"experts: {x.placements}, {w[0].placements}")
    mesh = x.device_mesh

    def total(t):        # the sum of t over the ranks that split the rows
        pl = [Partial() if i in rows else Replicate()
              for i in range(mesh.ndim)]
        return DTensor.from_local(t, mesh, pl, run_check=False).redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local()

    router = ctx.local_weight(common.whole_but(p["router"], None), x)
    gates, ids, aux = route(p, cfg, ctx.local(x), router, total,
                            x.shape[0] * x.shape[1])
    # every rank along the expert dims routes the same rows: the gates'
    # gradient, which each gets from its own experts, is summed over them
    gates, aux = ctx.sum_grad(gates, x, experts), ctx.like(x, aux)
    e0, _ = ctx.local_range(w[0], 0)
    out = expert_ffn(*(ctx.local(t, rows) for t in w),
                     ctx.sum_grad(ctx.local(x), x, experts), gates, ids,
                     e0, e_pad, cap)
    return constrain(ctx.wrap(out, x, experts), "batch", None, None), aux
