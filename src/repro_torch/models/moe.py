"""Mixture-of-experts FFN (``repro.models.moe``): top-k routing with
sort-based capacity dispatch, in plain torch.

Token-expert assignments are sorted by expert (a stable sort) and written
into per-expert capacity buffers; an assignment past its expert's capacity
is dropped. The reference's out-of-range ``.at[].set(mode="drop")`` becomes
a write into a buffer one slot longer than the capacity, whose last slot is
cut off, and its ``.at[].add`` an ``index_add_``. The reference maps the
dispatch over the batch; here one sort runs along each row of the batch.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.lm_types import LMConfig


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


def route(p: Dict[str, Any], cfg: LMConfig, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router in f32: (gates (B, S, k) renormalised, expert ids (B, S, k),
    the Switch-style load-balance aux loss over the real experts)."""
    m = cfg.moe
    probs = torch.softmax(x.float() @ p["router"], dim=-1)     # (B, S, E)
    gates, ids = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    one_hot = F.one_hot(ids, m.n_experts).float().sum(-2)      # (B, S, E)
    frac = one_hot.mean((0, 1)) / m.top_k
    aux = m.n_experts * torch.sum(frac * probs.mean((0, 1)))
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


def moe_ffn(p: Dict[str, Any], cfg: LMConfig,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss () float32)."""
    m = cfg.moe
    b, s, d = x.shape
    e_pad = padded_experts(cfg)
    cap = capacity(cfg, s)
    gates, ids, aux = route(p, cfg, x)
    se, rank, keep, order, tok_s = dispatch(ids, e_pad, cap)
    t = se.shape[1]
    rows = torch.arange(b, device=x.device)[:, None].expand(b, t)

    src = x[rows, tok_s] * keep[..., None].to(x.dtype)         # (B, T, d)
    buf = torch.zeros((b, e_pad, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[rows, se, torch.where(keep, rank, cap)] = src          # slot cap: drops
    buf = buf[:, :, :cap]
    h = torch.einsum("becd,edf->becf", buf, p["wi"].to(x.dtype))
    g = torch.einsum("becd,edf->becf", buf, p["wg"].to(x.dtype))
    out_buf = torch.einsum("becf,efd->becd", F.silu(h) * g,
                           p["wo"].to(x.dtype))
    contrib = out_buf[rows, se, torch.where(keep, rank, 0)]     # (B, T, d)
    w = (gates.reshape(b, t).gather(1, order) * keep).to(x.dtype)
    out = torch.zeros((b * s, d), dtype=x.dtype, device=x.device)
    out.index_add_(0, (rows * s + tok_s).reshape(-1),
                   (contrib * w[..., None]).reshape(b * t, d))
    out = out.reshape(b, s, d)

    if m.n_shared > 0:
        sg = torch.sigmoid(x.float() @ p["shared_gate"]).to(x.dtype)
        out = out + sg * common.swiglu(p["shared"], x)
    return out, aux.float()
