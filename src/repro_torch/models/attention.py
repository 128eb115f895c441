"""GQA attention (``repro.models.attention``): full, chunked (online
softmax), windowed and decode paths, in plain torch.

The chunked path builds the S x S scores one (q-chunk, kv-chunk) tile at a
time with an online-softmax accumulator, as the reference does. Masking
writes ``NEG_INF = -1e30`` (not -inf), so a fully masked row stays finite;
probabilities are cast to the activation dtype before P.V, as in the
reference, so no fused or library attention stands in for these.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple, Union

import torch

from repro_torch.models import common
from repro_torch.models.lm_types import LMConfig

NEG_INF = -1e30


def init_attn_params(gen: torch.Generator, cfg: LMConfig, dtype,
                     device) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": common.dense_init(gen, d, cfg.n_heads * hd, dtype, device,
                                bias=cfg.qkv_bias),
        "wk": common.dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device,
                                bias=cfg.qkv_bias),
        "wv": common.dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device,
                                bias=cfg.qkv_bias),
        "wo": common.dense_init(gen, cfg.n_heads * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def qkv_project(p: Dict[str, Any], cfg: LMConfig, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B, S, H, hd), k/v (B, S, Hkv, hd); RoPE applied."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = common.dense(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = common.dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = common.dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = common.rms_norm(p["q_norm"], q, cfg.rms_eps)
        k = common.rms_norm(p["k_norm"], k, cfg.rms_eps)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv*q_per_kv, hd) by repetition."""
    if q_per_kv == 1:
        return k
    return torch.repeat_interleave(k, q_per_kv, dim=2)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int = 0, softcap_val: float = 0.0,
                   q_offset: int = 0) -> torch.Tensor:
    """Materialized-scores attention (short sequences).

    q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd). window > 0 = sliding window.
    q_offset: absolute position of q[0] relative to k[0].
    """
    b, sq, h, hd = q.shape
    q_per_kv = h // k.shape[2]
    k = _expand_kv(k, q_per_kv)
    v = _expand_kv(v, q_per_kv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
    logits = common.softcap(logits, softcap_val)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = _mask(qpos, kpos, causal, window)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(b, sq, h * hd)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_chunk: int = 512, k_chunk: int = 1024,
                      window: int = 0, softcap_val: float = 0.0,
                      remat: bool = True) -> torch.Tensor:
    """Online-softmax attention; scores never exceed (q_chunk, k_chunk).

    A loop over q chunks and, inside, kv chunks. Causal runs stop at the
    diagonal's kv chunk: the reference scans the chunks above it too, where
    every score is masked, and they change nothing (their probabilities are
    exp(NEG_INF - m) = 0 and the running max stays). With ``remat`` and
    grad mode on, each q chunk runs under activation checkpointing, as in
    the reference: backward recomputes the chunk's probabilities instead of
    keeping every (q_chunk, k_chunk) tile.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    q_per_kv = h // k.shape[2]
    scale = hd ** -0.5
    nq, nk = sq // q_chunk, sk // k_chunk
    if nq * q_chunk != sq or nk * k_chunk != sk:
        raise ValueError("chunk must divide seq")
    dev = q.device

    def q_block(qi, q_tile, k, v):
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((b, q_chunk, h, hd), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        kj_end = min(nk, ((qi + 1) * q_chunk + k_chunk - 1) // k_chunk) \
            if causal else nk
        for kj in range(kj_end):
            sl = slice(kj * k_chunk, (kj + 1) * k_chunk)
            k_tile = _expand_kv(k[:, sl], q_per_kv)
            v_tile = _expand_kv(v[:, sl], q_per_kv)
            s = torch.einsum("bqhd,bkhd->bhqk", q_tile, k_tile).float() \
                * scale
            s = common.softcap(s, softcap_val)
            kpos = kj * k_chunk + torch.arange(k_chunk, device=dev)
            s = torch.where(_mask(qpos, kpos, causal, window), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
                "bhqk,bkhd->bqhd", p.to(q.dtype), v_tile).float()
            m = m_new
        out = acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
        return out.to(q.dtype)

    outs = [common.remat(remat, q_block, qi,
                         q[:, qi * q_chunk:(qi + 1) * q_chunk], k, v)
            for qi in range(nq)]
    return torch.cat(outs, dim=1).reshape(b, sq, h * hd)


class KVCache(NamedTuple):
    """Per-layer stacked KV cache. k/v: (L, B, S_max, Hkv, hd); length: a
    0-d int32 tensor on the cache's device (the number of valid
    positions)."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def init_kv_cache(cfg: LMConfig, n_layers: int, batch: int, max_len: int,
                  dtype, device) -> KVCache:
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


def write_position(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor) -> None:
    """Write ``new`` (B, 1, ...) into ``cache`` (B, S, ...) at position
    ``pos`` (a 0-d tensor on the device), in place and without a host
    sync: the counterpart of ``dynamic_update_slice_in_dim``."""
    cache.index_copy_(1, pos.reshape(1).long(), new.to(cache.dtype))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: Union[torch.Tensor, int], *, window: int = 0,
                     softcap_val: float = 0.0) -> torch.Tensor:
    """One-token attention against a KV cache, grouped by kv head (the
    cache is never repeated per q head).

    q: (B, 1, H, hd); k_cache/v_cache: (B, S, Hkv, hd); ``cache_len`` the
    number of valid positions, a 0-d tensor on the device or an int.
    """
    b, _, h, hd = q.shape
    s, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = h // n_kv
    qg = q.reshape(b, 1, n_kv, g, hd)
    logits = torch.einsum("bqngd,bsnd->bngqs", qg, k_cache).float() \
        * hd ** -0.5
    logits = common.softcap(logits, softcap_val)
    kpos = torch.arange(s, device=q.device)
    valid = kpos < cache_len                                  # (S,)
    if window > 0:
        valid &= kpos >= cache_len - window
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    out = torch.einsum("bngqs,bsnd->bqngd", p.to(q.dtype), v_cache)
    denom = p.sum(-1).movedim(-1, 1)[..., None]               # (b,q,n,g,1)
    out = out / denom.clamp_min(1e-30).to(out.dtype)
    return out.reshape(b, 1, h * hd)


def attention(q, k, v, *, causal: bool, window: int = 0,
              softcap_val: float = 0.0, chunked_threshold: int = 4096,
              q_chunk: int = 512, k_chunk: int = 1024):
    """Dispatch: chunked online-softmax for long sequences, full otherwise."""
    if q.shape[1] >= chunked_threshold and q.shape[1] % q_chunk == 0 \
            and k.shape[1] % k_chunk == 0:
        return chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                                 k_chunk=k_chunk, window=window,
                                 softcap_val=softcap_val)
    return full_attention(q, k, v, causal=causal, window=window,
                          softcap_val=softcap_val)
