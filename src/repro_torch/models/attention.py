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
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import constrain

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
    rules = ctx.current()

    def heads(y, n):
        # a projection whose n heads the model axis does not divide stays
        # whole on it: its columns may divide (qwen3's 8 x 128 on 16 ranks)
        # but would cut heads in half
        if rules is not None and rules.axis_for("heads", n) is None:
            y = constrain(y, "batch", None, None)
        return y.reshape(b, s, n, hd)

    q = heads(common.dense(p["wq"], x), cfg.n_heads)
    k = heads(common.dense(p["wk"], x), cfg.n_kv_heads)
    v = heads(common.dense(p["wv"], x), cfg.n_kv_heads)
    if cfg.qk_norm:
        q = common.rms_norm(p["q_norm"], q, cfg.rms_eps)
        k = common.rms_norm(p["k_norm"], k, cfg.rms_eps)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    # TP over heads when they divide the model axis; otherwise attention
    # runs data-parallel over ALL mesh axes (batch_full): llava's 56 heads
    if (rules is not None and s > 1
            and rules.axis_for("heads", cfg.n_heads) is None):
        roles = ("batch_full", None, None, None)
    else:
        roles = ("batch", None, "heads", None)
    return tuple(constrain(t, *roles) for t in (q, k, v))


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
    if ctx.is_dtensor(cache):
        # DTensor's index_copy_ into a split sequence gathers the whole
        # sequence of the cache on every rank
        _write_position_sharded(cache, new, pos)
        return
    cache.index_copy_(1, pos.reshape(1).long(), new.to(cache.dtype))


def _write_position_sharded(cache, new, pos) -> None:
    """``write_position`` into a DTensor cache whose sequence may be split
    over ranks, on the local shards and still without a host sync: the
    rank that holds ``pos`` writes ``new``, every other rank rewrites one
    of its own positions with itself."""
    from torch.distributed.tensor import Replicate, Shard

    off, n = ctx.local_range(cache, 1)
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in cache.placements]
    new_l = new.redistribute(cache.device_mesh, rows).to_local()
    loc, p = cache.to_local(), pos.to_local() if ctx.is_dtensor(pos) else pos
    i = (p - off).clamp(0, max(n - 1, 0)).reshape(1).long()
    inside = (p >= off) & (p < off + n)
    loc.index_copy_(1, i, torch.where(inside, new_l.to(loc.dtype),
                                      loc.index_select(1, i)))


def write_prefix(cache: torch.Tensor, new: torch.Tensor) -> None:
    """Write ``new`` (B, s, ...) into ``cache`` (B, S, ...) at positions
    [0, s), in place. A DTensor cache is filled whole (s == S, the prompt
    as long as the cache), shard by shard: ``new`` is laid out as it."""
    s = new.shape[1]
    if not ctx.is_dtensor(cache):
        cache[:, :s] = new
        return
    # DTensor refuses a slice assignment into a split dim
    if s != cache.shape[1] or tuple(new.placements) != tuple(
            cache.placements):
        raise ValueError("a sharded cache is filled whole, by values laid "
                         f"out as it: {tuple(new.shape)} {new.placements} "
                         f"into {tuple(cache.shape)} {cache.placements}")
    cache.to_local().copy_(new.to_local())


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
    # keep the cache sequence-split; q is grouped by kv head instead
    k_cache = constrain(k_cache, "batch", "seq", None, None)
    v_cache = constrain(v_cache, "batch", "seq", None, None)
    # heads whole: the cache is split over the sequence, and DTensor cannot
    # carry a split of both batch and heads through the batched product
    q = constrain(q, "batch", None, None, None)
    qg = q.reshape(b, 1, n_kv, g, hd)
    logits = torch.einsum("bqngd,bsnd->bngqs", qg, k_cache).float() \
        * hd ** -0.5
    logits = constrain(logits, "batch", None, None, None, "seq")
    logits = common.softcap(logits, softcap_val)
    kpos = torch.arange(s, device=q.device)
    if ctx.is_dtensor(logits):      # DTensor refuses plain tensors beside it
        kpos = ctx.along(logits, -1, kpos)
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
    """Dispatch: chunked online-softmax for long sequences, full otherwise.
    DTensors (sharded over batch and heads, never over the sequence) run
    on each rank's shards: :func:`_on_shards`."""
    kw = dict(causal=causal, window=window, softcap_val=softcap_val,
              chunked_threshold=chunked_threshold, q_chunk=q_chunk,
              k_chunk=k_chunk)
    if ctx.is_dtensor(q):
        # on DTensors, the masks and the online softmax's running sums
        # would have to be DTensors too: replicated over the heads, or
        # placed op by op
        return _on_shards(q, k, v, **kw)
    if q.shape[1] >= chunked_threshold and q.shape[1] % q_chunk == 0 \
            and k.shape[1] % k_chunk == 0:
        return chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                                 k_chunk=k_chunk, window=window,
                                 softcap_val=softcap_val)
    return full_attention(q, k, v, causal=causal, window=window,
                          softcap_val=softcap_val)


def _on_shards(q, k, v, **kw):
    """``attention`` of DTensors, each rank on its own shards: attention is
    independent across batch rows and heads, so a rank whose q holds some
    rows and heads needs the k/v of those rows and of the kv heads its q
    heads read, and nothing of the other ranks. The tiles, masks and
    running sums are then plain tensors (no sharding propagation an op,
    no replicated copies). k/v replicated over the model axis while q is
    split over it (kv heads the axis does not divide) are cut to the
    rank's kv heads; their gradient is then a partial sum over that axis.
    The output (B, S, H*hd) keeps q's placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    if any(isinstance(p, Shard) and p.dim not in (0, 2)
           for t in (q, k, v) for p in t.placements):
        raise ValueError("sharded attention needs q/k/v split over batch "
                         "and heads only, not "
                         f"{q.placements}, {k.placements}, {v.placements}")
    h, n_kv = q.shape[2], k.shape[2]
    g = h // n_kv
    h0, hq = ctx.local_range(q, 2)
    k0, hk = ctx.local_range(k, 2)
    need0, need1 = h0 // g, (h0 + hq - 1) // g + 1      # kv heads q reads
    if not (k0 <= need0 and need1 <= k0 + hk and (
            (hq % g == 0 and h0 % g == 0) or need1 - need0 == 1)):
        raise ValueError(f"q heads [{h0}, {h0 + hq}) do not map onto whole "
                         f"kv heads of [{k0}, {k0 + hk}) (group {g})")
    kv_grad = [Partial() if isinstance(pk, Replicate)
               and isinstance(pq, Shard) else pk
               for pq, pk in zip(q.placements, k.placements)]
    q_l = q.to_local()
    k_l, v_l = (t.to_local(grad_placements=kv_grad)[:, :, need0 - k0:
                                                    need1 - k0]
                for t in (k, v))
    out = attention(q_l, k_l, v_l, **kw)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)
