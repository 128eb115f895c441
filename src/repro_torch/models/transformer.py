"""Decoder-only GQA transformer, dense and MoE (``repro.models.transformer``).

Covers glm4-9b, qwen2-72b, qwen3-1.7b, granite-3-8b, llava-next-34b
(backbone; the vision frontend is a stub, embeddings arrive precomputed)
and the MoE variants granite-moe-1b-a400m / qwen2-moe-a2.7b.

Parameters keep the reference's tree: ``blocks`` stacked over layers on a
leading axis, f32 masters cast to ``cfg.dtype`` per call. The layers run
as a Python loop over views of the stacked tree (``unbind``, so backward
stacks the layers' gradients once); with ``cfg.remat`` and grad mode on,
each layer runs under activation checkpointing, as the reference's scan
body runs under ``jax.checkpoint``.

Decode keeps the cache length a 0-d tensor on the device and writes the
new position in place, so a step makes no host sync: the returned cache
holds the same k/v tensors (updated) and the length plus one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common, moe
from repro_torch.models.lm_types import LMConfig
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import constrain


def init_block_params(gen: torch.Generator, cfg: LMConfig,
                      device) -> Dict[str, Any]:
    dt = common.dtype_of(cfg.param_dtype)
    p = {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "attn": attn.init_attn_params(gen, cfg, dt, device),
        "ffn_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if cfg.family == "moe":
        p["ffn"] = moe.init_moe_params(gen, cfg, dt, device)
    else:
        p["ffn"] = common.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt, device)
    return p


def init_params(gen: torch.Generator, cfg: LMConfig,
                device: DeviceLike = "cuda",
                place: Optional[common.Place] = None) -> Dict[str, Any]:
    cfg.validate()
    dev = resolve_device(device)
    dt = common.dtype_of(cfg.param_dtype)
    tn = common.truncated_normal_init
    p = {
        "embed": tn(gen, (cfg.vocab, cfg.d_model), 1.0, dt, dev),
        "blocks": common.stack_layers(
            (init_block_params(gen, cfg, dev) for _ in range(cfg.n_layers)),
            "blocks", place),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = tn(gen, (cfg.d_model, cfg.vocab), 1.0, dt, dev)
    return p


def _ffn(cfg: LMConfig, p: Dict[str, Any],
         h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.family == "moe":
        return moe.moe_ffn(p["ffn"], cfg, h)
    return common.swiglu(p["ffn"], h), ctx.like(h, torch.zeros(
        (), dtype=torch.float32, device=h.device))


def block_apply(cfg: LMConfig, p: Dict[str, Any], x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One transformer block (training / prefill). Returns (x, moe_aux)."""
    out, _ = _block_kv(cfg, p, x, positions)
    return out


def _block_kv(cfg, p, x, positions):
    """A block that also returns its (k, v): ((x, aux), (k, v)). Under
    sequence-parallel rules the residual stream is split over the sequence;
    each norm's output is gathered whole before the projections, and each
    branch's output summed whole before it is split again: DTensor cannot
    carry a (batch, seq) split through a matmul's flattening of (B, S),
    forward or backward, as GSPMD does."""
    h = constrain(common.rms_norm(p["attn_norm"], x, cfg.rms_eps),
                  "batch", None, None)
    q, k, v = attn.qkv_project(p["attn"], cfg, h, positions)
    o = attn.attention(q, k, v, causal=True,
                       softcap_val=cfg.attn_logit_softcap)
    o = constrain(common.dense(p["attn"]["wo"], o), "batch", None, None)
    x = constrain(x + o, "batch", "seq", None)
    h = constrain(common.rms_norm(p["ffn_norm"], x, cfg.rms_eps),
                  "batch", None, None)
    f, aux = _ffn(cfg, p, h)
    f = constrain(f, "batch", None, None)
    return (constrain(x + f, "batch", "seq", None), aux), (k, v)


def _head(params: Dict[str, Any], cfg: LMConfig) -> torch.Tensor:
    head = params.get("lm_head")
    if head is None:        # tied: the embedding table, gathered as looked up
        w = common.whole_but(params["embed"], 0).T
    else:
        w = common.whole_but(head, 1)
    return w.to(common.dtype_of(cfg.dtype))


def logits_fn(params: Dict[str, Any], cfg: LMConfig):
    """(..., d) hidden -> (..., V) logits closure (tied or untied head)."""
    return lambda h: constrain(h @ _head(params, cfg), "batch", None, "vocab")


def forward(params: Dict[str, Any], cfg: LMConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B, S, V), moe_aux ()).

    Exactly one of ``tokens`` (B, S) int / ``embeds`` (B, S, d) must be
    given; ``embeds`` is the stub-frontend path (llava patch embeddings).
    With ``return_hidden`` the post-final-norm states (B, S, d) are returned
    instead of logits.
    """
    dt = common.dtype_of(cfg.dtype)
    x = (common.embed(params["embed"], tokens) if embeds is None
         else embeds).to(dt)
    x = constrain(x, "batch", "seq", None)
    b, s, _ = x.shape
    positions = ctx.like(x, torch.arange(s, device=x.device).expand(b, s),
                         "batch", None)
    aux = ctx.like(x, torch.zeros((), dtype=torch.float32, device=x.device))

    def body(p_block, x, aux):
        x, a = block_apply(cfg, p_block, x, positions)
        return x, aux + a

    for p_block in common.unstack_layers(params["blocks"], cfg.n_layers):
        x, aux = common.remat(cfg.remat, body, p_block, x, aux)
    x = common.rms_norm(params["final_norm"], x, cfg.rms_eps)
    if return_hidden:
        return x, aux
    return logits_fn(params, cfg)(x), aux


def prefill(params: Dict[str, Any], cfg: LMConfig, tokens: torch.Tensor,
            max_len: int) -> Tuple[torch.Tensor, attn.KVCache]:
    """Prefill pass: populate a KV cache of capacity ``max_len``.

    Returns (last-position logits (B, V), cache).
    """
    dt = common.dtype_of(cfg.dtype)
    b, s = tokens.shape
    x = constrain(common.embed(params["embed"], tokens).to(dt),
                  "batch", None, None)
    positions = ctx.like(x, torch.arange(s, device=x.device).expand(b, s),
                         "batch", None)
    kv_roles = (None, "batch", "seq", None, None)
    if ctx.is_dtensor(x):   # a plain cache would be whole on every rank
        shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.hd)
        cache = attn.KVCache(ctx.zeros(x, shape, dt, *kv_roles),
                             ctx.zeros(x, shape, dt, *kv_roles), None)
    else:
        cache = attn.init_kv_cache(cfg, cfg.n_layers, b, max_len, dt,
                                   x.device)
    blocks = common.unstack_layers(params["blocks"], cfg.n_layers)
    for i, p_block in enumerate(blocks):
        (x, _), (k, v) = _block_kv(cfg, p_block, x, positions)
        attn.write_prefix(cache.k[i], constrain(k, *kv_roles[1:]))
        attn.write_prefix(cache.v[i], constrain(v, *kv_roles[1:]))
    x = common.rms_norm(params["final_norm"], x[:, -1:], cfg.rms_eps)
    logits = (x @ _head(params, cfg))[:, 0]
    return logits, cache._replace(length=ctx.like(x, torch.tensor(
        s, dtype=torch.int32, device=x.device)))


def decode_step(params: Dict[str, Any], cfg: LMConfig, tokens: torch.Tensor,
                cache: attn.KVCache) -> Tuple[torch.Tensor, attn.KVCache]:
    """One decode step. tokens: (B, 1) int. Returns (logits (B, V), cache');
    the cache's k/v are written in place (see the module docstring)."""
    dt = common.dtype_of(cfg.dtype)
    b = tokens.shape[0]
    x = constrain(common.embed(params["embed"], tokens).to(dt),
                  "batch", None, None)
    pos = cache.length.expand(b, 1)
    n_valid = cache.length + 1
    blocks = common.unstack_layers(params["blocks"], cfg.n_layers)
    for i, p_block in enumerate(blocks):
        k_cache, v_cache = cache.k[i], cache.v[i]
        h = common.rms_norm(p_block["attn_norm"], x, cfg.rms_eps)
        q, k, v = attn.qkv_project(p_block["attn"], cfg, h, pos)
        attn.write_position(k_cache, k, cache.length)
        attn.write_position(v_cache, v, cache.length)
        o = attn.decode_attention(q, k_cache, v_cache, n_valid,
                                  softcap_val=cfg.attn_logit_softcap)
        x = x + common.dense(p_block["attn"]["wo"], o)
        h = common.rms_norm(p_block["ffn_norm"], x, cfg.rms_eps)
        x = x + _ffn(cfg, p_block, h)[0]
    x = common.rms_norm(params["final_norm"], x, cfg.rms_eps)
    logits = (x @ _head(params, cfg))[:, 0]
    return logits, cache._replace(length=n_valid)
