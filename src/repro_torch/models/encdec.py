"""Whisper-style encoder-decoder backbone (``repro.models.encdec``), in
plain torch.

The conv/mel frontend is a stub: the caller provides frame embeddings
(B, n_frames, d). From there: sinusoidal encoder positions, bidirectional
encoder self-attention, causal decoder self-attention + cross-attention,
LayerNorm (with bias) and tanh-GELU MLPs in the whisper convention.

Decode caches the decoder self-KV (growing, written in place at the
length) and the cross-KV (fixed, computed once per layer from the encoder
output).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models.lm_types import LMConfig
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import constrain


def _ln_init(d: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def _mha_init(gen: torch.Generator, d: int, dtype, device,
              kv_bias: bool = False) -> Dict[str, Any]:
    return {
        "wq": common.dense_init(gen, d, d, dtype, device, bias=True),
        "wk": common.dense_init(gen, d, d, dtype, device, bias=kv_bias),
        "wv": common.dense_init(gen, d, d, dtype, device, bias=True),
        "wo": common.dense_init(gen, d, d, dtype, device, bias=True),
    }


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position embedding (length, channels), f32."""
    log_timescale = torch.tensor(math.log(10000.0), dtype=torch.float32,
                                 device=device) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2,
                                                  device=device))
    ang = torch.arange(length, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def init_params(gen: torch.Generator, cfg: LMConfig,
                device: DeviceLike = "cuda",
                place: Optional[common.Place] = None) -> Dict[str, Any]:
    cfg.validate()
    dev = resolve_device(device)
    dt = common.dtype_of(cfg.param_dtype)
    d = cfg.d_model

    def enc_layer():
        return {
            "ln1": _ln_init(d, dt, dev), "attn": _mha_init(gen, d, dt, dev),
            "ln2": _ln_init(d, dt, dev),
            "mlp": common.gelu_mlp_init(gen, d, cfg.d_ff, dt, dev),
        }

    def dec_layer():
        return {
            "ln1": _ln_init(d, dt, dev),
            "self_attn": _mha_init(gen, d, dt, dev),
            "ln_x": _ln_init(d, dt, dev),
            "cross_attn": _mha_init(gen, d, dt, dev),
            "ln2": _ln_init(d, dt, dev),
            "mlp": common.gelu_mlp_init(gen, d, cfg.d_ff, dt, dev),
        }

    tn = common.truncated_normal_init
    return {
        "embed": tn(gen, (cfg.vocab, d), 1.0, dt, dev),
        "pos_dec": tn(gen, (1 << 16, d), 0.01, dt, dev),
        "enc": common.stack_layers((enc_layer()
                                    for _ in range(cfg.n_enc_layers)),
                                   "enc", place),
        "dec": common.stack_layers((dec_layer()
                                    for _ in range(cfg.n_layers)),
                                   "dec", place),
        "ln_enc_post": _ln_init(d, dt, dev),
        "ln_dec_post": _ln_init(d, dt, dev),
    }


def _heads(cfg: LMConfig, t: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> (B, S, H, d // H), split over batch and heads (whole
    heads when the model axis does not divide them: ``split_heads``)."""
    return constrain(attn.split_heads(t, cfg.n_heads),
                     "batch", None, "heads", None)


def _mha(p, cfg: LMConfig, x_q, x_kv, *, causal: bool,
         kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
         q_offset: int = 0):
    b, sq, d = x_q.shape
    q = _heads(cfg, common.dense(p["wq"], x_q))
    if kv_override is None:
        k = _heads(cfg, common.dense(p["wk"], x_kv))
        v = _heads(cfg, common.dense(p["wv"], x_kv))
    else:
        k, v = kv_override
    if q_offset == 0:
        o = attn.attention(q, k, v, causal=causal)
    else:
        o = attn.full_attention(q, k, v, causal=causal, q_offset=q_offset)
    # summed whole over the model axis before it joins the residual
    # (``griffin.recurrent_block``)
    return constrain(common.dense(p["wo"], o.reshape(b, sq, d)),
                     "batch", None, None), (k, v)


def _mlp(lp, h: torch.Tensor) -> torch.Tensor:
    """A layer's MLP branch, summed whole over the model axis (``_mha``)."""
    return constrain(common.gelu_mlp(lp["mlp"], h), "batch", None, None)


def encode(params: Dict[str, Any], cfg: LMConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, n_frames, d) stub embeddings -> encoder output."""
    dt = common.dtype_of(cfg.dtype)
    x = frames.to(dt) + ctx.like(frames, sinusoids(
        frames.shape[1], cfg.d_model, frames.device).to(dt))
    x = constrain(x, "batch", None, None)

    def body(lp, x):
        h = common.layer_norm(lp["ln1"], x, cfg.rms_eps)
        x = x + _mha(lp["attn"], cfg, h, h, causal=False)[0]
        h = common.layer_norm(lp["ln2"], x, cfg.rms_eps)
        return constrain(x + _mlp(lp, h), "batch", None, None)

    for lp in common.unstack_layers(params["enc"], cfg.n_enc_layers):
        x = common.remat(cfg.remat, body, lp, x)
    return common.layer_norm(params["ln_enc_post"], x, cfg.rms_eps)


def logits_fn(params: Dict[str, Any], cfg: LMConfig):
    dt = common.dtype_of(cfg.dtype)
    # tied: the table gathered as the lookup gathers it (``transformer``)
    w = common.whole_but(params["embed"], 0).T
    return lambda h: constrain(h @ w.to(dt), "batch", None, "vocab")


def forward(params: Dict[str, Any], cfg: LMConfig, tokens: torch.Tensor,
            frames: torch.Tensor,
            return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced decode over the full target sequence. Returns
    (logits, aux)."""
    dt = common.dtype_of(cfg.dtype)
    enc_out = encode(params, cfg, frames)
    s = tokens.shape[1]
    x = common.embed(params["embed"], tokens).to(dt) \
        + params["pos_dec"][:s].to(dt)
    x = constrain(x, "batch", None, None)

    def body(lp, x, enc_out):
        h = common.layer_norm(lp["ln1"], x, cfg.rms_eps)
        x = x + _mha(lp["self_attn"], cfg, h, h, causal=True)[0]
        h = common.layer_norm(lp["ln_x"], x, cfg.rms_eps)
        x = x + _mha(lp["cross_attn"], cfg, h, enc_out, causal=False)[0]
        h = common.layer_norm(lp["ln2"], x, cfg.rms_eps)
        return constrain(x + _mlp(lp, h), "batch", None, None)

    for lp in common.unstack_layers(params["dec"], cfg.n_layers):
        x = common.remat(cfg.remat, body, lp, x, enc_out)
    x = common.layer_norm(params["ln_dec_post"], x, cfg.rms_eps)
    aux = ctx.like(x, torch.zeros((), dtype=torch.float32, device=x.device))
    if return_hidden:
        return x, aux
    return logits_fn(params, cfg)(x), aux


class EncDecCache(NamedTuple):
    self_k: torch.Tensor     # (L, B, S_max, H, hd)
    self_v: torch.Tensor
    cross_k: torch.Tensor    # (L, B, n_frames, H, hd)
    cross_v: torch.Tensor
    length: torch.Tensor     # 0-d int32


def init_cache(params: Dict[str, Any], cfg: LMConfig, batch: int,
               max_len: int,
               frames: Optional[torch.Tensor] = None) -> EncDecCache:
    """The cross-KV is computed from the encoder output once (if frames are
    given; zeros otherwise, as in the reference). With DTensor params the
    self-KV is split over the batch and the sequence (the dense family's
    roles) and the cross-KV laid out as the encoder output computes it."""
    dt = common.dtype_of(cfg.dtype)
    ref = params["embed"]
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    shape = (cfg.n_layers, batch, max_len, h, hd)
    if frames is not None:
        enc_out = encode(params, cfg, frames)
        layers = common.unstack_layers(params["dec"], cfg.n_layers)
        ck = torch.stack([_heads(cfg, common.dense(lp["cross_attn"]["wk"],
                                                   enc_out))
                          for lp in layers])
        cv = torch.stack([_heads(cfg, common.dense(lp["cross_attn"]["wv"],
                                                   enc_out))
                          for lp in layers])
    else:
        xshape = (cfg.n_layers, batch, cfg.n_audio_frames, h, hd)
        ck, cv = (ctx.zeros(ref, xshape, dt, None, "batch", None, None, None)
                  for _ in range(2))
    sk, sv = (ctx.zeros(ref, shape, dt, None, "batch", "seq", None, None)
              for _ in range(2))
    return EncDecCache(
        self_k=sk, self_v=sv, cross_k=ck, cross_v=cv,
        length=ctx.like(ref, torch.zeros((), dtype=torch.int32,
                                         device=ref.device)))


def decode_step(params: Dict[str, Any], cfg: LMConfig, tokens: torch.Tensor,
                cache: EncDecCache) -> Tuple[torch.Tensor, EncDecCache]:
    dt = common.dtype_of(cfg.dtype)
    pos_row = params["pos_dec"].index_select(0, cache.length.reshape(1).long())
    x = constrain(common.embed(params["embed"], tokens).to(dt)
                  + pos_row.to(dt), "batch", None, None)
    n_valid = cache.length + 1
    n_frames = cache.cross_k.shape[2]
    layers = common.unstack_layers(params["dec"], cfg.n_layers)
    for i, lp in enumerate(layers):
        sk, sv = cache.self_k[i], cache.self_v[i]
        hh = common.layer_norm(lp["ln1"], x, cfg.rms_eps)
        q = _heads(cfg, common.dense(lp["self_attn"]["wq"], hh))
        k = _heads(cfg, common.dense(lp["self_attn"]["wk"], hh))
        v = _heads(cfg, common.dense(lp["self_attn"]["wv"], hh))
        attn.write_position(sk, k, cache.length)
        attn.write_position(sv, v, cache.length)
        o = attn.decode_attention(q, sk, sv, n_valid)
        x = x + common.dense(lp["self_attn"]["wo"], o)
        hh = common.layer_norm(lp["ln_x"], x, cfg.rms_eps)
        q = _heads(cfg, common.dense(lp["cross_attn"]["wq"], hh))
        o = attn.decode_attention(q, cache.cross_k[i], cache.cross_v[i],
                                  n_frames)
        x = x + common.dense(lp["cross_attn"]["wo"], o)
        hh = common.layer_norm(lp["ln2"], x, cfg.rms_eps)
        x = x + _mlp(lp, hh)
    x = common.layer_norm(params["ln_dec_post"], x, cfg.rms_eps)
    logits = logits_fn(params, cfg)(x)[:, 0]
    return logits, cache._replace(length=n_valid)
