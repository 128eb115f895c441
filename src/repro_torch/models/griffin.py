"""RecurrentGemma / Griffin (``repro.models.griffin``): RG-LRU recurrence
blocks + local attention, in plain torch.

The RG-LRU recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
runs as an inclusive scan over (a, u) pairs with the reference's combine,
(a1, u1) . (a2, u2) = (a1 a2, a2 u1 + u2): a log-depth Hillis-Steele scan
over shifted slices inside ``chunk``-sized windows, a loop carrying h
across windows (the reference's ``associative_scan`` + ``lax.scan``). Its
sums run in another order than XLA's. Decode state is O(1) per recurrent
layer plus a window-sized ring-buffer KV cache per local-attention layer.

Pattern: ``cfg.hybrid_pattern`` (default "rrl") cycled; whole periods are
stacked (``periods``) and the remainder layers get their own ``tail``
parameters: recurrentgemma-9b's 38 layers are 12 x (r,r,l) + (r,r).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models.lm_types import LMConfig
from repro_torch.sharding.ctx import constrain
from repro_torch.models.xlstm import _causal_conv1d

_RGLRU_C = 8.0


# --------------------------------------------------------------- RG-LRU core

def init_recurrent_params(gen: torch.Generator, cfg: LMConfig, dtype,
                          device) -> Dict[str, Any]:
    d = cfg.d_model
    dr = cfg.rglru_d or d
    h = cfg.n_heads
    dh = dr // h
    tn = common.truncated_normal_init
    # Lambda init so a^(1/c) ~ U[0.9, 0.999] (paper init)
    u = torch.empty((dr,), dtype=torch.float32,
                    device=common.draw_device(gen, device))
    u.uniform_(0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u)))      # softplus^-1(-log u)
    return {
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "w_y": tn(gen, (d, dr), 1.0, dtype, device),
        "w_x": tn(gen, (d, dr), 1.0, dtype, device),
        "conv_w": tn(gen, (cfg.conv_width, dr), 1.0, dtype, device),
        # block-diagonal (per-head) input & recurrence gates
        "w_rgate": tn(gen, (h, dh, dh), 1.0, dtype, device),
        "w_igate": tn(gen, (h, dh, dh), 1.0, dtype, device),
        "b_rgate": torch.zeros((dr,), dtype=dtype, device=device),
        "b_igate": torch.zeros((dr,), dtype=dtype, device=device),
        "lam": lam.to(device),
        "w_out": tn(gen, (dr, d), 1.0, dtype, device),
        "ffn_norm": torch.ones((d,), dtype=dtype, device=device),
        "ffn": common.swiglu_init(gen, d, cfg.d_ff, dtype, device),
    }


def _block_diag_gate(u: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """u: (..., dr); w: (H, dh, dh) block-diagonal. Returns sigmoid gate."""
    h, dh, _ = w.shape
    us = u.reshape(*u.shape[:-1], h, dh)
    g = torch.einsum("...hd,hde->...he", us.float(), w.float())
    return torch.sigmoid(g.reshape(u.shape) + b.float())


def _rglru_coeffs(p, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step decay a_t and driven input; u: (..., dr) conv output (f32)."""
    r = _block_diag_gate(u, p["w_rgate"], p["b_rgate"])
    i = _block_diag_gate(u, p["w_igate"], p["b_igate"])
    log_a = -_RGLRU_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably from log_a
    drive = torch.sqrt((-torch.expm1(2.0 * log_a)).clamp_min(1e-12))
    return a, drive * i * u.float()


def _scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of the combine over axis 1 (Hillis-Steele): after
    the pass with shift 2^j, position t holds the combine of
    (t - 2^(j+1), t]."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        u = torch.cat([u[:, :shift], a[:, shift:] * u[:, :-shift]
                       + u[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return u


def rglru_scan(a: torch.Tensor, u: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               chunk: int = 256) -> torch.Tensor:
    """h_t = a_t h_{t-1} + u_t over axis 1. a, u: (B, S, dr).

    Chunked as the reference is: the scan inside ``chunk``-sized windows,
    h carried across them; one window when S <= chunk or chunk does not
    divide S.
    """
    if h0 is not None:
        # fold the carry into the first step
        u = torch.cat([u[:, :1] + a[:, :1] * h0[:, None], u[:, 1:]], dim=1)
    s = a.shape[1]
    if s <= chunk or s % chunk:
        return _scan(a, u)
    hs = []
    h = torch.zeros_like(a[:, 0])
    for c0 in range(0, s, chunk):
        ac, uc = a[:, c0:c0 + chunk], u[:, c0:c0 + chunk]
        uc = torch.cat([uc[:, :1] + ac[:, :1] * h[:, None], uc[:, 1:]], dim=1)
        hc = _scan(ac, uc)
        h = hc[:, -1]
        hs.append(hc)
    return torch.cat(hs, dim=1)


def recurrent_block(p: Dict[str, Any], cfg: LMConfig, x: torch.Tensor,
                    state: Optional[Dict[str, torch.Tensor]] = None):
    """Griffin recurrent block + FFN. state = {"h": (B,dr), "conv": (B,W-1,dr)}."""
    xn = common.rms_norm(p["norm"], x, cfg.rms_eps)
    y = common.gelu(xn @ p["w_y"].to(xn.dtype))
    u = xn @ p["w_x"].to(xn.dtype)
    conv_state = None if state is None else state["conv"]
    u, conv_new = _causal_conv1d(u, p["conv_w"].to(u.dtype), conv_state)
    a, drive = _rglru_coeffs(p, u.float())
    h = rglru_scan(a, drive, None if state is None else state["h"])
    x = x + (h.to(x.dtype) * y) @ p["w_out"].to(x.dtype)
    hn = common.rms_norm(p["ffn_norm"], x, cfg.rms_eps)
    x = x + common.swiglu(p["ffn"], hn)
    return x, {"h": h[:, -1], "conv": conv_new}


# ------------------------------------------------------- local-attention block

def init_local_attn_params(gen: torch.Generator, cfg: LMConfig, dtype,
                           device) -> Dict[str, Any]:
    return {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": attn.init_attn_params(gen, cfg, dtype, device),
        "ffn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "ffn": common.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def local_attn_block(p: Dict[str, Any], cfg: LMConfig, x: torch.Tensor,
                     positions: torch.Tensor):
    h = common.rms_norm(p["attn_norm"], x, cfg.rms_eps)
    q, k, v = attn.qkv_project(p["attn"], cfg, h, positions)
    o = attn.attention(q, k, v, causal=True, window=cfg.window)
    x = x + common.dense(p["attn"]["wo"], o)
    h = common.rms_norm(p["ffn_norm"], x, cfg.rms_eps)
    return x + common.swiglu(p["ffn"], h), (k, v)


# ------------------------------------------------------------------ full model

def _pattern_split(cfg: LMConfig) -> Tuple[int, Tuple[str, ...]]:
    period = len(cfg.hybrid_pattern)
    n_periods = cfg.n_layers // period
    tail = tuple(cfg.hybrid_pattern[i] for i in range(cfg.n_layers % period))
    return n_periods, tail


def _names(kinds) -> List[str]:
    return [f"{i}_{kind}" for i, kind in enumerate(kinds)]


def _init_block(kind: str):
    return init_recurrent_params if kind == "r" else init_local_attn_params


def init_params(gen: torch.Generator, cfg: LMConfig,
                device: DeviceLike = "cuda",
                place: Optional[common.Place] = None) -> Dict[str, Any]:
    cfg.validate()
    dev = resolve_device(device)
    dt = common.dtype_of(cfg.param_dtype)
    n_periods, tail = _pattern_split(cfg)

    def init_group(kinds):
        return {name: _init_block(name[-1])(gen, cfg, dt, dev)
                for name in _names(kinds)}

    p = {
        "embed": common.truncated_normal_init(
            gen, (cfg.vocab, cfg.d_model), 1.0, dt, dev),
        "periods": common.stack_layers(
            (init_group(cfg.hybrid_pattern) for _ in range(n_periods)),
            "periods", place),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if tail:
        p["tail"] = init_group(tail)
    return p


def _groups(params: Dict[str, Any], cfg: LMConfig) -> List[Dict[str, Any]]:
    """The periods' parameter views, then the tail's blocks (if any)."""
    groups = common.unstack_layers(params["periods"], _pattern_split(cfg)[0])
    if "tail" in params:
        groups.append(params["tail"])
    return groups


def _sorted_names(group: Dict[str, Any]) -> List[str]:
    return sorted(group, key=lambda n: int(n.split("_")[0]))


def _embed(params, cfg, tokens, embeds=None):
    dt = common.dtype_of(cfg.dtype)
    x = (params["embed"][tokens] if embeds is None else embeds).to(dt)
    # times sqrt(d) rounded to the compute dtype, as the reference scales
    return constrain(x * torch.tensor(cfg.d_model ** 0.5, dtype=dt,
                                      device=x.device), "batch", "seq", None)


def logits_fn(params: Dict[str, Any], cfg: LMConfig):
    dt = common.dtype_of(cfg.dtype)
    return lambda h: constrain(common.softcap(h @ params["embed"].T.to(dt),
                                              30.0), "batch", None, "vocab")


def forward(params: Dict[str, Any], cfg: LMConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None,
            return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    x = _embed(params, cfg, tokens, embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)

    def group_apply(group, x):
        for name in _sorted_names(group):
            if name.endswith("_r"):
                x, _ = recurrent_block(group[name], cfg, x)
            else:
                x, _ = local_attn_block(group[name], cfg, x, positions)
            x = constrain(x, "batch", "seq", None)
        return x

    n_periods = _pattern_split(cfg)[0]
    for i, group in enumerate(_groups(params, cfg)):
        # the periods remat as the reference's scan body does; the tail not
        x = common.remat(cfg.remat and i < n_periods, group_apply, group, x)
    x = common.rms_norm(params["final_norm"], x, cfg.rms_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return logits_fn(params, cfg)(x), aux


class GriffinCache(NamedTuple):
    """Decode state: (a list over periods of per-block dicts, the tail's
    dict): h/conv per r-layer, a window-sized ring-buffer KV per l-layer;
    length a 0-d int32 tensor."""
    states: Any
    length: torch.Tensor


def init_cache(params: Dict[str, Any], cfg: LMConfig, batch: int,
               dtype=None) -> GriffinCache:
    dt = dtype or common.dtype_of(cfg.dtype)
    dr = cfg.rglru_d or cfg.d_model
    dev = params["embed"].device
    n_periods, tail = _pattern_split(cfg)

    def one(kind):
        if kind == "r":
            return {"h": torch.zeros((batch, dr), dtype=torch.float32,
                                     device=dev),
                    "conv": torch.zeros((batch, cfg.conv_width - 1, dr),
                                        dtype=dt, device=dev)}
        kv = (batch, cfg.window, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(kv, dtype=dt, device=dev),
                "v": torch.zeros(kv, dtype=dt, device=dev)}

    states = [{n: one(n[-1]) for n in _names(cfg.hybrid_pattern)}
              for _ in range(n_periods)]
    tail_state = {n: one(n[-1]) for n in _names(tail)}
    return GriffinCache(states=(states, tail_state),
                        length=torch.zeros((), dtype=torch.int32, device=dev))


def decode_step(params: Dict[str, Any], cfg: LMConfig, tokens: torch.Tensor,
                cache: GriffinCache) -> Tuple[torch.Tensor, GriffinCache]:
    """One decode step; the local-attention KV is a window-sized ring
    buffer, written in place at ``length % window``."""
    x = _embed(params, cfg, tokens)
    b = tokens.shape[0]
    pos = cache.length.expand(b, 1)
    slot = cache.length % cfg.window
    n_valid = torch.clamp(cache.length + 1, max=cfg.window)

    def run_block(name, bp, x, st):
        if name.endswith("_r"):
            return recurrent_block(bp, cfg, x, st)
        h = common.rms_norm(bp["attn_norm"], x, cfg.rms_eps)
        q, k, v = attn.qkv_project(bp["attn"], cfg, h, pos)
        attn.write_position(st["k"], k, slot)
        attn.write_position(st["v"], v, slot)
        o = attn.decode_attention(q, st["k"], st["v"], n_valid)
        x = x + common.dense(bp["attn"]["wo"], o)
        hh = common.rms_norm(bp["ffn_norm"], x, cfg.rms_eps)
        return x + common.swiglu(bp["ffn"], hh), {"k": st["k"], "v": st["v"]}

    period_states, tail_state = cache.states
    new_states = []
    for group, st in zip(_groups(params, cfg), list(period_states)
                         + [tail_state]):
        st_new = {}
        for name in _sorted_names(group):
            x, st_new[name] = run_block(name, group[name], x, st[name])
        new_states.append(st_new)
    new_tail = new_states.pop() if "tail" in params else {}
    x = common.rms_norm(params["final_norm"], x, cfg.rms_eps)
    logits = logits_fn(params, cfg)(x)[:, 0]
    return logits, GriffinCache(states=(new_states, new_tail),
                                length=cache.length + 1)
