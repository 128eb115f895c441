"""xLSTM (``repro.models.xlstm``): mLSTM (matrix memory) + sLSTM (scalar
memory) blocks, in plain torch.

mLSTM runs in the chunkwise-parallel form: within a chunk the recurrence
is a masked attention-like contraction with cumulative log-gate decays
(every exponent <= 0 by the running stabilizer), across chunks the (dk, dv)
matrix state is carried by a loop. sLSTM is a sequential scalar-memory
recurrence, a loop over time. The stabilizers start at the sentinel -1e30,
and a sequence is padded to a chunk multiple with log_i = -1e30, which
makes the padded steps' state update vanish exactly.

Layer pattern: ``cfg.xlstm_pattern`` cycled over n_layers; the parameters
are stacked over pattern periods (``periods``), as in the reference, and
with ``cfg.remat`` each period runs under activation checkpointing.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common
from repro_torch.models.lm_types import LMConfig

NEG_INF = -1e30


# ---------------------------------------------------------------- mLSTM cell

def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, S, D); w: (W, D). Returns (y, new_state).

    state: (B, W-1, D) trailing inputs of the previous segment (decode).
    """
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # (B, S+W-1, D)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(width))
    return y, xp[:, -(width - 1):]


def init_mlstm_params(gen: torch.Generator, cfg: LMConfig, dtype,
                      device) -> Dict[str, Any]:
    d = cfg.d_model
    di = 2 * d                     # pf=2 inner width
    h = cfg.n_heads
    tn = common.truncated_normal_init
    return {
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "w_up": tn(gen, (d, 2 * di), 1.0, dtype, device),
        "conv_w": tn(gen, (cfg.conv_width, di), 1.0, dtype, device),
        "w_q": tn(gen, (di, di), 1.0, dtype, device),
        "w_k": tn(gen, (di, di), 1.0, dtype, device),
        "w_v": tn(gen, (di, di), 1.0, dtype, device),
        "w_i": tn(gen, (di, h), 1.0, dtype, device),
        "w_f": tn(gen, (di, h), 1.0, dtype, device),
        "b_i": torch.zeros((h,), dtype=dtype, device=device),
        # forget bias > 0: start remembering (standard LSTM trick)
        "b_f": torch.full((h,), 3.0, dtype=dtype, device=device),
        "gn": torch.ones((di,), dtype=dtype, device=device),
        "w_down": tn(gen, (di, d), 1.0, dtype, device),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor        # (B, H, dk, dv) stabilized matrix memory
    n: torch.Tensor        # (B, H, dk)
    m: torch.Tensor        # (B, H) absolute stabilizer
    conv: torch.Tensor     # (B, W-1, di) conv tail


def _mlstm_chunk(q, k, v, log_i, log_f, state):
    """One chunk of the stabilized chunkwise mLSTM recurrence.

    q,k,v: (B, H, L, dh) f32; log_i/log_f: (B, H, L) f32.
    state: (c (B,H,dk,dv), n (B,H,dk), m (B,H)).
    Returns (h (B,H,L,dh), new_state).
    """
    l_, dh = q.shape[2], q.shape[3]
    c_prev, n_prev, m_prev = state
    scale = dh ** -0.5
    b_cum = torch.cumsum(log_f, dim=-1)                 # b_i, inclusive
    a_cum = torch.cummax(log_i - b_cum, dim=2).values   # max_j<=i (g_j - b_j)
    mloc = torch.maximum(m_prev[..., None], a_cum)      # (B,H,L)

    # Intra-chunk: D_ij = exp(g_j - b_j - mloc_i) for j<=i.
    expo = (log_i - b_cum)[..., None, :] - mloc[..., :, None]
    causal = torch.ones((l_, l_), dtype=torch.bool, device=q.device).tril()
    # masked before the exp: above the diagonal expo can overflow to inf
    # (strongly negative forget gates), and exp's backward would give
    # 0 x inf = NaN there; exp(NEG_INF) = 0 keeps the forward's values
    dmat = torch.exp(torch.where(causal, expo, NEG_INF))
    sw = (q @ k.transpose(-1, -2)) * scale * dmat
    h_intra = sw @ v                                    # (B,H,L,dv)
    qn_intra = sw.sum(-1)                               # (B,H,L)

    # Inter-chunk: carry-in state contribution.
    inter_scale = torch.exp(m_prev[..., None] - mloc)   # (B,H,L)
    h_inter = (q @ c_prev) * inter_scale[..., None] * scale
    qn_inter = torch.einsum("bhld,bhd->bhl", q, n_prev) * inter_scale * scale

    m_abs = b_cum + mloc                                # absolute stabilizer
    denom = torch.maximum((qn_intra + qn_inter).abs(), torch.exp(-m_abs))
    h_out = (h_intra + h_inter) / denom[..., None]

    # State update for the next chunk.
    mloc_l = mloc[..., -1]
    kv_scale = torch.exp(log_i - b_cum - mloc_l[..., None])   # (B,H,L), <= 1
    decay = torch.exp(m_prev - mloc_l)
    ks = k * kv_scale[..., None]
    c_new = decay[..., None, None] * c_prev + ks.transpose(-1, -2) @ v
    n_new = decay[..., None] * n_prev + ks.sum(2)
    m_new = b_cum[..., -1] + mloc_l
    return h_out, (c_new, n_new, m_new)


def mlstm_sequence(q, k, v, log_i, log_f, state, chunk: int):
    """Chunkwise loop. q,k,v: (B, H, S, dh); returns (h, final_state)."""
    s_ = q.shape[2]
    if s_ % chunk:
        raise ValueError("the chunk must divide the sequence")
    hs = []
    for c0 in range(0, s_, chunk):
        sl = slice(c0, c0 + chunk)
        h_out, state = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                    log_i[..., sl], log_f[..., sl], state)
        hs.append(h_out)
    return torch.cat(hs, dim=2), state


def mlstm_block(p: Dict[str, Any], cfg: LMConfig, x: torch.Tensor,
                state: Optional[MLSTMState] = None
                ) -> Tuple[torch.Tensor, MLSTMState]:
    """x: (B, S, d). state given => recurrent path (decode)."""
    b, s, d = x.shape
    n_heads = cfg.n_heads
    di = 2 * d
    dh = di // n_heads
    f32 = torch.float32
    xn = common.rms_norm(p["norm"], x, cfg.rms_eps)
    x_in, z = (xn @ p["w_up"].to(xn.dtype)).chunk(2, dim=-1)  # (B,S,di)
    conv_state = None if state is None else state.conv
    x_c, conv_new = _causal_conv1d(x_in, p["conv_w"].to(x_in.dtype),
                                   conv_state)
    x_c = F.silu(x_c)

    def heads(t):
        return t.reshape(b, s, n_heads, dh).transpose(1, 2).to(f32)

    q = heads(x_c @ p["w_q"].to(x_c.dtype))
    k = heads(x_c @ p["w_k"].to(x_c.dtype))
    v = heads(x_in @ p["w_v"].to(x_in.dtype))
    # bf16 products plus the f32 biases: f32, as in the reference
    log_i = (x_c @ p["w_i"].to(x_c.dtype) + p["b_i"]).to(f32)
    log_f = F.logsigmoid((x_c @ p["w_f"].to(x_c.dtype) + p["b_f"]).to(f32))
    log_i = log_i.transpose(1, 2)                       # (B,H,S)
    log_f = log_f.transpose(1, 2)

    if state is None:
        dev = x.device
        cell = (torch.zeros((b, n_heads, dh, dh), dtype=f32, device=dev),
                torch.zeros((b, n_heads, dh), dtype=f32, device=dev),
                torch.full((b, n_heads), NEG_INF, dtype=f32, device=dev))
        chunk = min(cfg.xlstm_chunk, s)
        pad = (-s) % chunk
        if pad:
            # pad to a chunk multiple; log_i = -1e30 on the padding makes
            # the padded steps state-neutral (their kv updates vanish)
            q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
            log_i = F.pad(log_i, (0, pad), value=NEG_INF)
            log_f = F.pad(log_f, (0, pad))
        h_out, cell = mlstm_sequence(q, k, v, log_i, log_f, cell, chunk)
        h_out = h_out[:, :, :s]
    else:
        h_out, cell = _mlstm_chunk(q, k, v, log_i, log_f,
                                   (state.c, state.n, state.m))

    h_flat = h_out.transpose(1, 2).reshape(b, s, di).to(x.dtype)
    h_flat = common.rms_norm(p["gn"], h_flat, cfg.rms_eps)  # group-norm stand-in
    out = (h_flat * F.silu(z)) @ p["w_down"].to(x.dtype)
    return x + out, MLSTMState(c=cell[0], n=cell[1], m=cell[2], conv=conv_new)


# ---------------------------------------------------------------- sLSTM cell

def init_slstm_params(gen: torch.Generator, cfg: LMConfig, dtype,
                      device) -> Dict[str, Any]:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    d_up = int(d * 4 / 3) // 8 * 8
    tn = common.truncated_normal_init
    return {
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "w_zifo": tn(gen, (d, 4 * d), 1.0, dtype, device),
        # block-diagonal per-head recurrent matrices, one per gate
        "r_zifo": tn(gen, (4, h, dh, dh), 1.0, dtype, device),
        "b_zifo": torch.zeros((4 * d,), dtype=dtype, device=device),
        "gn": torch.ones((d,), dtype=dtype, device=device),
        "up1": tn(gen, (d, d_up), 1.0, dtype, device),
        "up2": tn(gen, (d, d_up), 1.0, dtype, device),
        "down": tn(gen, (d_up, d), 1.0, dtype, device),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor    # (B, d)
    n: torch.Tensor    # (B, d)
    h: torch.Tensor    # (B, d)
    m: torch.Tensor    # (B, d)


def _slstm_step(r: torch.Tensor, cfg: LMConfig, wx_t: torch.Tensor,
                st: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    """One timestep. r: the f32 recurrent matrices (4, H, dh, dh);
    wx_t: (B, 4d) precomputed input projections."""
    b = wx_t.shape[0]
    d = cfg.d_model
    h_prev = st.h.reshape(b, cfg.n_heads, d // cfg.n_heads).float()
    rec = torch.einsum("bhd,ghde->gbhe", h_prev, r).reshape(4, b, d)
    pre = wx_t.float().reshape(b, 4, d).transpose(0, 1) + rec
    z = torch.tanh(pre[0])
    i_t, f_t = pre[1], pre[2]
    o = torch.sigmoid(pre[3])
    m_new = torch.maximum(f_t + st.m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + st.m - m_new)
    c_new = f_p * st.c + i_p * z
    n_new = f_p * st.n + i_p
    h_new = o * c_new / n_new.clamp_min(1e-6)
    return h_new, SLSTMState(c=c_new, n=n_new, h=h_new, m=m_new)


def init_slstm_state(batch: int, d: int, device) -> SLSTMState:
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z.clone(), h=z.clone(),
                      m=torch.full((batch, d), NEG_INF, dtype=torch.float32,
                                   device=device))


def slstm_block(p: Dict[str, Any], cfg: LMConfig, x: torch.Tensor,
                state: Optional[SLSTMState] = None
                ) -> Tuple[torch.Tensor, SLSTMState]:
    b, s, d = x.shape
    xn = common.rms_norm(p["norm"], x, cfg.rms_eps)
    wx = xn @ p["w_zifo"].to(xn.dtype) + p["b_zifo"].to(xn.dtype)  # (B,S,4d)
    if state is None:
        state = init_slstm_state(b, d, x.device)
    r = p["r_zifo"].float()
    hs = []
    for t in range(s):
        h_new, state = _slstm_step(r, cfg, wx[:, t], state)
        hs.append(h_new)
    h_seq = torch.stack(hs, dim=1).to(x.dtype)           # (B,S,d)
    h_seq = common.rms_norm(p["gn"], h_seq, cfg.rms_eps)
    up = common.gelu(h_seq @ p["up1"].to(x.dtype)) * (
        h_seq @ p["up2"].to(x.dtype))
    return x + up @ p["down"].to(x.dtype), state


# ------------------------------------------------------------- full LM model

def _n_periods(cfg: LMConfig) -> int:
    period = len(cfg.xlstm_pattern)
    if cfg.n_layers % period:
        raise ValueError("n_layers must tile the pattern")
    return cfg.n_layers // period


def _names(cfg: LMConfig) -> List[str]:
    return [f"{i}_{kind}" for i, kind in enumerate(cfg.xlstm_pattern)]


def init_params(gen: torch.Generator, cfg: LMConfig,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    cfg.validate()
    dev = resolve_device(device)
    dt = common.dtype_of(cfg.param_dtype)

    def init_period():
        return {f"{i}_{kind}": (init_mlstm_params if kind == "m"
                                else init_slstm_params)(gen, cfg, dt, dev)
                for i, kind in enumerate(cfg.xlstm_pattern)}

    tn = common.truncated_normal_init
    return {
        "embed": tn(gen, (cfg.vocab, cfg.d_model), 1.0, dt, dev),
        "periods": common.stack_layers([init_period()
                                        for _ in range(_n_periods(cfg))]),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": tn(gen, (cfg.d_model, cfg.vocab), 1.0, dt, dev),
    }


def _block(name: str):
    return mlstm_block if name.endswith("_m") else slstm_block


def logits_fn(params: Dict[str, Any], cfg: LMConfig):
    dt = common.dtype_of(cfg.dtype)
    return lambda h: h @ params["lm_head"].to(dt)


def forward(params: Dict[str, Any], cfg: LMConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None,
            return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = common.dtype_of(cfg.dtype)
    x = (params["embed"][tokens] if embeds is None else embeds).to(dt)

    def period(pp, x):
        for name in _names(cfg):
            x, _ = _block(name)(pp[name], cfg, x)
        return x

    for pp in common.unstack_layers(params["periods"], _n_periods(cfg)):
        x = common.remat(cfg.remat, period, pp, x)
    x = common.rms_norm(params["final_norm"], x, cfg.rms_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return logits_fn(params, cfg)(x), aux


class XLSTMCache(NamedTuple):
    """Decode-time recurrent state of every layer: a list over periods of
    dicts keyed like the period's blocks; length a 0-d int32 tensor."""
    states: Any
    length: torch.Tensor


def init_cache(params: Dict[str, Any], cfg: LMConfig,
               batch: int) -> XLSTMCache:
    d = cfg.d_model
    di = 2 * d
    heads = cfg.n_heads
    dh = di // heads
    dev = params["embed"].device
    f32 = torch.float32
    states = []
    for _ in range(_n_periods(cfg)):
        st = {}
        for name in _names(cfg):
            if name.endswith("_m"):
                st[name] = MLSTMState(
                    c=torch.zeros((batch, heads, dh, dh), dtype=f32,
                                  device=dev),
                    n=torch.zeros((batch, heads, dh), dtype=f32, device=dev),
                    m=torch.full((batch, heads), NEG_INF, dtype=f32,
                                 device=dev),
                    conv=torch.zeros((batch, cfg.conv_width - 1, di),
                                     dtype=f32, device=dev))
            else:
                st[name] = init_slstm_state(batch, d, dev)
        states.append(st)
    return XLSTMCache(states=states,
                      length=torch.zeros((), dtype=torch.int32, device=dev))


def decode_step(params: Dict[str, Any], cfg: LMConfig, tokens: torch.Tensor,
                cache: XLSTMCache) -> Tuple[torch.Tensor, XLSTMCache]:
    """tokens: (B, 1). O(1) per step: no KV cache, only recurrent state."""
    dt = common.dtype_of(cfg.dtype)
    x = params["embed"][tokens].to(dt)
    new_states = []
    periods = common.unstack_layers(params["periods"], _n_periods(cfg))
    for pp, st_in in zip(periods, cache.states):
        st_out = {}
        for name in _names(cfg):
            x, st_out[name] = _block(name)(pp[name], cfg, x, st_in[name])
        new_states.append(st_out)
    x = common.rms_norm(params["final_norm"], x, cfg.rms_eps)
    logits = (x @ params["lm_head"].to(dt))[:, 0]
    return logits, XLSTMCache(states=new_states, length=cache.length + 1)
