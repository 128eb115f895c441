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
from torch.utils.flop_counter import register_flop_formula

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common
from repro_torch.models.attention import split_heads
from repro_torch.models.lm_types import LMConfig
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import constrain

NEG_INF = -1e30


# ---------------------------------------------------------------- mLSTM cell

def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, S, D); w: (W, D). Returns (y, new_state).

    state: (B, W-1, D) trailing inputs of the previous segment (decode).
    A DTensor ``x`` is made whole along the sequence first (the conv reads
    across it), and the zero pad is laid out as ``x``.
    """
    if ctx.is_dtensor(x):
        x = common.whole_along(x, 1)
    width = w.shape[0]
    shape = (x.shape[0], width - 1, x.shape[2])
    if state is not None:
        pad = state.to(x.dtype)
    elif ctx.is_dtensor(x):
        pad = ctx.zeros_placed(shape, x.dtype, x.device_mesh, x.placements)
    else:
        pad = torch.zeros(shape, dtype=x.dtype, device=x.device)
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


def _mlstm_cell(q, k, v, log_i, f_pre, cell, chunk: int):
    """The mLSTM cell over (B, S, H, ·) inputs, ``f_pre`` the forget gates'
    f32 pre-activations: from a zero state along the sequence in chunks
    (``cell`` None), else one step of the recurrent state ``cell`` = (c, n,
    m), each (B, H, ·). Returns (h (B, S, H * dh) f32, (c, n, m))."""
    b, s, n_heads, dh = q.shape
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B,H,S,dh)
    log_i = log_i.transpose(1, 2)                       # (B,H,S)
    log_f = F.logsigmoid(f_pre.transpose(1, 2))
    if cell is None:
        f32, dev = torch.float32, q.device
        cell = (torch.zeros((b, n_heads, dh, dh), dtype=f32, device=dev),
                torch.zeros((b, n_heads, dh), dtype=f32, device=dev),
                torch.full((b, n_heads), NEG_INF, dtype=f32, device=dev))
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
        h_out, cell = _mlstm_chunk(q, k, v, log_i, log_f, cell)
    return h_out.transpose(1, 2).reshape(b, s, n_heads * dh), cell


def _mlstm_on_shards(q, k, v, log_i, f_pre, cell, chunk: int):
    """``_mlstm_cell`` of DTensors, each rank on its batch rows and heads
    (the heads whole when the model axis does not divide them). The heads'
    transposes and their merge in h run here, on the shards: DTensor runs
    the backward of a reshape of a DTensor as a view of the local
    gradient, which a transposed gradient cannot take, and would split a
    merged gradient into heads that the model axis may not divide. (It has
    no rule for the backward of ``logsigmoid`` either.)"""
    def lay(t, heads_at):
        roles = [None] * t.dim()
        roles[0], roles[heads_at] = "batch", "heads"
        return constrain(t, *roles)

    q = lay(q, 2)
    args = [ctx.local(lay(t, 2)) for t in (q, k, v, log_i, f_pre)]
    if cell is not None:
        cell = tuple(ctx.local(lay(t, 1)) for t in cell)
    h_out, cell = _mlstm_cell(*args, cell, chunk)
    return (ctx.wrap(h_out, q),
            tuple(ctx.wrap(t, q, dims={2: 1}) for t in cell))


def mlstm_block(p: Dict[str, Any], cfg: LMConfig, x: torch.Tensor,
                state: Optional[MLSTMState] = None
                ) -> Tuple[torch.Tensor, MLSTMState]:
    """x: (B, S, d). state given => recurrent path (decode)."""
    b, s, d = x.shape
    n_heads = cfg.n_heads
    di = 2 * d
    f32 = torch.float32
    xn = common.rms_norm(p["norm"], x, cfg.rms_eps)
    x_in, z = (xn @ p["w_up"].to(xn.dtype)).chunk(2, dim=-1)  # (B,S,di)
    conv_state = None if state is None else state.conv
    x_c, conv_new = _causal_conv1d(x_in, p["conv_w"].to(x_in.dtype),
                                   conv_state)
    x_c = F.silu(x_c)

    def heads(t):
        return split_heads(t, n_heads).to(f32)          # (B,S,H,dh)

    q = heads(x_c @ p["w_q"].to(x_c.dtype))
    k = heads(x_c @ p["w_k"].to(x_c.dtype))
    v = heads(x_in @ p["w_v"].to(x_in.dtype))
    # bf16 products plus the f32 biases: f32, as in the reference
    log_i = (x_c @ p["w_i"].to(x_c.dtype) + p["b_i"]).to(f32)   # (B,S,H)
    f_pre = (x_c @ p["w_f"].to(x_c.dtype) + p["b_f"]).to(f32)

    cell = None if state is None else (state.c, state.n, state.m)
    chunk = min(cfg.xlstm_chunk, s)
    if ctx.is_dtensor(q):
        # on DTensors the chunk loop's masks, cumulative maxima and
        # concatenations would each be an op to place; the cell is
        # independent across batch rows and heads
        h_flat, cell = _mlstm_on_shards(q, k, v, log_i, f_pre, cell, chunk)
    else:
        h_flat, cell = _mlstm_cell(q, k, v, log_i, f_pre, cell, chunk)
    h_flat = h_flat.to(x.dtype)                         # (B,S,di)

    h_flat = common.rms_norm(p["gn"], h_flat, cfg.rms_eps)  # group-norm stand-in
    # summed whole over the model axis before it joins the residual
    # (``griffin.recurrent_block``)
    out = constrain((h_flat * F.silu(z)) @ p["w_down"].to(x.dtype),
                    "batch", None, None)
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


def _slstm_step(r: torch.Tensor, n_heads: int, wx_t: torch.Tensor,
                st: SLSTMState) -> SLSTMState:
    """One timestep. r: the f32 recurrent matrices (4, H, dh, dh);
    wx_t: (B, 4d) precomputed input projections."""
    b, d = wx_t.shape[0], wx_t.shape[1] // 4
    h_prev = st.h.reshape(b, n_heads, d // n_heads).float()
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
    return SLSTMState(c=c_new, n=n_new, h=h_new, m=m_new)


def init_slstm_state(batch: int, d: int, device) -> SLSTMState:
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z.clone(), h=z.clone(),
                      m=torch.full((batch, d), NEG_INF, dtype=torch.float32,
                                   device=device))


# The sLSTM recurrence as one op, the counterpart of the reference's
# ``lax.scan``: its forward keeps every step's state (the scan's stacked
# residuals) and its backward runs the steps in reverse (``_slstm_vjp``,
# each step's gradient written out: autograd does not run inside an op). A
# traced program (the dry run, under FakeTensorMode) then sees two ops a
# layer where a loop of eager steps dispatches ~100 ops a token (xlstm-125m's
# train_4k cell did not finish tracing in 9 CPU-minutes).
_STATE = ("h", "c", "n", "m")


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def slstm_scan(r: torch.Tensor, wx: torch.Tensor, c: torch.Tensor,
               n: torch.Tensor, h: torch.Tensor, m: torch.Tensor,
               n_heads: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The state (h, c, n, m) after every step, each (B, S, d) f32, of the
    recurrence over wx (B, S, 4d) from (c, n, h, m) (B, d) with the
    recurrent matrices r (4, H, dh, dh)."""
    b, s, d = wx.shape[0], wx.shape[1], wx.shape[2] // 4
    out = [torch.empty((b, s, d), dtype=torch.float32, device=wx.device)
           for _ in _STATE]
    st, r = SLSTMState(c, n, h, m), r.float()
    for t in range(s):
        st = _slstm_step(r, n_heads, wx[:, t], st)
        for o, name in zip(out, _STATE):
            o[:, t] = getattr(st, name)
    return tuple(out)


@slstm_scan.register_fake
def _(r, wx, c, n, h, m, n_heads):
    shape = (wx.shape[0], wx.shape[1], wx.shape[2] // 4)
    return tuple(wx.new_empty(shape, dtype=torch.float32) for _ in _STATE)


def _slstm_vjp(r: torch.Tensor, n_heads: int, wx_t: torch.Tensor,
               st: SLSTMState, g: SLSTMState):
    """The gradients of one ``_slstm_step`` from ``st``, given those ``g``
    of its new state: (g of st as an SLSTMState, g of wx_t (B, 4d) f32, g
    of the f32 r). The step is recomputed; ``torch.maximum`` splits a
    tie's gradient in half, as its autograd does."""
    b, d = wx_t.shape[0], wx_t.shape[1] // 4
    hp = st.h.reshape(b, n_heads, d // n_heads).float()
    rec = torch.einsum("bhd,ghde->gbhe", hp, r).reshape(4, b, d)
    pre = wx_t.float().reshape(b, 4, d).transpose(0, 1) + rec
    z, i_t, f_t, o = torch.tanh(pre[0]), pre[1], pre[2], torch.sigmoid(pre[3])
    a = f_t + st.m
    m_new = torch.maximum(a, i_t)
    i_p, f_p = torch.exp(i_t - m_new), torch.exp(a - m_new)
    c_new = f_p * st.c + i_p * z
    n_new = f_p * st.n + i_p
    n_c = n_new.clamp_min(1e-6)
    g_o = g.h * c_new / n_c
    g_c = g.c + g.h * o / n_c
    g_n = g.n + torch.where(n_new >= 1e-6, -g.h * o * c_new / (n_c * n_c),
                            0.0)
    g_fp = g_c * st.c + g_n * st.n
    g_ip = g_c * z + g_n
    g_m = g.m - g_ip * i_p - g_fp * f_p
    half = torch.where(a == i_t, g_m / 2, g_m)
    g_a = g_fp * f_p + torch.where(a >= i_t, half, 0.0)
    g_it = g_ip * i_p + torch.where(i_t >= a, half, 0.0)
    g_pre = torch.stack([g_c * i_p * (1 - z * z), g_it, g_a,
                         g_o * o * (1 - o)])                   # (4, B, d)
    g_rec = g_pre.reshape(4, b, n_heads, d // n_heads)
    g_h = torch.einsum("gbhe,ghde->bhd", g_rec, r).reshape(b, d)
    g_r = torch.einsum("bhd,gbhe->ghde", hp, g_rec)
    return (SLSTMState(c=g_c * f_p, n=g_n * f_p, h=g_h, m=g_a),
            g_pre.transpose(0, 1).reshape(b, 4 * d), g_r)


@torch.library.custom_op("repro_torch::slstm_scan_bwd", mutates_args=())
def slstm_scan_bwd(r: torch.Tensor, wx: torch.Tensor, c: torch.Tensor,
                   n: torch.Tensor, h: torch.Tensor, m: torch.Tensor,
                   hs: torch.Tensor, cs: torch.Tensor, ns: torch.Tensor,
                   ms: torch.Tensor, g_h: torch.Tensor, g_c: torch.Tensor,
                   g_n: torch.Tensor, g_m: torch.Tensor, n_heads: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``slstm_scan`` (r, wx, c, n, h, m) from those of its
    outputs, the forward's states (hs, cs, ns, ms) kept: a reverse loop
    over the steps, each differentiated from the state before it."""
    r32 = r.float()
    d_r = torch.zeros_like(r32)
    d_wx = torch.empty_like(wx)
    carry = SLSTMState(*(torch.zeros_like(c) for _ in _STATE))
    for t in reversed(range(wx.shape[1])):
        prev = SLSTMState(c=c, n=n, h=h, m=m) if t == 0 else SLSTMState(
            c=cs[:, t - 1], n=ns[:, t - 1], h=hs[:, t - 1], m=ms[:, t - 1])
        g = SLSTMState(c=carry.c + g_c[:, t], n=carry.n + g_n[:, t],
                       h=carry.h + g_h[:, t], m=carry.m + g_m[:, t])
        carry, g_wx, g_r = _slstm_vjp(r32, n_heads, wx[:, t], prev, g)
        d_wx[:, t] = g_wx
        d_r += g_r
    return (d_r.to(r.dtype), d_wx, carry.c, carry.n, carry.h, carry.m)


@slstm_scan_bwd.register_fake
def _(r, wx, c, n, h, m, hs, cs, ns, ms, g_h, g_c, g_n, g_m, n_heads):
    return (r.new_empty(r.shape), wx.new_empty(wx.shape), c.new_empty(
        c.shape), n.new_empty(n.shape), h.new_empty(h.shape),
        m.new_empty(m.shape))


def _scan_setup(ctx, inputs, output):
    ctx.n_heads = inputs[-1]
    ctx.save_for_backward(*inputs[:-1], *output)


def _scan_backward(ctx, *grads):
    saved = ctx.saved_tensors
    grads = [torch.zeros_like(o) if g is None else g
             for o, g in zip(saved[6:], grads)]
    return (*slstm_scan_bwd(*saved, *grads, ctx.n_heads), None)


slstm_scan.register_autograd(_scan_backward, setup_context=_scan_setup)


def _scan_flops(wx_shape, r_shape) -> int:
    """The recurrent products of a forward: (4, H, dh, dh) against each
    step's (B, H, dh) hidden state, 2 x B x 4d x dh a step."""
    b, s, d4 = wx_shape
    return 2 * b * s * d4 * r_shape[-1]


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _(r_shape, wx_shape, *args, out_shape=None, **kwargs) -> int:
    return _scan_flops(wx_shape, r_shape)


@register_flop_formula(torch.ops.repro_torch.slstm_scan_bwd)
def _(r_shape, wx_shape, *args, out_shape=None, **kwargs) -> int:
    # each step recomputed, then its products' two gradients
    return 3 * _scan_flops(wx_shape, r_shape)


def _slstm_sequence(r: torch.Tensor, cfg: LMConfig, wx: torch.Tensor,
                    state: Optional[SLSTMState]
                    ) -> Tuple[torch.Tensor, SLSTMState]:
    """The sLSTM recurrence over wx (B, S, 4d) from ``state`` (zeros if
    None), through ``slstm_scan``. Returns (h (B, S, d) f32, final
    state)."""
    if state is None:
        state = init_slstm_state(wx.shape[0], cfg.d_model, wx.device)
    hs, cs, ns, ms = slstm_scan(r, wx, state.c, state.n, state.h, state.m,
                                cfg.n_heads)
    return hs, SLSTMState(c=cs[:, -1], n=ns[:, -1], h=hs[:, -1],
                          m=ms[:, -1])


def _slstm_on_shards(r, cfg, wx, state):
    """``_slstm_sequence`` of DTensors, each rank on its batch rows with
    every head and the recurrent matrices whole (the plan replicates
    ``r_zifo``), wrapped back: a step over DTensors would dispatch a
    dozen DTensor ops per token."""
    wx = constrain(wx, "batch", None, None)
    r = ctx.local_weight(common.whole_but(r, None), wx)
    if state is not None:
        state = SLSTMState(*(ctx.local(constrain(t, "batch", None))
                             for t in state))
    h_seq, state = _slstm_sequence(r, cfg, ctx.local(wx), state)
    return ctx.wrap(h_seq, wx), SLSTMState(*(ctx.wrap(t, wx) for t in state))


def slstm_block(p: Dict[str, Any], cfg: LMConfig, x: torch.Tensor,
                state: Optional[SLSTMState] = None
                ) -> Tuple[torch.Tensor, SLSTMState]:
    xn = common.rms_norm(p["norm"], x, cfg.rms_eps)
    wx = xn @ p["w_zifo"].to(xn.dtype) + p["b_zifo"].to(xn.dtype)  # (B,S,4d)
    if ctx.is_dtensor(wx):
        h_seq, state = _slstm_on_shards(p["r_zifo"], cfg, wx, state)
    else:
        h_seq, state = _slstm_sequence(p["r_zifo"], cfg, wx, state)
    h_seq = h_seq.to(x.dtype)                            # (B,S,d)
    h_seq = common.rms_norm(p["gn"], h_seq, cfg.rms_eps)
    up = common.gelu(h_seq @ p["up1"].to(x.dtype)) * (
        h_seq @ p["up2"].to(x.dtype))
    return x + constrain(up @ p["down"].to(x.dtype), "batch", None,
                         None), state


# ------------------------------------------------------------- full LM model

def _n_periods(cfg: LMConfig) -> int:
    period = len(cfg.xlstm_pattern)
    if cfg.n_layers % period:
        raise ValueError("n_layers must tile the pattern")
    return cfg.n_layers // period


def _names(cfg: LMConfig) -> List[str]:
    return [f"{i}_{kind}" for i, kind in enumerate(cfg.xlstm_pattern)]


def init_params(gen: torch.Generator, cfg: LMConfig,
                device: DeviceLike = "cuda",
                place: Optional[common.Place] = None) -> Dict[str, Any]:
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
        "periods": common.stack_layers(
            (init_period() for _ in range(_n_periods(cfg))), "periods",
            place),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": tn(gen, (cfg.d_model, cfg.vocab), 1.0, dt, dev),
    }


def _block(name: str):
    return mlstm_block if name.endswith("_m") else slstm_block


def logits_fn(params: Dict[str, Any], cfg: LMConfig):
    dt = common.dtype_of(cfg.dtype)
    return lambda h: constrain(h @ params["lm_head"].to(dt),
                               "batch", None, "vocab")


def forward(params: Dict[str, Any], cfg: LMConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None,
            return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = common.dtype_of(cfg.dtype)
    x = (common.embed(params["embed"], tokens) if embeds is None
         else embeds).to(dt)
    x = constrain(x, "batch", None, None)

    def period(pp, x):
        for name in _names(cfg):
            x, _ = _block(name)(pp[name], cfg, x)
            x = constrain(x, "batch", None, None)
        return x

    for pp in common.unstack_layers(params["periods"], _n_periods(cfg)):
        x = common.remat(cfg.remat, period, pp, x)
    x = common.rms_norm(params["final_norm"], x, cfg.rms_eps)
    aux = ctx.like(x, torch.zeros((), dtype=torch.float32, device=x.device))
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
    x = constrain(common.embed(params["embed"], tokens).to(dt),
                  "batch", None, None)
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
