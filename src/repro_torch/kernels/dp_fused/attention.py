"""DPA-1's gated attention core, one layer, forward and backward:

    O_j = sum_k softmax_k((q_j . k_k + shift) ww_jk + pad_k) gate_jk v_k

over the live keys k of each atom's S slots. ``gated_attention`` is a
``torch.autograd.Function``: on CUDA tensors it runs the forward and the
backward kernel of ``csrc/dpa1_attention.cu`` (one block an atom), which
keep the (A, S, S) logits, softmax and weights and their gradients out of
device memory; on CPU tensors it runs
:func:`gated_attention_fwd_ref` and :func:`gated_attention_bwd_ref`, the same
algorithm in plain torch. There is no fallback: on a CUDA tensor the wrapper
launches the kernels or raises.

The algorithm, both versions: keys in tiles of :data:`KEY_TILE` with an
online softmax (a running max and sum a row), the forward saving only O and
the rows' statistics lse = max + log(sum) (A, S); the backward recomputing
the softmax P from q, k and lse and using D_j = dO_j . O_j, valid because the
weights are softmax o gate: dL_jk = P_jk (gate_jk dW_jk - D_j), dW = dO v^T.
A slot is live where its ``pad`` lies above :data:`PADDED_AT`. A key tile with
no live key adds exactly nothing and is skipped (the kernel per atom, the
plain version where no atom has a live key there); a padded query row gives
zeros in O, dq, dww and dgate (in the model its ww and gate rows are 0 and
nothing downstream reads it), a padded key zeros in dk and dv.

``attn_fwd_launches`` and ``attn_bwd_launches`` count kernel launches (not
plain-path calls); a call made while the current stream is being captured
into a CUDA graph counts in ``attn_fwd_captured``/``attn_bwd_captured``
instead, and the graph's owner adds what one replay launches with
:func:`count_replay` (``md/stepper.py``), as ``ops.fwd_launches`` is kept.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.dp_fused import build

#: keys a tile of the online softmax (the kernels' inner tile)
KEY_TILE = 32
#: a slot whose ``pad`` is at or below this is padded (the model adds -1e4)
PADDED_AT = -1e3
#: feature widths the kernels are built for
WIDTHS = (32, 64, 128)

attn_fwd_launches = 0
attn_bwd_launches = 0
attn_fwd_captured = 0
attn_bwd_captured = 0
# launched from one thread per rank (md/comm.LocalComm) and autograd's device
# thread: a count is a read-modify-write
_count_lock = threading.Lock()


def count_replay(fwd: int, bwd: int) -> None:
    """A replay of a graph that recorded ``fwd``/``bwd`` launches ran them."""
    global attn_fwd_launches, attn_bwd_launches
    with _count_lock:
        attn_fwd_launches += fwd
        attn_bwd_launches += bwd


def _count(kind: str) -> None:
    global attn_fwd_launches, attn_bwd_launches, attn_fwd_captured, \
        attn_bwd_captured
    captured = torch.cuda.is_current_stream_capturing()
    with _count_lock:
        if kind == "fwd" and captured:
            attn_fwd_captured += 1
        elif kind == "fwd":
            attn_fwd_launches += 1
        elif captured:
            attn_bwd_captured += 1
        else:
            attn_bwd_launches += 1


def kernel_cost(pairs: float, pairs_sq: float, atoms: int, slots: int,
                d: int) -> Dict[str, Tuple[float, float]]:
    """(bytes, FP32 operations) of each kernel call's least work on (A, S)
    slots with ``pairs`` = sum_i n_i live slots and ``pairs_sq`` = sum_i n_i^2
    live pairs, D features: inputs read once on live slots and pairs, outputs
    written whole (zeros where padded). Operations: 2D a live pair for each
    product, the forward's two (q.k, P v) and the minimal backward's five
    (q.k, dO.v, dq, dk, dv), and 8 (forward) or 12 (backward) for a pair's
    logit, exponential and gates."""
    slot_row, rows = 4.0 * d, float(atoms) * slots
    fwd_bytes = (3 * slot_row * pairs + 8.0 * pairs_sq + 4.0 * rows
                 + slot_row * rows + 4.0 * rows)
    bwd_bytes = (5 * slot_row * pairs + 8.0 * pairs_sq + 8.0 * rows
                 + 3 * slot_row * rows + 8.0 * rows * slots + 4.0 * rows)
    return {
        "dpa1_attention_fwd": (fwd_bytes, (2 * 2 * d + 8.0) * pairs_sq),
        "dpa1_attention_bwd": (bwd_bytes, (5 * 2 * d + 12.0) * pairs_sq),
    }


# ------------------------------------------------------------ plain version

def live_slots(pad: torch.Tensor) -> torch.Tensor:
    """(A, S) bool: the slots whose ``pad`` (A, 1, S) is above PADDED_AT."""
    return pad[:, 0, :] > PADDED_AT


def _key_tiles(live: torch.Tensor):
    """The key tiles in which some atom has a live key."""
    s = live.shape[1]
    for k0 in range(0, s, KEY_TILE):
        if bool(live[:, k0:k0 + KEY_TILE].any()):
            yield slice(k0, min(k0 + KEY_TILE, s))


def gated_attention_fwd_ref(q, k, v, ww, gate, pad, shift: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O (A, S, D) and lse (A, S) by the kernel's algorithm in plain torch:
    an online softmax over key tiles; zeros on padded query rows."""
    live = live_slots(pad)
    a, s, _ = q.shape
    m = torch.full((a, s), float("-inf"), dtype=q.dtype, device=q.device)
    l = torch.zeros((a, s), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    for t in _key_tiles(live):
        logit = (torch.matmul(q, k[:, t].transpose(1, 2)) + shift) \
            * ww[:, :, t] + pad[:, :, t]
        logit = torch.where(live[:, None, t], logit, float("-inf"))
        m_new = torch.maximum(m, logit.amax(dim=-1))
        # a row that has seen no live key yet keeps m = -inf and adds 0
        m_ref = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(logit - m_ref[..., None])
        alpha = torch.exp(m - m_ref)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.matmul(p * gate[:, :, t], v[:, t])
        m = m_new
    out = torch.where(live[..., None], o / torch.where(live, l, 1.0)[..., None],
                      0.0)
    lse = torch.where(live, m + torch.log(torch.where(live, l, 1.0)), 0.0)
    return out, lse


def gated_attention_bwd_ref(q, k, v, ww, gate, pad, shift: float, out, lse,
                            dout) -> Tuple[torch.Tensor, ...]:
    """dq, dk, dv (A, S, D) and dww, dgate (A, S, S) by the kernel's
    algorithm in plain torch: P recomputed from q, k and lse, D_j = dO_j .
    O_j; zeros on padded rows and keys."""
    live = live_slots(pad)
    dsum = (dout * out).sum(dim=-1)
    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    dww = torch.zeros_like(ww)
    dgate = torch.zeros_like(gate)
    for t in _key_tiles(live):
        ok = live[:, :, None] & live[:, None, t]
        sh = torch.matmul(q, k[:, t].transpose(1, 2)) + shift
        w, g = ww[:, :, t], gate[:, :, t]
        p = torch.where(ok, torch.exp(sh * w + pad[:, :, t] - lse[..., None]),
                        0.0)
        dw = torch.matmul(dout, v[:, t].transpose(1, 2))
        dl = p * (g * dw - dsum[..., None])
        dww[:, :, t] = dl * sh
        dgate[:, :, t] = dw * p
        ds = dl * w
        dq += torch.matmul(ds, k[:, t])
        dk[:, t] = torch.matmul(ds.transpose(1, 2), q)
        dv[:, t] = torch.matmul((p * g).transpose(1, 2), dout)
    return dq, dk, dv, dww, dgate


# ------------------------------------------------------------------ kernels

def _check(q, k, v, ww, gate, pad) -> None:
    if q.dim() != 3:
        raise ValueError(f"q must be (A, S, D); got {tuple(q.shape)}")
    a, s, d = q.shape
    dev = q.device
    for name, t, shape in (("q", q, (a, s, d)), ("k", k, (a, s, d)),
                           ("v", v, (a, s, d)), ("ww", ww, (a, s, s)),
                           ("gate", gate, (a, s, s)), ("pad", pad, (a, 1, s))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q {q.dtype}")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"gated_attention runs on cuda or cpu tensors, not "
                         f"{dev}")
    if q.dtype != torch.float32:
        raise TypeError(f"the kernels take float32, not {q.dtype}")
    if d not in WIDTHS:
        raise ValueError(f"the kernels take D in {WIDTHS}; got {d}")
    for name, t in (("q", q), ("k", k), ("v", v), ("ww", ww),
                    ("gate", gate), ("pad", pad)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch_fwd(q, k, v, ww, gate, pad, shift):
    a, s, d = q.shape
    kl = build.load()
    out = torch.empty_like(q)
    lse = torch.empty((a, s), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = kl.lib.dpa1_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ww.data_ptr(),
            gate.data_ptr(), pad.data_ptr(), out.data_ptr(), lse.data_ptr(),
            a, s, d, float(shift), PADDED_AT, stream)
    kl.check(code, "dpa1_attention_fwd launch")
    _count("fwd")
    return out, lse


def _launch_bwd(q, k, v, ww, gate, pad, shift, out, lse, dout):
    a, s, d = q.shape
    kl = build.load()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dww = torch.empty_like(ww)
    dgate = torch.empty_like(gate)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = kl.lib.dpa1_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ww.data_ptr(),
            gate.data_ptr(), pad.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dww.data_ptr(), dgate.data_ptr(), a, s, d, float(shift),
            PADDED_AT, stream)
    kl.check(code, "dpa1_attention_bwd launch")
    _count("bwd")
    return dq, dk, dv, dww, dgate


def gated_attention_fwd(q, k, v, ww, gate, pad, shift: float):
    """O (A, S, D) and lse (A, S): the kernel on CUDA, the plain version on
    the CPU."""
    _check(q, k, v, ww, gate, pad)
    if q.device.type == "cpu":
        return gated_attention_fwd_ref(q, k, v, ww, gate, pad, shift)
    return _launch_fwd(q, k, v, ww, gate, pad, shift)


def gated_attention_bwd(q, k, v, ww, gate, pad, shift: float, out, lse, dout):
    """dq, dk, dv, dww, dgate: the kernels on CUDA, the plain version on the
    CPU."""
    _check(q, k, v, ww, gate, pad)
    if q.device.type == "cpu":
        return gated_attention_bwd_ref(q, k, v, ww, gate, pad, shift, out,
                                       lse, dout)
    return _launch_bwd(q, k, v, ww, gate, pad, shift, out, lse,
                       dout.contiguous())


class GatedAttention(torch.autograd.Function):
    """O of one gated attention layer; backward through
    :func:`gated_attention_bwd`. ``pad`` and ``shift`` take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, ww, gate, pad, shift):
        out, lse = gated_attention_fwd(q, k, v, ww, gate, pad, shift)
        ctx.save_for_backward(q, k, v, ww, gate, pad, out, lse)
        ctx.shift = shift
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, ww, gate, pad, out, lse = ctx.saved_tensors
        grads = gated_attention_bwd(q, k, v, ww, gate, pad, ctx.shift, out,
                                    lse, dout)
        return (*grads, None, None)


def gated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ww: torch.Tensor, gate: torch.Tensor, pad: torch.Tensor,
                    shift: float) -> torch.Tensor:
    """O (A, S, D) of q, k, v (A, S, D), the gates ww and gate (A, S, S) and
    the logits' additive term pad (A, 1, S), PADDED_AT or below on padded
    slots."""
    return GatedAttention.apply(q, k, v, ww, gate, pad, float(shift))
