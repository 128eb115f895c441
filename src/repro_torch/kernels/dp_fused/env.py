"""The se_e2_a environment matrix and its normalisation, forward and
backward, as one kernel each.

``env_mat`` is a ``torch.autograd.Function`` over two ``torch.library``
custom ops, ``repro_torch::env_mat_fwd`` and ``repro_torch::env_mat_bwd``:
on CUDA tensors the kernels of ``csrc/env_mat.cu``, on CPU tensors the
plain version, the forward in ``descriptor.env_matrix`` and
``normalize_env``'s own ops (:func:`env_mat_ref`) and the backward in closed
form (:func:`env_mat_bwd_ref`). There is no fallback: on a CUDA tensor the
wrapper launches the kernel or raises.

Nothing is saved but the inputs: the backward recomputes r, s, s' and the
unit vector from r_ij. It returns dE/dr_ij only. ``dstd`` gets no gradient,
as the dp_fused pair gives none to the table, and the pair has no double
backward: the ``cheb_pallas`` rung is inference-only (training runs
``impl="mlp"`` through ``descriptor.env_matrix``).

``env_fwd_launches`` and ``env_bwd_launches`` count kernel launches (not
plain-path calls); a call made while the current stream is being captured
into a CUDA graph counts in ``env_fwd_captured``/``env_bwd_captured``
instead, and the graph's owner adds what one replay launches with
:func:`count_replay` (``md/stepper.py``), as ``ops.fwd_launches`` is kept.

Each op has a fake implementation (empty outputs of the right shapes), so a
``FakeTensorMode`` trace runs through them without reaching ``nvcc`` or
``ctypes``. Neither has a FLOP formula: ``flop_counter`` counted none of the
elementwise ops they replace.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core import descriptor
from repro_torch.kernels.dp_fused import build

env_fwd_launches = 0
env_bwd_launches = 0
env_fwd_captured = 0
env_bwd_captured = 0
# launched from one thread per rank (md/comm.LocalComm) and autograd's device
# thread: a count is a read-modify-write
_count_lock = threading.Lock()


def count_replay(fwd: int, bwd: int) -> None:
    """A replay of a graph that recorded ``fwd``/``bwd`` launches ran them."""
    global env_fwd_launches, env_bwd_launches
    with _count_lock:
        env_fwd_launches += fwd
        env_bwd_launches += bwd


def _count(kind: str) -> None:
    global env_fwd_launches, env_bwd_launches, env_fwd_captured, \
        env_bwd_captured
    captured = torch.cuda.is_current_stream_capturing()
    with _count_lock:
        if kind == "fwd" and captured:
            env_fwd_captured += 1
        elif kind == "fwd":
            env_fwd_launches += 1
        elif captured:
            env_bwd_captured += 1
        else:
            env_bwd_launches += 1


def kernel_bytes(filled: float, slots: float, atoms: float
                 ) -> Dict[str, float]:
    """Bytes each kernel must move on ``slots`` slots of which ``filled``
    hold a neighbour (mask true): the mask and the outputs on every slot,
    r_ij (and, backward, the row's and s's gradients) on filled slots, the
    centres' types once."""
    return {"env_mat_fwd": slots * (1 + 16 + 4) + filled * 12 + atoms * 8,
            "env_mat_bwd": slots * (1 + 12) + filled * (12 + 16 + 4)
            + atoms * 8}


# ------------------------------------------------------------ plain version

def env_mat_ref(rij: torch.Tensor, nmask: torch.Tensor, atype: torch.Tensor,
                dstd: torch.Tensor, rcut_smth: float, rcut: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The normalised rows (A, N, 4) and s (A, N): ``descriptor.env_matrix``
    then ``normalize_env``."""
    env, s = descriptor.env_matrix(rij, nmask, rcut_smth, rcut)
    return descriptor.normalize_env(env, s, atype, dstd)


def env_mat_bwd_ref(rij: torch.Tensor, nmask: torch.Tensor,
                    atype: torch.Tensor, dstd: torch.Tensor,
                    denv: torch.Tensor, ds: torch.Tensor, rcut_smth: float,
                    rcut: float) -> torch.Tensor:
    """dE/dr_ij (A, N, 3) from the gradients of the rows (A, N, 4) and of s
    (A, N), in closed form (the kernel's algorithm):

        dE/dr_b = rh_b (s' (g0 + G) - (s/r) G) + (s/r) g_b,  G = g . rh,

    g0 = (denv_0 + ds) / dstd_0, g_a = denv_a / dstd_a, rh = r_ij / r,
    s' = (w' r - w) / r^2, w' = -30 u^2 (u - 1)^2 / (rcut - rcut_smth) for
    0 < u < 1; zero outside 1e-6 < r < rcut and on padded slots."""
    span = rcut - rcut_smth
    r = torch.linalg.vector_norm(torch.where(nmask[..., None], rij, 1.0),
                                 dim=-1)
    inside = nmask & (r > 1e-6) & (r < rcut)
    safe_r = torch.where(inside, r, 1.0)
    u = (r - rcut_smth) / span
    uu = torch.clamp(u, 0.0, 1.0)
    w = uu * uu * uu * (-6.0 * uu * uu + 15.0 * uu - 10.0) + 1.0
    dw = torch.where((u > 0.0) & (u < 1.0),
                     -30.0 * u * u * (u - 1.0) * (u - 1.0) / span, 0.0)
    s = w / safe_r
    s_r = (dw * safe_r - w) / (safe_r * safe_r)
    scale = dstd[atype][..., None, :]                 # (A, 1, 4)
    g0 = (denv[..., 0] + ds) / scale[..., 0]
    g = denv[..., 1:] / scale[..., 1:]
    unit = torch.where(inside[..., None], rij, 0.0) / safe_r[..., None]
    dot = (g * unit).sum(dim=-1)
    sor = s / safe_r
    c = s_r * (g0 + dot) - sor * dot
    out = c[..., None] * unit + sor[..., None] * g
    return torch.where(inside[..., None], out, 0.0)


# ---------------------------------------------------------------- kernels

def _launch_fwd(rij, nmask, atype, dstd, rcut_smth, rcut):
    a, n = nmask.shape
    kl = build.load()
    env = torch.empty((a, n, 4), dtype=torch.float32, device=rij.device)
    s_n = torch.empty((a, n), dtype=torch.float32, device=rij.device)
    with torch.cuda.device(rij.device):
        stream = torch.cuda.current_stream(rij.device).cuda_stream
        code = kl.lib.env_mat_fwd(
            rij.data_ptr(), nmask.data_ptr(), atype.data_ptr(),
            dstd.data_ptr(), env.data_ptr(), s_n.data_ptr(), a * n, max(n, 1),
            dstd.shape[0], float(rcut_smth), float(rcut),
            float(rcut - rcut_smth), stream)
    kl.check(code, "env_mat_fwd launch")
    _count("fwd")
    return env, s_n


def _launch_bwd(rij, nmask, atype, dstd, denv, ds, rcut_smth, rcut):
    a, n = nmask.shape
    kl = build.load()
    if denv.data_ptr() % 16:              # the kernel loads float4 rows
        denv = denv.clone()
    drij = torch.empty((a, n, 3), dtype=torch.float32, device=rij.device)
    with torch.cuda.device(rij.device):
        stream = torch.cuda.current_stream(rij.device).cuda_stream
        code = kl.lib.env_mat_bwd(
            rij.data_ptr(), nmask.data_ptr(), atype.data_ptr(),
            dstd.data_ptr(), denv.data_ptr(), ds.data_ptr(), drij.data_ptr(),
            a * n, max(n, 1), dstd.shape[0], float(rcut_smth), float(rcut),
            float(rcut - rcut_smth), stream)
    kl.check(code, "env_mat_bwd launch")
    _count("bwd")
    return drij


@torch.library.custom_op(
    "repro_torch::env_mat_fwd", mutates_args=(),
    schema="(Tensor rij, Tensor nmask, Tensor atype, Tensor dstd, "
           "float rcut_smth, float rcut) -> (Tensor, Tensor)")
def _fwd_op(rij, nmask, atype, dstd, rcut_smth, rcut):
    if rij.device.type == "cpu":
        return env_mat_ref(rij, nmask, atype, dstd, rcut_smth, rcut)
    return _launch_fwd(rij, nmask, atype, dstd, rcut_smth, rcut)


@_fwd_op.register_fake
def _(rij, nmask, atype, dstd, rcut_smth, rcut):
    return rij.new_empty((*nmask.shape, 4)), rij.new_empty(nmask.shape)


@torch.library.custom_op(
    "repro_torch::env_mat_bwd", mutates_args=(),
    schema="(Tensor rij, Tensor nmask, Tensor atype, Tensor dstd, "
           "Tensor denv, Tensor ds, float rcut_smth, float rcut) -> Tensor")
def _bwd_op(rij, nmask, atype, dstd, denv, ds, rcut_smth, rcut):
    if rij.device.type == "cpu":
        return env_mat_bwd_ref(rij, nmask, atype, dstd, denv, ds, rcut_smth,
                               rcut)
    return _launch_bwd(rij, nmask, atype, dstd, denv, ds, rcut_smth, rcut)


@_bwd_op.register_fake
def _(rij, nmask, atype, dstd, denv, ds, rcut_smth, rcut):
    return rij.new_empty(rij.shape)


def _check(rij, nmask, atype, dstd, rcut_smth, rcut) -> None:
    if rij.dim() != 3 or rij.shape[-1] != 3:
        raise ValueError(f"rij must be (A, N, 3); got {tuple(rij.shape)}")
    a, n = rij.shape[:2]
    for name, t, shape in (("nmask", nmask, (a, n)), ("atype", atype, (a,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if dstd.dim() != 2 or dstd.shape[1] != 4:
        raise ValueError(f"dstd must be (ntypes, 4); got {tuple(dstd.shape)}")
    if not 0.0 <= rcut_smth < rcut:
        raise ValueError(f"need 0 <= rcut_smth < rcut; got {rcut_smth}, "
                         f"{rcut}")
    dev = rij.device
    for name, t in (("nmask", nmask), ("atype", atype), ("dstd", dstd)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"env_mat runs on cuda or cpu tensors, not {dev}")
    for name, t, dtype in (("rij", rij, torch.float32),
                           ("nmask", nmask, torch.bool),
                           ("atype", atype, torch.int64),
                           ("dstd", dstd, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class EnvMat(torch.autograd.Function):
    """(env_n, s_n) of (A, N) rows; backward through ``env_mat_bwd``."""

    @staticmethod
    def forward(ctx, rij, nmask, atype, dstd, rcut_smth, rcut):
        ctx.save_for_backward(rij, nmask, atype, dstd)
        ctx.cut = (rcut_smth, rcut)
        return torch.ops.repro_torch.env_mat_fwd(rij, nmask, atype, dstd,
                                                 rcut_smth, rcut)

    @staticmethod
    @once_differentiable
    def backward(ctx, denv, ds):
        rij, nmask, atype, dstd = ctx.saved_tensors
        drij = torch.ops.repro_torch.env_mat_bwd(
            rij, nmask, atype, dstd, denv.contiguous(), ds.contiguous(),
            *ctx.cut)
        return drij, None, None, None, None, None


def env_mat(rij: torch.Tensor, nmask: torch.Tensor, atype: torch.Tensor,
            dstd: torch.Tensor, rcut_smth: float, rcut: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The normalised environment matrix (..., N, 4) and s (..., N) of
    rij (..., N, 3), nmask (..., N) and the centres' types (...,) (each
    row's scale is ``dstd[atype]``), as ``descriptor.env_matrix`` then
    ``normalize_env`` give them. Leading batch dims are flattened into the
    atom axis; a non-contiguous rij is copied to a contiguous one first."""
    lead, n = rij.shape[:-2], rij.shape[-2]
    rij2 = rij.reshape(-1, n, 3).contiguous()
    nmask2 = nmask.expand(rij.shape[:-1]).reshape(-1, n).contiguous()
    atype2 = atype.expand(lead).reshape(-1).long().contiguous()
    dstd2 = dstd.detach().contiguous()
    rcut_smth, rcut = float(rcut_smth), float(rcut)
    _check(rij2, nmask2, atype2, dstd2, rcut_smth, rcut)
    env_n, s_n = EnvMat.apply(rij2, nmask2, atype2, dstd2, rcut_smth, rcut)
    return env_n.reshape(*lead, n, 4), s_n.reshape(*lead, n)
