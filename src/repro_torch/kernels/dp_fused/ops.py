"""Public wrapper of the fused tabulation + contraction kernels.

``fused_env_tab_contract`` is a ``torch.autograd.Function``: the forward
runs ``dp_fused_fwd`` and the backward ``dp_fused_bwd`` (the CUDA kernels in
``csrc/dp_fused.cu``) on CUDA tensors, and their plain versions from
``ref.py`` on CPU tensors. There is no fallback: on a CUDA tensor the
wrapper launches the kernel or raises.

Tables are post-training artifacts (paper Sec. 3.2), so the coefficients get
no gradient; forces (dE/dpositions) flow through s and env.

``fwd_launches`` and ``bwd_launches`` count kernel launches (not plain-path
calls), so a run can show that it went through the kernels. A call made
while the current stream is being captured into a CUDA graph launches
nothing: it counts in ``fwd_captured``/``bwd_captured`` instead, and the
graph's owner adds what one replay launches with :func:`count_replay` each
time it replays the graph (``md/stepper.py``).

Both kernels are ``torch.library`` custom ops, ``repro_torch::dp_fused_fwd``
and ``repro_torch::dp_fused_bwd``: the dispatcher sees each launch as one
op. Each has a fake implementation (empty outputs of the right shapes), so a
trace under ``FakeTensorMode`` runs the model through them without reaching
``nvcc`` or ``ctypes`` (a fake tensor has no data, so nothing is hidden),
and a FLOP formula for ``torch.utils.flop_counter`` from
:func:`kernel_cost`, the same count the smoke run's bounds use. A fake trace
has no live counts, so the formula counts every slot as live, times the
share set by :func:`live_fraction` (1 unless a caller states the expected
live share of the slots).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.dp_fused import build, ref

fwd_launches = 0
bwd_launches = 0
fwd_captured = 0
bwd_captured = 0
# the distributed step launches from one thread per rank (md/comm.LocalComm)
# and autograd's device thread: a count is a read-modify-write
_count_lock = threading.Lock()


def count_replay(fwd: int, bwd: int) -> None:
    """A replay of a graph that recorded ``fwd``/``bwd`` launches ran them."""
    global fwd_launches, bwd_launches
    with _count_lock:
        fwd_launches += fwd
        bwd_launches += bwd


def _count(kind: str) -> None:
    """One launch (or one captured call) of the ``kind`` kernel."""
    global fwd_launches, bwd_launches, fwd_captured, bwd_captured
    captured = torch.cuda.is_current_stream_capturing()
    with _count_lock:
        if kind == "fwd" and captured:
            fwd_captured += 1
        elif kind == "fwd":
            fwd_launches += 1
        elif captured:
            bwd_captured += 1
        else:
            bwd_launches += 1


def live_counts(s: torch.Tensor) -> torch.Tensor:
    """Per-atom live slot count (A,) int32: 1 + the last slot with s != 0."""
    a, n = s.shape
    if n == 0:
        return torch.zeros(a, dtype=torch.int32, device=s.device)
    slot = torch.arange(1, n + 1, dtype=torch.int32, device=s.device)
    return torch.where(s != 0.0, slot, 0).amax(dim=1).to(torch.int32)


def _require(t: torch.Tensor, name: str, shape: Tuple[int, ...],
             dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(s, env, coeffs, counts) -> Tuple[int, int, int, int]:
    if s.dim() != 2 or coeffs.dim() != 2:
        raise ValueError(f"s must be (A, N) and coeffs (K, M); got "
                         f"{tuple(s.shape)} and {tuple(coeffs.shape)}")
    a, n = s.shape
    k, m = coeffs.shape
    dev = s.device
    _require(s, "s", (a, n), torch.float32, dev)
    _require(env, "env", (a, n, 4), torch.float32, dev)
    _require(coeffs, "coeffs", (k, m), torch.float32, dev)
    _require(counts, "counts", (a,), torch.int32, dev)
    if dev.type == "cuda" and not (1 <= k and 1 <= m <= 256):
        raise ValueError(f"dp_fused kernels take 1 <= K and M <= 256; got "
                         f"K={k}, M={m}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"dp_fused runs on cuda or cpu tensors, not {dev}")
    return a, n, k, m


def kernel_cost(live: float, a: int, n: int, k: int, m: int
                ) -> Dict[str, Tuple[float, float]]:
    """(bytes, FP32 operations) of each kernel's work on (A, N) rows with
    ``live`` live slots in all, K Chebyshev terms and M columns: each input
    byte read once (live slots only), each output byte written once, and
    the operations of the factored algorithm. Forward: 8K (env^T B) + 3K
    (the recurrence) per live slot, 8KM (S C) per atom. Backward: ~24K per
    live slot (both recurrences, B D, B' D, env . B'D), 8KM (C dT^T) per
    atom; it writes every slot of ds and denv (zeros past the counts)."""
    read = live * 20 + k * m * 4 + a * 4
    return {
        "dp_fused_fwd": (read + a * 4 * m * 4, live * 11 * k + a * 8 * k * m),
        "dp_fused_bwd": (read + a * 4 * m * 4 + a * n * 20,
                         live * 24 * k + a * 8 * k * m),
    }


# read by the registered FLOP formulas, which take only the op's arguments:
# a dry run states the share around its trace with live_fraction
_live_share = 1.0


@contextlib.contextmanager
def live_fraction(share: float) -> Iterator[None]:
    """Count ``share`` of every row's slots as live in the FLOP formula
    while the block runs (a dry run's expected neighbours over N)."""
    global _live_share
    old, _live_share = _live_share, float(share)
    try:
        yield
    finally:
        _live_share = old


def _launch_fwd(s, env, coeffs, counts, lower, upper):
    a, n = s.shape
    k, m = coeffs.shape
    kl = build.load()
    out = torch.empty((a, 4, m), dtype=torch.float32, device=s.device)
    if a == 0:
        return out
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        code = kl.lib.dp_fused_fwd(
            s.data_ptr(), env.data_ptr(), coeffs.data_ptr(),
            counts.data_ptr(), out.data_ptr(), a, n, k, m, float(lower),
            float(upper), stream)
    kl.check(code, "dp_fused_fwd launch")
    _count("fwd")
    return out


def _launch_bwd(s, env, coeffs, counts, dt, lower, upper):
    a, n = s.shape
    k, m = coeffs.shape
    kl = build.load()
    ds = torch.empty((a, n), dtype=torch.float32, device=s.device)
    denv = torch.empty((a, n, 4), dtype=torch.float32, device=s.device)
    if a == 0:
        return ds, denv
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        code = kl.lib.dp_fused_bwd(
            s.data_ptr(), env.data_ptr(), coeffs.data_ptr(),
            counts.data_ptr(), dt.data_ptr(), ds.data_ptr(), denv.data_ptr(),
            a, n, k, m, float(lower), float(upper), stream)
    kl.check(code, "dp_fused_bwd launch")
    _count("bwd")
    return ds, denv


@torch.library.custom_op(
    "repro_torch::dp_fused_fwd", mutates_args=(),
    schema="(Tensor s, Tensor env, Tensor coeffs, Tensor counts, "
           "float lower, float upper) -> Tensor")
def _fwd_op(s, env, coeffs, counts, lower, upper):
    if s.device.type == "cpu":
        return ref.fused_fwd_ref(s, env, coeffs, counts, lower, upper)
    return _launch_fwd(s, env, coeffs, counts, lower, upper)


@_fwd_op.register_fake
def _(s, env, coeffs, counts, lower, upper):
    return s.new_empty((s.shape[0], 4, coeffs.shape[1]))


@torch.library.custom_op(
    "repro_torch::dp_fused_bwd", mutates_args=(),
    schema="(Tensor s, Tensor env, Tensor coeffs, Tensor counts, Tensor dt, "
           "float lower, float upper) -> (Tensor, Tensor)")
def _bwd_op(s, env, coeffs, counts, dt, lower, upper):
    if s.device.type == "cpu":
        return ref.fused_bwd_ref(s, env, coeffs, counts, dt, lower, upper)
    return _launch_bwd(s, env, coeffs, counts, dt, lower, upper)


@_bwd_op.register_fake
def _(s, env, coeffs, counts, dt, lower, upper):
    return s.new_empty(s.shape), s.new_empty((*s.shape, 4))


def _formula_flops(name: str, s_shape, coeffs_shape) -> int:
    a, n = s_shape
    k, m = coeffs_shape
    return int(kernel_cost(_live_share * a * n, a, n, k, m)[name][1])


@register_flop_formula(torch.ops.repro_torch.dp_fused_fwd)
def _fwd_flops(s_shape, env_shape, coeffs_shape, counts_shape, lower, upper,
               *args, out_shape=None, **kwargs) -> int:
    return _formula_flops("dp_fused_fwd", s_shape, coeffs_shape)


@register_flop_formula(torch.ops.repro_torch.dp_fused_bwd)
def _bwd_flops(s_shape, env_shape, coeffs_shape, counts_shape, dt_shape,
               lower, upper, *args, out_shape=None, **kwargs) -> int:
    return _formula_flops("dp_fused_bwd", s_shape, coeffs_shape)


def fused_fwd(s: torch.Tensor, env: torch.Tensor, coeffs: torch.Tensor,
              counts: torch.Tensor, lower: float, upper: float
              ) -> torch.Tensor:
    """T (A, 4, M) from s (A, N), env (A, N, 4), C (K, M), counts (A,)."""
    _check_inputs(s, env, coeffs, counts)
    return torch.ops.repro_torch.dp_fused_fwd(s, env, coeffs, counts,
                                              float(lower), float(upper))


def fused_bwd(s: torch.Tensor, env: torch.Tensor, coeffs: torch.Tensor,
              counts: torch.Tensor, dt: torch.Tensor, lower: float,
              upper: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """ds (A, N) and denv (A, N, 4) from dT (A, 4, M); zero past counts."""
    a, n, k, m = _check_inputs(s, env, coeffs, counts)
    _require(dt, "dt", (a, 4, m), torch.float32, s.device)
    return torch.ops.repro_torch.dp_fused_bwd(s, env, coeffs, counts, dt,
                                              float(lower), float(upper))


class FusedEnvTabContract(torch.autograd.Function):
    """T = R~^T G on (A, N) rows; backward through ``fused_bwd``."""

    @staticmethod
    def forward(ctx, env, s, coeffs, lower, upper):
        counts = live_counts(s)
        ctx.save_for_backward(env, s, coeffs, counts)
        ctx.bounds = (lower, upper)
        return fused_fwd(s, env, coeffs, counts, lower, upper)

    @staticmethod
    def backward(ctx, dt):
        env, s, coeffs, counts = ctx.saved_tensors
        ds, denv = fused_bwd(s, env, coeffs, counts, dt.contiguous(),
                             *ctx.bounds)
        return denv, ds, None, None, None


def fused_env_tab_contract(env: torch.Tensor, s: torch.Tensor,
                           coeffs: torch.Tensor, lower: float, upper: float
                           ) -> torch.Tensor:
    """T = R~^T G, G tabulated on the fly (never materialized on the card).

    env: (..., N, 4); s: (..., N); coeffs: (K, M). Returns (..., 4, M).
    Leading batch dims are flattened into the atom axis; a strided view
    (a neighbour-type section of a wider list) is copied to a contiguous
    one first, since the kernels take dense rows only.
    """
    batch_shape = s.shape[:-1]
    n = s.shape[-1]
    env2 = env.reshape(-1, n, 4).contiguous()
    s2 = s.reshape(-1, n).contiguous()
    out = FusedEnvTabContract.apply(env2, s2, coeffs.detach().contiguous(),
                                    float(lower), float(upper))
    return out.reshape(*batch_shape, 4, coeffs.shape[1])
