"""The benchmark's own yardsticks: the card's peaks, the operations and bytes
of the two fused kernels, and the operations of one DP force evaluation.

Frozen here so that a change to the port cannot move them. Peaks: NVIDIA's
H100 SXM data sheet at the 700 W limit, dense, float32 outside the tensor
cores (the port runs with TF32 off), HBM3 bandwidth.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def kernel_cost(live: float, a: int, n: int, k: int, m: int
                ) -> Dict[str, Tuple[float, float]]:
    """(bytes, FP32 operations) of each fused kernel's work on (A, N) slot
    rows with ``live`` live slots in all, K Chebyshev terms, M columns.

    Bytes: each input byte read once, live slots only (s and the 4-wide
    environment row: 20 B a slot), the (K, M) table and the (A,) counts;
    each output byte written once: T (A, 4, M) forward; backward also reads
    dT (A, 4, M) and writes ds and denv for every slot (A N 20 B).
    Operations, of the factored algorithm T = (env^T B) C: forward 11 K a
    live slot (the recurrence, 3 K; env^T B, 8 K) and 8 K M an atom; backward
    24 K a live slot (both recurrences, B dS, B' dS, the env products) and
    8 K M an atom (C dT^T).
    """
    read = live * 20 + k * m * 4 + a * 4
    return {
        "dp_fused_fwd": (read + a * 4 * m * 4, live * 11 * k + a * 8 * k * m),
        "dp_fused_bwd": (read + a * 4 * m * 4 + a * n * 20,
                         live * 24 * k + a * 8 * k * m),
    }


def kernel_bound_s(live: float, a: int, n: int, k: int, m: int
                   ) -> Dict[str, Tuple[float, str]]:
    """Least seconds of each kernel's work: the larger of its bytes over
    HBM bandwidth and its operations over the float32 peak, and which."""
    out = {}
    for name, (b, f) in kernel_cost(live, a, n, k, m).items():
        t_b, t_f = b / HBM_BYTES_PER_S, f / PEAK_FP32_FLOPS
        out[name] = (max(t_b, t_f), "bytes" if t_b >= t_f else "operations")
    return out


def mlp_flops(widths: Sequence[int], d_in: int) -> float:
    """Multiply-adds x 2 of a chain of dense layers (bias, tanh and the
    residual adds are left out)."""
    total, prev = 0.0, d_in
    for w in widths:
        total += 2.0 * prev * int(w)
        prev = int(w)
    return total


def force_eval_flops(cfg: Dict, atoms: int, live_pairs: float) -> float:
    """FP32 operations of one DP energy-and-forces evaluation of ``atoms``
    atoms with ``live_pairs`` pairs within rcut, forward and backward, by the
    least-work algorithm: per live pair the environment row and switch
    (30 forward, 60 backward) and the fused kernels' per-slot work; per atom
    the kernels' 8 K M, the descriptor (4 x M< x M multiply-adds) and the
    fitting net (2048 -> 240 -> 240 -> 240 -> 1). A backward layer of the
    force (input gradients only) costs what its forward does."""
    k = int(cfg["cheb_order"])
    m = int(cfg["embed_widths"][-1])
    axis = int(cfg["axis_neuron"])
    fit = mlp_flops(list(cfg["fit_widths"]) + [1], axis * m)
    per_atom_fwd = 8.0 * k * m + 2.0 * 4 * axis * m + fit
    per_atom_bwd = 8.0 * k * m + 2.0 * 2.0 * 4 * axis * m + fit
    per_pair = 30.0 + 11.0 * k + 60.0 + 24.0 * k
    return atoms * (per_atom_fwd + per_atom_bwd) + live_pairs * per_pair
