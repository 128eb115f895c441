"""The benchmark's own yardsticks: the card's peaks, and the operations and
bytes of the two fused kernels and of the force-and-virial reduction. The
operations of one whole force evaluation depend on the model family and
live with it (``reference/<family>.py``: ``force_eval_flops``).

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


def bound_s(nbytes: float, ops: float) -> Tuple[float, str]:
    """Least seconds of a kernel's work: the larger of its bytes over HBM
    bandwidth and its operations over the float32 peak, and which."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, ops / PEAK_FP32_FLOPS
    return max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def kernel_bound_s(live: float, a: int, n: int, k: int, m: int
                   ) -> Dict[str, Tuple[float, str]]:
    """:func:`bound_s` of each fused kernel's work."""
    return {name: bound_s(b, f)
            for name, (b, f) in kernel_cost(live, a, n, k, m).items()}


def force_virial_cost(live: float, filled: float, a: int, sections: int,
                      rows: int) -> Tuple[float, float]:
    """(bytes, FP32 operations) of the force-and-virial reduction
    (``prod_force_virial`` and its finishing pass) on ``a`` centres with
    ``sections`` neighbour sections, ``filled`` filled slots and ``live``
    live slots in all, and ``rows`` rows of forces.

    Bytes, each read or written once, as ``kernel_cost`` counts live slots
    only: the nlist of the filled slots and one -1 a section that ends
    them (8 B each, int64; a lane may stop at a section's first -1, so
    padding past it is no work), dE/dr_ij and r_ij of the live slots
    (24 B a live slot), the forces written (12 B a row). Operations: per
    live slot its action and reaction (6) and its nine virial products
    (18)."""
    return (filled + a * sections) * 8 + live * 24 + rows * 12, live * 24


def force_virial_bound_s(live: float, filled: float, a: int, sections: int,
                         rows: int) -> Tuple[float, str]:
    """:func:`bound_s` of the reduction's work."""
    return bound_s(*force_virial_cost(live, filled, a, sections, rows))


def mlp_flops(widths: Sequence[int], d_in: int) -> float:
    """Multiply-adds x 2 of a chain of dense layers (bias, tanh and the
    residual adds are left out)."""
    total, prev = 0.0, d_in
    for w in widths:
        total += 2.0 * prev * int(w)
        prev = int(w)
    return total
