"""Model tabulation (paper Sec. 3.2) — compressing the embedding net.

The ``cheb`` compression: one global Chebyshev expansion per output channel,
g(x) ~ sum_k C[k,:] T_k(u(x)). Evaluation is the basis recurrence plus one
(batch,K)x(K,M) product, which the fused kernel
(``repro_torch.kernels.dp_fused``) combines with the descriptor contraction.

The paper's quintic table is not ported yet (ROADMAP.md §A.7): its builder
needs g' and g'' through forward-mode derivatives.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def build_cheb_table(g: Callable[[torch.Tensor], torch.Tensor], lower: float,
                     upper: float, order: int, device: torch.device
                     ) -> Dict[str, object]:
    """Chebyshev interpolation of g on [lower, upper] with K = order terms.

    The nodes and the cosine matrix are formed in float64 on the host and
    rounded to float32 once, as the reference does. Returns
    {"coeffs": (K, M), "lower", "upper"}.
    """
    k = np.arange(order)
    theta = np.pi * (k + 0.5) / order
    xk = 0.5 * (lower + upper) + 0.5 * (upper - lower) * np.cos(theta)
    v = g(torch.as_tensor(xk, dtype=torch.float32, device=device))   # (K, M)
    # c_j = (2/K) sum_k v_k cos(j theta_k); c_0 halved.
    cos_mat = torch.as_tensor(np.cos(np.outer(k, theta)), dtype=v.dtype,
                              device=device)
    c = ((2.0 / order) * cos_mat) @ v
    c[0] *= 0.5
    return {"coeffs": c, "lower": float(lower), "upper": float(upper)}


def cheb_basis(u: torch.Tensor, order: int) -> torch.Tensor:
    """T_0..T_{K-1} at u in [-1, 1]: (...,) -> (..., K) via the recurrence."""
    cols = [torch.ones_like(u), u]
    for _ in range(order - 2):
        cols.append(2.0 * u * cols[-1] - cols[-2])
    return torch.stack(cols[:order], dim=-1)


def cheb_eval(table: Dict[str, object], x: torch.Tensor) -> torch.Tensor:
    """Evaluate the Chebyshev table at x (...,) -> (..., M)."""
    c = table["coeffs"]
    order = c.shape[0]
    lower, upper = table["lower"], table["upper"]
    u = torch.clamp((2.0 * x - lower - upper) / (upper - lower), -1.0, 1.0)
    return cheb_basis(u.to(c.dtype), order) @ c
