"""Model tabulation (paper Sec. 3.2) — compressing the embedding net.

Two compressions of the scalar->R^M embedding map g:

1. ``quintic`` — the paper's table: the domain is split into uniform
   intervals; in each interval g is replaced by M fifth-order polynomials
   whose value, first and second derivative match g at both interval nodes
   (quintic Hermite). g' and g'' come from nested forward-mode derivatives
   (``torch.func.jvp``). Evaluation gathers one coefficient row per Horner
   step, so the (..., 6, M) block of all six never exists at once.
2. ``cheb`` — one global Chebyshev expansion per output channel,
   g(x) ~ sum_k C[k,:] T_k(u(x)). Evaluation is the basis recurrence plus
   one (batch,K)x(K,M) product, which the fused kernel
   (``repro_torch.kernels.dp_fused``) combines with the descriptor
   contraction.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

# Monomial coefficients (in normalized u = t/h) of the six quintic Hermite
# basis polynomials: rows map [f0, h f0', h^2 f0'', f1, h f1', h^2 f1''] to
# [u^0 .. u^5].
_HERMITE5 = np.array(
    [
        # 1    u    u^2   u^3    u^4    u^5
        [1.0, 0.0, 0.0, -10.0, 15.0, -6.0],   # H0 (f0)
        [0.0, 1.0, 0.0, -6.0, 8.0, -3.0],     # H1 (h f0')
        [0.0, 0.0, 0.5, -1.5, 1.5, -0.5],     # H2 (h^2 f0'')
        [0.0, 0.0, 0.0, 10.0, -15.0, 6.0],    # H3 (f1)
        [0.0, 0.0, 0.0, -4.0, 7.0, -3.0],     # H4 (h f1')
        [0.0, 0.0, 0.0, 0.5, -1.0, 0.5],      # H5 (h^2 f1'')
    ]
)


def _value_and_derivs(g: Callable[[torch.Tensor], torch.Tensor],
                      x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g, g', g'' at scalar nodes x (n,) -> three (n, M) tensors.

    g acts on each node independently, so a jvp along a tangent of ones
    gives every node's own derivative; nesting it gives g''.
    """
    ones = torch.ones_like(x)

    def g1(xi):
        return torch.func.jvp(g, (xi,), (ones,))[1]

    v = g(x)
    d1 = g1(x)
    d2 = torch.func.jvp(g1, (x,), (ones,))[1]
    return v, d1, d2


def build_quintic_table(g: Callable[[torch.Tensor], torch.Tensor],
                        lower: float, upper: float, step: float,
                        device: torch.device) -> Dict[str, object]:
    """Tabulate g over [lower, upper] with interval ``step``.

    Returns {"coeffs": (n_intervals, 6, M) monomial coefficients in the
    local coordinate t = x - x_node, "lower", "step"}. The nodes are
    ``lower + step * k`` in float32, as the reference forms them.
    """
    n = int(np.ceil((upper - lower) / step))
    nodes = lower + step * torch.arange(n + 1, dtype=torch.float32,
                                        device=device)
    v, d1, d2 = _value_and_derivs(g, nodes)
    h = torch.tensor(step, dtype=v.dtype, device=device)
    # (n, 6, M): [f0, h f0', h^2 f0'', f1, h f1', h^2 f1''] per interval.
    herm = torch.stack([v[:-1], h * d1[:-1], h * h * d2[:-1],
                        v[1:], h * d1[1:], h * h * d2[1:]], dim=1)
    basis = torch.as_tensor(_HERMITE5, dtype=v.dtype, device=device)
    coeff_u = torch.einsum("nhm,hk->nkm", herm, basis)    # monomials in u
    # u = t/h monomials to t monomials: c_t[k] = c_u[k] / h^k.
    scale = h ** torch.arange(6, dtype=v.dtype, device=device)
    coeffs = coeff_u / scale[None, :, None]
    return {"coeffs": coeffs, "lower": float(lower), "step": float(step)}


def quintic_eval(table: Dict[str, object], x: torch.Tensor) -> torch.Tensor:
    """Evaluate the quintic table at x (...,) -> (..., M).

    Out-of-domain inputs are clamped to the boundary. Each Horner step
    gathers its own coefficient row (..., M) from the (n, M) slice of that
    power: the arithmetic and its order are the reference's, without its
    (..., 6, M) gather.
    """
    coeffs = table["coeffs"]
    n = coeffs.shape[0]
    lower, step = table["lower"], table["step"]
    xc = torch.clamp(x, lower, lower + step * n - 1e-9)
    idx = torch.clamp(((xc - lower) / step).to(torch.int64), 0, n - 1)
    t = (xc - (lower + idx.to(x.dtype) * step)).to(coeffs.dtype)[..., None]

    def row(k):
        return coeffs[:, k][idx]                              # (..., M)

    acc = row(5)
    for k in (4, 3, 2, 1, 0):
        acc = acc * t + row(k)
    return acc


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
