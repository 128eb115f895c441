"""Plain PyTorch versions of the fused tabulation + contraction kernels.

``fused_env_tab_contract_ref`` is the differentiable oracle; it materialises
G = ChebBasis(s) @ C. ``fused_fwd_ref`` and ``fused_bwd_ref`` state the two
CUDA kernels' exact contracts, including the per-atom live counts: slots
at or past ``counts[a]`` are never read and get zero gradients.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import tabulation


def fused_env_tab_contract_ref(env: torch.Tensor, s: torch.Tensor,
                               coeffs: torch.Tensor, lower: float,
                               upper: float) -> torch.Tensor:
    """T = R~^T G with G = ChebBasis(s) @ C.

    env: (..., N, 4); s: (..., N); coeffs: (K, M). Returns (..., 4, M).
    """
    table = {"coeffs": coeffs, "lower": lower, "upper": upper}
    g = tabulation.cheb_eval(table, s)                      # (..., N, M)
    return torch.einsum("...na,...nm->...am", env, g)


def cheb_basis_pair(u: torch.Tensor, order: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """T_k(u) and T_k'(u) for k < order, stacked on the last axis."""
    ts = [torch.ones_like(u), u]
    ds = [torch.zeros_like(u), torch.ones_like(u)]
    for _ in range(order - 2):
        ds.append(2.0 * ts[-1] + 2.0 * u * ds[-1] - ds[-2])
        ts.append(2.0 * u * ts[-1] - ts[-2])
    return torch.stack(ts[:order], dim=-1), torch.stack(ds[:order], dim=-1)


def _u_of_s(s: torch.Tensor, lower: float, upper: float):
    u_raw = (2.0 * s - lower - upper) / (upper - lower)
    return torch.clamp(u_raw, -1.0, 1.0), u_raw


def _live(s: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    slot = torch.arange(s.shape[-1], device=s.device)
    return slot[None, :] < counts[:, None].to(slot.dtype)


def fused_fwd_ref(s: torch.Tensor, env: torch.Tensor, coeffs: torch.Tensor,
                  counts: torch.Tensor, lower: float, upper: float
                  ) -> torch.Tensor:
    """Forward kernel contract: s (A,N), env (A,N,4), C (K,M), counts (A,)
    -> T (A,4,M), summing only slots n < counts[a]."""
    live = _live(s, counts)
    s = torch.where(live, s, 0.0)
    env = torch.where(live[..., None], env, 0.0)
    return fused_env_tab_contract_ref(env, s, coeffs, lower, upper)


def fused_bwd_ref(s: torch.Tensor, env: torch.Tensor, coeffs: torch.Tensor,
                  counts: torch.Tensor, dt: torch.Tensor, lower: float,
                  upper: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward kernel contract: given dT (A,4,M) return ds (A,N) and
    denv (A,N,4); both are zero at slots n >= counts[a].

    denv = G dT^T; ds = sum_m (env dT)_m G'_m 2/(hi-lo) [|u_raw| < 1].
    """
    live = _live(s, counts)
    s = torch.where(live, s, 0.0)
    env = torch.where(live[..., None], env, 0.0)
    u, u_raw = _u_of_s(s, lower, upper)
    basis, dbasis = cheb_basis_pair(u, coeffs.shape[0])
    g = basis @ coeffs                                         # (A, N, M)
    gp = dbasis @ coeffs
    denv = torch.einsum("anm,acm->anc", g, dt)
    w = torch.einsum("anc,acm->anm", env, dt)
    in_dom = (u_raw.abs() < 1.0).to(s.dtype)
    ds = (w * gp).sum(-1) * (2.0 / (upper - lower)) * in_dom
    return (torch.where(live, ds, 0.0),
            torch.where(live[..., None], denv, 0.0))
