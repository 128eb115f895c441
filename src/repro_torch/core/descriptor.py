"""Environment matrix and symmetry-preserving descriptor (paper Sec. 2.1).

The environment matrix R~_i (paper Eq. 1) is built from relative neighbor
positions r_ij; its first column s(r_ij) feeds the embedding net; the
descriptor is D_i = (G<)^T R~ R~^T G (paper Eq. 2), evaluated through the
key intermediate T_i = R~_i^T G_i (4 x M) — the quantity the fused kernel
produces without materializing G_i.

Padding convention: invalid neighbor slots have R~ rows identically zero
(the normalization is centered so this holds exactly), hence their
contribution to T is exactly zero and skipping them is mathematically
exact — the invariant the fused kernel's per-atom slot skip relies on.
"""

from __future__ import annotations

from typing import Tuple

import torch


def switching_s(r: torch.Tensor, rcut_smth: float, rcut: float) -> torch.Tensor:
    """s(r) = w(r)/r, the smoothly gated inverse distance (paper Eq. 1).

    w(r) = 1 for r < rcut_smth, 0 for r > rcut, and the C^2 quintic ramp
    u^3(-6u^2 + 15u - 10) + 1 in between (DeePMD se_e2_a convention).
    """
    u = (r - rcut_smth) / (rcut - rcut_smth)
    uu = torch.clamp(u, 0.0, 1.0)
    w = uu * uu * uu * (-6.0 * uu * uu + 15.0 * uu - 10.0) + 1.0
    live = r > 1e-6
    safe_r = torch.where(live, r, 1.0)
    s = torch.where(live, w / safe_r, 0.0)
    return torch.where(r < rcut, s, 0.0)


def env_matrix(rij: torch.Tensor, nmask: torch.Tensor, rcut_smth: float,
               rcut: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Environment matrix R~ (paper Eq. 1).

    Args:
      rij: (..., Nm, 3) relative positions r_j - r_i; padded slots arbitrary.
      nmask: (..., Nm) True for real neighbors.

    Returns:
      R~: (..., Nm, 4) rows s*(1, x/r, y/r, z/r); zero rows for padding.
      s:  (..., Nm) first column (embedding-net input).
    """
    m3 = nmask[..., None]
    r = torch.linalg.vector_norm(torch.where(m3, rij, 1.0), dim=-1)
    s = switching_s(r, rcut_smth, rcut) * nmask
    safe_r = torch.where(r > 1e-6, r, 1.0)
    unit = rij / safe_r[..., None]
    env = torch.cat([s[..., None], s[..., None] * unit * m3], dim=-1)
    return env, s


def normalize_env(env: torch.Tensor, s: torch.Tensor, atype: torch.Tensor,
                  dstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale the environment matrix by per-(center-type, column) std.

    Centered statistics (davg = 0) keep padded rows exactly zero after
    normalization (see module docstring).

    dstd: (ntypes, 4) positive scale factors.
    """
    scale = dstd[atype]                       # (..., 4)
    env_n = env / scale[..., None, :]
    s_n = s / scale[..., None, 0]
    return env_n, s_n


def compute_env_stats(env: torch.Tensor, nmask: torch.Tensor,
                      atype: torch.Tensor, ntypes: int) -> torch.Tensor:
    """RMS of environment-matrix columns over real neighbors, per center type.

    Returns dstd (ntypes, 4), clipped away from zero. Radial column (0) and
    angular columns (1:4, pooled) get separate scales, matching DeePMD.
    """
    dstd = []
    for t in range(ntypes):
        sel = (atype == t)[..., None] & nmask
        w = sel[..., None].to(env.dtype)
        cnt = torch.clamp(w.sum(), min=1.0)
        ms = (env ** 2 * w).sum(dim=tuple(range(env.ndim - 1))) / cnt
        rad = torch.sqrt(ms[0])
        ang = torch.sqrt(ms[1:4].mean())
        dstd.append(torch.stack([rad, ang, ang, ang]))
    return torch.clamp(torch.stack(dstd), min=1e-2)


def descriptor_from_t(t_mat: torch.Tensor, axis_neuron: int,
                      nsel: int) -> torch.Tensor:
    """D = (T<)^T T with T = R~^T G / Nm  (paper Eq. 2, flattened).

    t_mat: (..., 4, M). Returns (..., M< * M).
    DeePMD normalizes T by the neighbor capacity; 1/Nm is folded into T here.
    """
    t_mat = t_mat / float(nsel)
    t_sub = t_mat[..., :, :axis_neuron]       # (..., 4, M<)
    d = torch.einsum("...am,...an->...mn", t_sub, t_mat)   # (..., M<, M)
    return d.reshape(*d.shape[:-2], -1)
