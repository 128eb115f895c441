"""Plain PyTorch Deep Potential (se_e2_a) energies and forces.

The reference the benchmark holds the port against. It follows the paper
(Guo et al., arXiv:2201.01446, Sec. 2-3) and DeePMD-kit's se_e2_a
convention, written from the equations, not from the port:

  s(r)  = w(r) / r, w = 1 below rcut_smth, u^3 (-6 u^2 + 15 u - 10) + 1 up
          to rcut, 0 beyond;  R~ row = s (1, x/r, y/r, z/r) / dstd[center]
  G     = g_t(s / dstd[center, 0]), g_t the embedding net of the neighbour's
          type, here through its Chebyshev table of K terms on [lower, upper]
          (the table is built here again from the embedding weights)
  T     = R~^T G / N_m  (N_m: the configuration's total neighbour capacity)
  D     = (T[:, :M<])^T T, flattened;  E_i = fit[type_i](D) + ebias[type_i]
  F     = -dE/dx by autograd through the pair vectors

T is formed as (R~^T B) C, with B the Chebyshev basis and C the table's
coefficients: the same sum as R~^T (B C) in another order, without the
(pairs, M) matrix G. Work runs in blocks of atoms, so 155,520 atoms fit.

Precision: ``"float32"`` with TF32 off (the configuration's precision), or
``"tf32"``, the control one step below it: matmuls in TF32 on a card, and on
the CPU, which has no TF32, with every matmul input rounded to TF32's 10-bit
mantissa. Nothing here imports the port.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, to nearest even.
    The gradient passes straight through."""
    i = x.detach().contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    i = torch.bitwise_and(i + 0xFFF + lsb, ~0x1FFF)
    return x + (i.view(torch.float32) - x.detach())


class DPReference:
    """Energies and forces of one DP model, from its raw weights.

    ``cfg``: the configuration file's fields; ``weights``: the raw weight
    dict (``embed``, ``fit``, ``dstd``, ``ebias``) that the benchmark made
    and handed to the port as well.
    """

    def __init__(self, cfg: Dict, weights: Dict, device: torch.device,
                 precision: str = "float32", block_atoms: int = 4096):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.cfg = cfg
        self.dev = torch.device(device)
        self.precision = precision
        self.block_atoms = int(block_atoms)
        self.rcut = float(cfg["rcut"])
        self.rcut_smth = float(cfg["rcut_smth"])
        self.nsel = int(sum(cfg["sel"]))
        self.axis = int(cfg["axis_neuron"])
        self.lower = float(cfg["table_lower"])
        self.upper = float(cfg["table_upper"])
        self.order = int(cfg["cheb_order"])
        self.ntypes = int(cfg["ntypes"])
        if not cfg.get("type_one_side", True):
            raise ValueError("the reference covers type_one_side models")

        def own(t):
            return t.detach().to(device=self.dev, dtype=torch.float32).clone()

        self.embed = {k: [{n: own(v) for n, v in lyr.items()} for lyr in net]
                      for k, net in weights["embed"].items()}
        self.fit = {k: {"hidden": [{n: own(v) for n, v in lyr.items()}
                                   for lyr in net["hidden"]],
                        "head": {n: own(v) for n, v in net["head"].items()}}
                    for k, net in weights["fit"].items()}
        self.dstd = own(weights["dstd"])
        self.ebias = own(weights["ebias"])
        self.coeffs = [self._cheb_table(self.embed[str(t)])
                       for t in range(self.ntypes)]

    # ------------------------------------------------------------ pieces

    @contextlib.contextmanager
    def _matmul_mode(self):
        if self.dev.type != "cuda":
            yield
            return
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.precision == "tf32"
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32" and self.dev.type != "cuda":
            a, b = round_tf32(a), round_tf32(b)
        return torch.matmul(a, b)

    def _mlp(self, layers: List[Dict[str, torch.Tensor]], h: torch.Tensor
             ) -> torch.Tensor:
        """DeePMD's residual tanh MLP: identity shortcut where the width
        repeats, (h, h) where it doubles, none otherwise."""
        for lyr in layers:
            d_in, d_out = lyr["w"].shape
            y = torch.tanh(self._mm(h, lyr["w"]) + lyr["b"])
            if d_out == d_in:
                h = h + y
            elif d_out == 2 * d_in:
                h = torch.cat([h, h], dim=-1) + y
            else:
                h = y
        return h

    def _cheb_table(self, net) -> torch.Tensor:
        """(K, M) Chebyshev coefficients of the embedding net g on
        [lower, upper]: g at the K Chebyshev nodes, then the discrete
        cosine sums, in float64."""
        k = np.arange(self.order)
        theta = np.pi * (k + 0.5) / self.order
        nodes = 0.5 * (self.lower + self.upper) \
            + 0.5 * (self.upper - self.lower) * np.cos(theta)
        with torch.no_grad(), self._matmul_mode():
            g = self._mlp(net, torch.as_tensor(nodes, dtype=torch.float32,
                                               device=self.dev)[:, None])
        g = g.double().cpu().numpy()
        c = (2.0 / self.order) * np.cos(np.outer(k, theta)) @ g
        c[0] *= 0.5
        return torch.as_tensor(c, dtype=torch.float32, device=self.dev)

    def _basis(self, x: torch.Tensor) -> torch.Tensor:
        """T_0..T_{K-1} at the clamped, mapped table input."""
        u = torch.clamp((2.0 * x - self.lower - self.upper)
                        / (self.upper - self.lower), -1.0, 1.0)
        cols = [torch.ones_like(u), u]
        for _ in range(self.order - 2):
            cols.append(2.0 * u * cols[-1] - cols[-2])
        return torch.stack(cols[:self.order], dim=-1)

    def atomic_energy(self, rij: torch.Tensor, valid: torch.Tensor,
                      typ_i: torch.Tensor, typ_j: torch.Tensor
                      ) -> torch.Tensor:
        """E_i (B,) of B centres from their pair vectors rij (B, P, 3)."""
        r2 = torch.sum(rij * rij, dim=-1)
        live = valid & (r2 < self.rcut * self.rcut)
        r = torch.sqrt(torch.where(live, r2, 1.0))
        u = torch.clamp((r - self.rcut_smth) / (self.rcut - self.rcut_smth),
                        0.0, 1.0)
        w = u * u * u * (-6.0 * u * u + 15.0 * u - 10.0) + 1.0
        s = torch.where(live, w / r, 0.0)
        scale = self.dstd[typ_i]                                  # (B, 4)
        env = torch.cat([s[..., None], (s / r)[..., None] * rij], dim=-1) \
            / scale[:, None, :]
        basis = self._basis(s / scale[:, None, 0])                # (B, P, K)
        env_t = env.transpose(1, 2)                               # (B, 4, P)
        t_mat = None
        for t in range(self.ntypes):
            env_tt = env_t if self.ntypes == 1 else \
                env_t * (typ_j == t)[:, None, :].to(env.dtype)
            part = self._mm(self._mm(env_tt, basis), self.coeffs[t])
            t_mat = part if t_mat is None else t_mat + part
        t_mat = t_mat / float(self.nsel)                          # (B, 4, M)
        t_sub = t_mat[:, :, :self.axis]
        d = self._mm(t_sub.transpose(1, 2), t_mat).reshape(t_mat.shape[0], -1)
        e = torch.zeros(d.shape[0], dtype=d.dtype, device=d.device)
        for t in range(self.ntypes):
            rows = torch.nonzero(typ_i == t).reshape(-1) if self.ntypes > 1 \
                else None
            net = self.fit[str(t)]
            d_t = d if rows is None else d[rows]
            h = self._mlp(net["hidden"], d_t)
            e_t = (self._mm(h, net["head"]["w"]) + net["head"]["b"])[:, 0]
            e_t = e_t + self.ebias[t]
            e = e_t if rows is None else e.index_put((rows,), e_t)
        return e

    # ------------------------------------------------------------ public

    def energy_forces(self, pos: torch.Tensor, typ: torch.Tensor,
                      box: torch.Tensor, nbr: torch.Tensor,
                      forces: bool = True
                      ) -> Tuple[float, Optional[torch.Tensor]]:
        """Total energy (a float, summed in float64) and forces (N, 3) of
        positions ``pos`` (N, 3) under the minimum image of ``box`` (3,),
        from the padded neighbour table ``nbr`` (N, P) (-1 past each row's
        neighbours; any superset of the pairs within rcut)."""
        n = pos.shape[0]
        force = torch.zeros_like(pos) if forces else None
        total = torch.zeros((), dtype=torch.float64, device=pos.device)
        with self._matmul_mode():
            for a0 in range(0, n, self.block_atoms):
                a1 = min(n, a0 + self.block_atoms)
                idx = nbr[a0:a1]
                valid = idx >= 0
                j = torch.clamp(idx, min=0)
                with torch.no_grad():
                    rij = pos[j] - pos[a0:a1, None, :]
                    rij = rij - box * torch.round(rij / box)
                    rij = torch.where(valid[..., None], rij, 0.0)
                if forces:
                    with torch.enable_grad():
                        rij.requires_grad_(True)
                        e = self.atomic_energy(rij, valid, typ[a0:a1], typ[j])
                        (g,) = torch.autograd.grad(e.sum(), rij)
                    g = torch.where(valid[..., None], g, 0.0)
                    force.index_add_(0, j.reshape(-1), -g.reshape(-1, 3))
                    force[a0:a1] += g.sum(dim=1)
                else:
                    with torch.no_grad():
                        e = self.atomic_energy(rij, valid, typ[a0:a1], typ[j])
                total += e.detach().double().sum()
        return float(total), force


def pair_counts(pos: torch.Tensor, typ: torch.Tensor, box: torch.Tensor,
                nbr: torch.Tensor, rcut: float, ntypes: int) -> List[int]:
    """Pairs (i, j) with |r_ij| < rcut, by the neighbour's type: the live
    slots that the work needs."""
    out = [0] * ntypes
    for a0 in range(0, pos.shape[0], 8192):
        idx = nbr[a0:a0 + 8192]
        valid = idx >= 0
        j = torch.clamp(idx, min=0)
        rij = pos[j] - pos[a0:a0 + 8192, None, :]
        rij = rij - box * torch.round(rij / box)
        live = valid & (torch.sum(rij * rij, dim=-1) < rcut * rcut)
        for t in range(ntypes):
            out[t] += int((live & (typ[j] == t)).sum())
    return out


def neighbor_table(pos: torch.Tensor, box: torch.Tensor, rc: float,
                   block: int = 1024) -> torch.Tensor:
    """(N, P) indices of every atom within ``rc`` of each atom (minimum
    image; the box must be at least 2 rc wide), -1 past each row's count.
    Brute force over all pairs, a block of rows at a time."""
    n = pos.shape[0]
    if bool(torch.any(box < 2.0 * rc)):
        raise ValueError(f"box {box.tolist()} narrower than 2 x {rc} A")
    rows: List[torch.Tensor] = []
    cols: List[torch.Tensor] = []
    rc2 = rc * rc
    ar = torch.arange(n, device=pos.device)
    for a0 in range(0, n, block):
        a1 = min(n, a0 + block)
        d2 = torch.zeros((a1 - a0, n), dtype=pos.dtype, device=pos.device)
        for a in range(3):
            d = pos[None, :, a] - pos[a0:a1, None, a]
            d = d - box[a] * torch.round(d / box[a])
            d2 += d * d
        hit = d2 < rc2
        hit[torch.arange(a1 - a0, device=pos.device), ar[a0:a1]] = False
        r, c = torch.nonzero(hit, as_tuple=True)
        rows.append(r + a0)
        cols.append(c)
    r = torch.cat(rows)
    c = torch.cat(cols)
    counts = torch.bincount(r, minlength=n)
    width = int(counts.max()) if n else 0
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(r.shape[0], device=pos.device) - start[r]
    table = torch.full((n, max(width, 1)), -1, dtype=torch.int64,
                       device=pos.device)
    table[r, slot] = c
    return table

