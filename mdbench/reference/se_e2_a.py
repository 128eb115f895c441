"""The se_e2_a model family: DeePMD-kit's smooth edition of the Deep
Potential with two-body embeddings of the full radial and angular
information, ``type_one_side`` (one embedding net per neighbour type).

  weights           the raw weights from a seed, handed to the port and
                    to the reference alike
  Reference         plain PyTorch energies and forces
  force_eval_flops  the least-work count of one force evaluation

A configuration file without a ``family`` key is of this family.

The reference the benchmark holds the port against follows the paper
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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdbench.cost import mlp_flops
from mdbench.reference.shared import round_tf32


def _layer(flat: torch.Tensor, at: int, d_in: int, d_out: int
           ) -> Tuple[Dict[str, torch.Tensor], int]:
    n_w = d_in * d_out
    w = flat[at:at + n_w].view(d_in, d_out) / float(d_in + d_out) ** 0.5
    b = flat[at + n_w:at + n_w + d_out] * 0.1
    return {"w": w, "b": b}, at + n_w + d_out


def _mlp_sizes(widths: Sequence[int], d_in: int) -> List[Tuple[int, int]]:
    sizes, prev = [], d_in
    for w in widths:
        sizes.append((prev, int(w)))
        prev = int(w)
    return sizes


def weights(cfg: Dict, seed: int, device: torch.device,
            dstd: Optional[torch.Tensor] = None) -> Dict:
    """Raw DP weights from ``seed``, drawn on ``device`` in one call: the
    DeePMD initialisation, W ~ N(0, 1) / sqrt(d_in + d_out) and
    b ~ 0.1 N(0, 1); one embedding net per neighbour type and one fitting
    net per centre type; the environment scales ``dstd`` (1 if not given)
    and the energy biases 0. The dict has the port's parameter layout."""
    ntypes = int(cfg["ntypes"])
    embed = _mlp_sizes(cfg["embed_widths"], 1)
    desc = int(cfg["axis_neuron"]) * int(cfg["embed_widths"][-1])
    fit = _mlp_sizes(cfg["fit_widths"], desc) + [(int(cfg["fit_widths"][-1]),
                                                  1)]
    per_net = sum(a * b + b for a, b in embed)
    per_fit = sum(a * b + b for a, b in fit)
    total = ntypes * (per_net + per_fit)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    at = 0
    out: Dict = {"embed": {}, "fit": {}}
    for t in range(ntypes):
        net = []
        for a, b in embed:
            lyr, at = _layer(flat, at, a, b)
            net.append(lyr)
        out["embed"][str(t)] = net
    for t in range(ntypes):
        layers = []
        for a, b in fit:
            lyr, at = _layer(flat, at, a, b)
            layers.append(lyr)
        out["fit"][str(t)] = {"hidden": layers[:-1], "head": layers[-1]}
    out["dstd"] = (torch.ones((ntypes, 4), dtype=torch.float32, device=device)
                   if dstd is None else dstd.to(device))
    out["ebias"] = torch.zeros((ntypes,), dtype=torch.float32, device=device)
    return out


class Reference:
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
