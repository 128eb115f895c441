"""The DPA-1 model family: the attention-based Deep Potential (Zhang et al.,
arXiv:2208.08236) as DeePMD-kit's ``se_atten_v2`` descriptor writes it
(``tebd_input_mode`` "strip", ``smooth_type_embedding``; the
``examples/water/se_atten`` settings), with one type-conditioned fitting net
with ``resnet_dt``.

  weights           the raw weights from a seed, handed to the port and
                    to the reference alike
  Reference         plain PyTorch energies and forces
  force_eval_flops  the least-work count of one force evaluation
  attention_cost    the bytes and operations of the attention layers alone

The reference, written from the equations and not from the port, for centre
i of type t_i and the neighbours j within rcut (its own list: the pairs of
the brute-force table within rcut, packed per block of atoms):

  w(r)  = 1 below rcut_smth, u^3 (-6 u^2 + 15 u - 10) + 1 up to rcut, 0
          beyond;  s = w / r;  R~ row = s (1, x/r, y/r, z/r) / dstd[t_i]
  tebd(t) = tanh(onehot(t) W + b)
  G0    = N_s(R~_0) (1 + w N_t([tebd(t_j), tebd(t_i)])), N_s and N_t tanh
          MLPs with DeePMD's residuals (identity where a width repeats,
          (h, h) where it doubles), N_t run on every slot
  each attention layer: q, k, v = G W_in + b_in, each divided by its norm;
          A = softmax over the live k of (q_j . k_k / sqrt(attn) + 20) w_j w_k
          - 20;  G <- LayerNorm(G + (A w_j w_k (r^_j . r^_k)) v W_out + b_out)
          (mean and biased variance over the M features, eps 1e-5, a scale
          and a shift)
  T     = R~^T G / sel;  D = (T[:, :M<])^T T, flattened
  E_i   = F([D, tebd(t_i)]) + ebias[t_i]; F: tanh layers, h + idt tanh(.)
          where the width repeats, a linear head
  F     = -dE/dx by autograd through the pair vectors

Two departures from DeePMD-kit, stated in the configuration's ``assumed``:
(1) the softmax runs over the live slots only, where DeePMD-kit's smooth
mode lets each padded slot add e^-20 to its denominator (under 1e-9 of the
sum): the energy then does not depend on how many slots there are;
(2) davg is 0 and dstd 1 (``env_scale`` "unit"): no trained statistics
exist. The weights are random (DeePMD's initialisation).

Precision: ``"float32"`` with TF32 off (the configuration's precision), or
``"tf32"``, the control one step below it: matmuls in TF32 on a card, and on
the CPU, which has no TF32, with every matmul input rounded to TF32's 10-bit
mantissa. Nothing here imports the port.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from mdbench.cost import mlp_flops
from mdbench.reference.shared import round_tf32

SHIFT = 20.0
LN_EPS = 1e-5


def _mlp_sizes(widths: Sequence[int], d_in: int) -> List[Tuple[int, int]]:
    sizes, prev = [], d_in
    for w in widths:
        sizes.append((prev, int(w)))
        prev = int(w)
    return sizes


def _shapes(cfg: Dict) -> Dict[str, List[Tuple[int, int]]]:
    m, a = int(cfg["embed_widths"][-1]), int(cfg["attn"])
    tebd = int(cfg["tebd_dim"])
    d_fit = int(cfg["axis_neuron"]) * m + tebd
    return {
        "tebd": [(int(cfg["ntypes"]), tebd)],
        "embed_s": _mlp_sizes(cfg["embed_widths"], 1),
        "embed_t": _mlp_sizes(cfg["embed_widths"], 2 * tebd),
        "attn": [(m, 3 * a), (a, m)] * int(cfg["attn_layer"]),
        "fit": _mlp_sizes(cfg["fit_widths"], d_fit)
        + [(int(cfg["fit_widths"][-1]), 1)],
    }


def weights(cfg: Dict, seed: int, device: torch.device,
            dstd: Optional[torch.Tensor] = None) -> Dict:
    """Raw DPA-1 weights from ``seed``, drawn on ``device`` in one call:
    DeePMD's initialisation, W ~ N(0, 1) / sqrt(d_in + d_out) and
    b ~ 0.1 N(0, 1); each LayerNorm's scale 1 + 0.1 N(0, 1) and shift
    0.1 N(0, 1) (a trained model's are not 1 and 0); ``idt`` 0.1 +
    0.001 N(0, 1), DeePMD's; dstd 1 where not given and the energy biases
    0. The dict has the port's parameter layout."""
    shapes = _shapes(cfg)
    m = int(cfg["embed_widths"][-1])
    n_ln = 2 * m * int(cfg["attn_layer"])
    n_idt = sum(b for a, b in shapes["fit"][1:-1] if a == b)
    total = sum(a * b + b for part in shapes.values() for a, b in part) \
        + n_ln + n_idt
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    at = 0

    def take(n):
        nonlocal at
        out = flat[at:at + n]
        at += n
        return out

    def layer(d_in, d_out):
        w = take(d_in * d_out).view(d_in, d_out) / float(d_in + d_out) ** 0.5
        return {"w": w, "b": take(d_out) * 0.1}

    out: Dict = {
        "tebd": layer(*shapes["tebd"][0]),
        "embed_s": [layer(a, b) for a, b in shapes["embed_s"]],
        "embed_t": [layer(a, b) for a, b in shapes["embed_t"]],
        "attn": [],
    }
    pairs = shapes["attn"]
    for i in range(int(cfg["attn_layer"])):
        out["attn"].append({"in": layer(*pairs[2 * i]),
                            "out": layer(*pairs[2 * i + 1]),
                            "ln": {"scale": 1.0 + 0.1 * take(m),
                                   "shift": 0.1 * take(m)}})
    hidden = [layer(a, b) for a, b in shapes["fit"][:-1]]
    for lyr in hidden[1:]:
        d_in, d_out = lyr["w"].shape
        if d_in == d_out:
            lyr["idt"] = 0.1 + 0.001 * take(d_out)
    out["fit"] = {"hidden": hidden, "head": layer(*shapes["fit"][-1])}
    ntypes = int(cfg["ntypes"])
    out["dstd"] = (torch.ones((ntypes, 4), dtype=torch.float32, device=device)
                   if dstd is None else dstd.to(device))
    out["ebias"] = torch.zeros((ntypes,), dtype=torch.float32, device=device)
    return out


class Reference:
    """Energies and forces of one DPA-1 model, from its raw weights.

    ``cfg``: the configuration file's fields; ``weights``: the raw weight
    dict that the benchmark made and handed to the port as well.
    """

    def __init__(self, cfg: Dict, weights: Dict, device: torch.device,
                 precision: str = "float32", block_atoms: int = 2048):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.dev = torch.device(device)
        self.precision = precision
        self.block_atoms = int(block_atoms)
        self.rcut = float(cfg["rcut"])
        self.rcut_smth = float(cfg["rcut_smth"])
        self.nsel = int(cfg["sel"])
        self.axis = int(cfg["axis_neuron"])
        self.ntypes = int(cfg["ntypes"])
        self.attn = int(cfg["attn"])
        if not cfg.get("attn_dotr", True):
            raise ValueError("the reference covers attn_dotr models")

        def own(tree):
            if isinstance(tree, dict):
                return {k: own(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [own(v) for v in tree]
            return tree.detach().to(device=self.dev,
                                    dtype=torch.float32).clone()

        self.w = own(weights)

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

    def _dense(self, lyr: Dict[str, torch.Tensor], h: torch.Tensor
               ) -> torch.Tensor:
        return self._mm(h, lyr["w"]) + lyr["b"]

    def _mlp(self, layers: List[Dict[str, torch.Tensor]], h: torch.Tensor
             ) -> torch.Tensor:
        """DeePMD's residual tanh MLP: identity shortcut where the width
        repeats, (h, h) where it doubles, none otherwise."""
        for lyr in layers:
            d_in, d_out = lyr["w"].shape
            y = torch.tanh(self._dense(lyr, h))
            if d_out == d_in:
                h = h + y
            elif d_out == 2 * d_in:
                h = torch.cat([h, h], dim=-1) + y
            else:
                h = y
        return h

    @staticmethod
    def _unit(x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        return x / torch.clamp(norm, min=1e-12)

    @staticmethod
    def _layer_norm(x: torch.Tensor, ln: Dict[str, torch.Tensor]
                    ) -> torch.Tensor:
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + LN_EPS) * ln["scale"] \
            + ln["shift"]

    def _tebd(self) -> torch.Tensor:
        onehot = torch.eye(self.ntypes, dtype=torch.float32, device=self.dev)
        return torch.tanh(self._dense(self.w["tebd"], onehot))

    def atomic_energy(self, rij: torch.Tensor, live: torch.Tensor,
                      typ_i: torch.Tensor, typ_j: torch.Tensor
                      ) -> torch.Tensor:
        """E_i (B,) of B centres from their pair vectors rij (B, P, 3), the
        slots ``live`` within rcut."""
        r2 = torch.sum(rij * rij, dim=-1)
        live = live & (r2 < self.rcut * self.rcut)
        r = torch.sqrt(torch.where(live, r2, 1.0))
        u = torch.clamp((r - self.rcut_smth) / (self.rcut - self.rcut_smth),
                        0.0, 1.0)
        w = torch.where(live, u * u * u * (-6.0 * u * u + 15.0 * u - 10.0)
                        + 1.0, 0.0)
        s = w / r
        scale = self.w["dstd"][typ_i]                             # (B, 4)
        env = torch.cat([s[..., None], (s / r)[..., None] * rij], dim=-1) \
            / scale[:, None, :]
        rhat = torch.where(live[..., None], rij / r[..., None], 0.0)
        tebd = self._tebd()
        g_s = self._mlp(self.w["embed_s"], env[..., :1])
        pair = torch.cat([tebd[typ_j], tebd[typ_i][:, None, :].expand(
            -1, rij.shape[1], -1)], dim=-1)
        g_t = self._mlp(self.w["embed_t"], pair)
        g = g_s + g_s * g_t * w[..., None]
        sw = w[:, :, None] * w[:, None, :]                        # (B, P, P)
        angle = self._mm(rhat, rhat.transpose(1, 2))
        keys = live[:, None, :]
        for lyr in self.w["attn"]:
            q, k, v = self._dense(lyr["in"], g).split(self.attn, dim=-1)
            q, k, v = self._unit(q), self._unit(k), self._unit(v)
            logit = self._mm(q, k.transpose(1, 2)) / math.sqrt(self.attn)
            logit = (logit + SHIFT) * sw - SHIFT
            logit = torch.where(keys, logit, -1e30)
            a = torch.softmax(logit, dim=-1)
            a = torch.where(keys, a, 0.0) * sw * angle
            g = self._layer_norm(g + self._dense(lyr["out"],
                                                 self._mm(a, v)), lyr["ln"])
        t_mat = self._mm(env.transpose(1, 2), g) / float(self.nsel)
        d = self._mm(t_mat[:, :, :self.axis].transpose(1, 2), t_mat)
        h = torch.cat([d.reshape(d.shape[0], -1), tebd[typ_i]], dim=-1)
        for lyr in self.w["fit"]["hidden"]:
            y = torch.tanh(self._dense(lyr, h))
            h = h + lyr["idt"] * y if "idt" in lyr else y
        e = self._dense(self.w["fit"]["head"], h)[:, 0]
        return e + self.w["ebias"][typ_i]

    # ------------------------------------------------------------ public

    def energy_forces(self, pos: torch.Tensor, typ: torch.Tensor,
                      box: torch.Tensor, nbr: torch.Tensor,
                      forces: bool = True
                      ) -> Tuple[float, Optional[torch.Tensor]]:
        """Total energy (a float, summed in float64) and forces (N, 3) of
        positions ``pos`` (N, 3) under the minimum image of ``box`` (3,),
        from the padded neighbour table ``nbr`` (N, P) (-1 past each row's
        neighbours; any superset of the pairs within rcut). Each block of
        atoms keeps its pairs within rcut, packed to the block's widest
        row."""
        n = pos.shape[0]
        force = torch.zeros_like(pos) if forces else None
        total = torch.zeros((), dtype=torch.float64, device=pos.device)
        with self._matmul_mode():
            for a0 in range(0, n, self.block_atoms):
                a1 = min(n, a0 + self.block_atoms)
                with torch.no_grad():
                    idx = nbr[a0:a1]
                    j = torch.clamp(idx, min=0)
                    d = pos[j] - pos[a0:a1, None, :]
                    d = d - box * torch.round(d / box)
                    inside = (idx >= 0) & (torch.sum(d * d, dim=-1)
                                           < self.rcut * self.rcut)
                    width = max(int(inside.sum(dim=1).max()), 1)
                    order = torch.argsort((~inside).to(torch.int8), dim=1,
                                          stable=True)[:, :width]
                    live = torch.gather(inside, 1, order)
                    j = torch.gather(j, 1, order)
                    rij = torch.where(live[..., None],
                                      torch.gather(d, 1, order[..., None]
                                                   .expand(-1, -1, 3)), 0.0)
                if forces:
                    with torch.enable_grad():
                        rij.requires_grad_(True)
                        e = self.atomic_energy(rij, live, typ[a0:a1], typ[j])
                        (g,) = torch.autograd.grad(e.sum(), rij)
                    g = torch.where(live[..., None], g, 0.0)
                    force.index_add_(0, j.reshape(-1), -g.reshape(-1, 3))
                    force[a0:a1] += g.sum(dim=1)
                else:
                    with torch.no_grad():
                        e = self.atomic_energy(rij, live, typ[a0:a1], typ[j])
                total += e.detach().double().sum()
        return float(total), force


# ------------------------------------------------------------------ counts

def _attention_layer_terms(cfg: Dict) -> Tuple[float, float]:
    """Forward FP32 operations of one attention layer: (per live slot, per
    live pair of slots j, k of one atom)."""
    m, a = int(cfg["embed_widths"][-1]), int(cfg["attn"])
    per_slot = (2.0 * m * 3 * a       # q, k, v
                + 10.0 * a            # their norms, the 1/sqrt(attn)
                + 2.0 * a * m         # the output projection
                + 8.0 * m)            # the residual and LayerNorm
    per_pair = (2.0 * a               # q . k
                + 8.0                 # shift, gate, mask, softmax, weights
                + 2.0 * a)            # the weights times v
    return per_slot, per_pair


def attention_cost(cfg: Dict, pairs: float, pairs_sq: float
                   ) -> Tuple[float, float]:
    """(bytes, FP32 operations) of the attention layers, forward and
    backward, over the live slots only: ``pairs`` = sum_i n_i and
    ``pairs_sq`` = sum_i n_i^2, n_i atom i's neighbours within rcut.

    Operations: each layer's per-slot and per-pair terms, and once the
    gates (w_j w_k, r^_j . r^_k: 8 a pair), forward and backward counted as
    three times the forward. Bytes, each read or written once: forward G0,
    w and r^ in (M + 4 floats a slot) and G out (M); backward dG and again
    G0, w, r^ in, dG0, dw, dr^ out; each layer's weights twice."""
    m, a = int(cfg["embed_widths"][-1]), int(cfg["attn"])
    layers = int(cfg["attn_layer"])
    per_slot, per_pair = _attention_layer_terms(cfg)
    ops = 3.0 * (layers * (pairs * per_slot + pairs_sq * per_pair)
                 + 8.0 * pairs_sq)
    slot_bytes = 4.0 * ((m + 4) + m + (m + m + 4) + (m + 4))
    weight_bytes = 4.0 * layers * (m * 3 * a + 3 * a + a * m + 3 * m)
    return pairs * slot_bytes + 2.0 * weight_bytes, ops


def force_eval_flops(cfg: Dict, atoms: int, live_pairs: float) -> float:
    """FP32 operations of one DPA-1 energy-and-forces evaluation of
    ``atoms`` atoms with ``live_pairs`` pairs within rcut, by the least
    work over the live slots, forward and backward counted as three times
    the forward. Per live slot: the environment row and switch (30), N_s,
    G0 (3 M) and its share of T (8 M); the attention (``attention_cost``),
    whose pairs of slots come from the totals alone as live_pairs^2 /
    atoms, the least sum_i n_i^2 for that sum_i n_i (a lower bound, so no
    implementation reads above the peak); per atom the descriptor (4 x M<
    x M multiply-adds) and the fitting net. N_t runs once per pair of
    types, which is left out."""
    m, axis = int(cfg["embed_widths"][-1]), int(cfg["axis_neuron"])
    per_slot = 30.0 + mlp_flops(cfg["embed_widths"], 1) + 3.0 * m + 8.0 * m
    fit = mlp_flops(list(cfg["fit_widths"]) + [1],
                    axis * m + int(cfg["tebd_dim"]))
    per_atom = 2.0 * 4 * axis * m + fit
    pairs_sq = live_pairs * live_pairs / max(atoms, 1)
    _, attn = attention_cost(cfg, live_pairs, pairs_sq)
    return 3.0 * (atoms * per_atom + live_pairs * per_slot) + attn
