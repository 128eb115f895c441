"""The DPA-2 model family: the large atomic model's descriptor (Zhang et
al., arXiv:2312.15492) as DeePMD-kit's ``dpa2`` writes it with the flags of
its water example (``examples/water/dpa2``), and one fitting net with
``resnet_dt`` on [g1, tebd(t_i)].

  weights           the raw weights from a seed, handed to the port and
                    to the reference alike
  Reference         plain PyTorch energies and forces
  force_eval_flops  the least-work count of one force evaluation
  repformer_cost    the bytes and operations of the repformer layers alone

The reference, written from the equations and not from the port. For each
atom i of type t_i it keeps its own two lists, from the brute-force table:
the pairs within ``rcut`` (repinit) and the pairs within
``repformer_rcut`` (the repformers), each packed per block of atoms.
For a list with cut-offs (rs, rc):

  w(r)  = 1 below rs, u^3 (-6 u^2 + 15 u - 10) + 1 up to rc, 0 beyond,
          u = (r - rs) / (rc - rs);  s = w / r;  R~ row = s (1, x/r, y/r, z/r)
          (davg 0, dstd 1)
  tebd(t) = tanh(onehot(t) W + b)

  repinit: G = N([s, tebd(t_j), tebd(t_i)]), N a tanh MLP with DeePMD's
          residuals (identity where a width repeats, (h, h) where it
          doubles), run on every slot of the block; T = R~^T G / sel;
          D = T[:, :axis]^T T, flattened (axis x M); g1 = tanh(D W0)
  inputs on the repformers' list: h2 = R~[:, 1:4]; g2 = tanh(R~[:, 0] W + b);
          sw = w
  each of the layers, every update from the layer's input g1 and g2, and
          gg1_j = g1 of neighbour j (every atom's g1 of the layer is
          complete before the next layer gathers it):
          u1 = tanh(g2 W2 + b2)
          for each head h: q_h, k_h = columns d * 2H + h and d * 2H + H + h
            of g2 W_qk; L = (q_j . k_k / sqrt(hidden)) (h2_j . h2_k);
            P = softmax over the live k of (L + 20) sw_j sw_k - 20;
            A = P sw_j sw_k (h2_j . h2_k) / sqrt(3); v_h = columns d * H + h
            of g2 W_v; o_h = A v_h
          u2 = LayerNorm(o W_o + b_o), o's column d * H + h = o_h[d] (mean
            and biased variance over the g2 features, eps 1e-5, a scale and
            a shift)
          g2' = g2 + r2[0] u1 + r2[1] u2
          v1 = tanh(g1 W_s + b_s)
          v2 = sum_j sw_j (g2_j W_p) * gg1_j / sel2
          for g in (g2, gg1): H = h2^T (sw g) / sqrt(sel2),
            H[:, :a]^T H / 3 flattened (a the repformers' axis)
          v3 = tanh([grrg, drrd] W1 + b1)
          g1' = g1 + r1[0] v1 + r1[1] v2 + r1[2] v3
  E_i   = F([g1, tebd(t_i)]) + ebias[t_i]; F: tanh layers, h + idt tanh(.)
          where the width repeats, a linear head
  F     = -dE/dx by autograd through the positions (each block's work
          checkpointed, so only g1 and g2 of each layer are kept)

Departures from DeePMD-kit, stated in the configuration's ``assumed``:
(1) the attention's softmax runs over the live slots only, where DeePMD's
smooth mode lets each padded slot add e^-20 to its denominator: the energy
then does not depend on how many slots there are; (2) davg is 0 and dstd 1
(no trained statistics exist); (3) ``use_three_body`` is off. The weights
are random (DeePMD's initialisation; the residual vectors N(0, 0.01^2)).

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
from torch.utils.checkpoint import checkpoint

from mdbench.cost import mlp_flops
from mdbench.reference.shared import round_tf32

SHIFT = 20.0
LN_EPS = 1e-5
#: DeePMD's ``update_residual`` with ``update_residual_init`` "norm"
RESIDUAL_STD = 0.01


def _mlp_sizes(widths: Sequence[int], d_in: int) -> List[Tuple[int, int]]:
    sizes, prev = [], d_in
    for w in widths:
        sizes.append((prev, int(w)))
        prev = int(w)
    return sizes


def _dims(cfg: Dict) -> Dict[str, int]:
    g1, g2 = int(cfg["g1_dim"]), int(cfg["g2_dim"])
    return {"g1": g1, "g2": g2, "heads": int(cfg["attn2_heads"]),
            "hid": int(cfg["attn2_hidden"]), "axis": int(cfg["repformer_axis"]),
            "tebd": int(cfg["tebd_dim"]), "m": int(cfg["repinit_widths"][-1]),
            "a1": int(cfg["repinit_axis"]), "layers":
            int(cfg["repformer_layers"])}


def weights(cfg: Dict, seed: int, device: torch.device,
            dstd: Optional[torch.Tensor] = None) -> Dict:
    """Raw DPA-2 weights from ``seed``, drawn on ``device`` in one call:
    DeePMD's initialisation, W ~ N(0, 1) / sqrt(d_in + d_out) and
    b ~ 0.1 N(0, 1) (no bias where DeePMD has none: W_qk, W_v, W_p, W0);
    each LayerNorm's scale 1 + 0.1 N(0, 1) and shift 0.1 N(0, 1) (a
    trained model's are not 1 and 0); the residual vectors
    RESIDUAL_STD N(0, 1); ``idt`` 0.1 + 0.001 N(0, 1); the energy biases
    0. The dict has the port's parameter layout. No trained statistics:
    ``dstd`` must be None (``env_scale`` "unit")."""
    if dstd is not None:
        raise ValueError("DPA-2 runs with davg 0 and dstd 1 (env_scale "
                         "'unit')")
    d = _dims(cfg)
    g1, g2, heads, hid = d["g1"], d["g2"], d["heads"], d["hid"]
    fit = _mlp_sizes(cfg["fit_widths"], g1 + d["tebd"]) \
        + [(int(cfg["fit_widths"][-1]), 1)]
    repinit = _mlp_sizes(cfg["repinit_widths"], 1 + 2 * d["tebd"])
    mlp_dim = d["axis"] * (g1 + g2)
    layer_sizes = {"g1_self": (g1, g1, True), "g2_mlp": (g2, g2, True),
                   "attn_qk": (g2, 2 * heads * hid, False),
                   "attn_v": (g2, g2 * heads, False),
                   "attn_out": (g2 * heads, g2, True),
                   "conv": (g2, g1, False), "g1_mlp": (mlp_dim, g1, True)}
    per_layer = sum(a * b + (b if bias else 0)
                    for a, b, bias in layer_sizes.values()) \
        + 2 * g2 + 3 * g1 + 2 * g2
    total = (int(cfg["ntypes"]) * d["tebd"] + d["tebd"]
             + sum(a * b + b for a, b in repinit)
             + d["a1"] * d["m"] * g1 + 2 * g2 + d["layers"] * per_layer
             + sum(a * b + b for a, b in fit)
             + sum(b for a, b in fit[1:-1] if a == b))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    at = 0

    def take(n):
        nonlocal at
        out = flat[at:at + n]
        at += n
        return out

    def layer(d_in, d_out, bias=True):
        w = take(d_in * d_out).view(d_in, d_out) / float(d_in + d_out) ** 0.5
        return {"w": w, "b": take(d_out) * 0.1} if bias else {"w": w}

    out: Dict = {
        "tebd": layer(int(cfg["ntypes"]), d["tebd"]),
        "repinit": [layer(a, b) for a, b in repinit],
        "g1_map": layer(d["a1"] * d["m"], g1, bias=False),
        "g2_embed": layer(1, g2),
        "repformers": [],
    }
    for _ in range(d["layers"]):
        lyr = {name: layer(a, b, bias)
               for name, (a, b, bias) in layer_sizes.items()}
        lyr["attn_ln"] = {"scale": 1.0 + 0.1 * take(g2),
                          "shift": 0.1 * take(g2)}
        lyr["g1_res"] = RESIDUAL_STD * take(3 * g1).view(3, g1)
        lyr["g2_res"] = RESIDUAL_STD * take(2 * g2).view(2, g2)
        out["repformers"].append(lyr)
    hidden = [layer(a, b) for a, b in fit[:-1]]
    for lyr in hidden[1:]:
        d_in, d_out = lyr["w"].shape
        if d_in == d_out:
            lyr["idt"] = 0.1 + 0.001 * take(d_out)
    out["fit"] = {"hidden": hidden, "head": layer(*fit[-1])}
    out["ebias"] = torch.zeros((int(cfg["ntypes"]),), dtype=torch.float32,
                               device=device)
    assert at == total
    return out


class _Block:
    """One block of atoms' two lists: neighbour indices, minimum-image
    shifts (box lengths, no gradient) and live masks."""

    def __init__(self, a0: int, a1: int, j1, s1, m1, j2, s2, m2):
        self.a0, self.a1 = a0, a1
        self.j1, self.s1, self.m1 = j1, s1, m1
        self.j2, self.s2, self.m2 = j2, s2, m2


class Reference:
    """Energies and forces of one DPA-2 model, from its raw weights.

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
        self.rcut2 = float(cfg["repformer_rcut"])
        self.rcut2_smth = float(cfg["repformer_rcut_smth"])
        self.sel = int(cfg["sel"])
        self.sel2 = int(cfg["repformer_sel"])
        self.ntypes = int(cfg["ntypes"])
        self.d = _dims(cfg)

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
        y = self._mm(h, lyr["w"])
        return y + lyr["b"] if "b" in lyr else y

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
    def _layer_norm(x: torch.Tensor, ln: Dict[str, torch.Tensor]
                    ) -> torch.Tensor:
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + LN_EPS) * ln["scale"] \
            + ln["shift"]

    def _tebd(self) -> torch.Tensor:
        onehot = torch.eye(self.ntypes, dtype=torch.float32, device=self.dev)
        return torch.tanh(self._dense(self.w["tebd"], onehot))

    @staticmethod
    def _env(x: torch.Tensor, i0: int, i1: int, j: torch.Tensor,
             shift: torch.Tensor, live: torch.Tensor, rs: float, rc: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(R~ (B, P, 4), w (B, P)) of the block's list from positions
        ``x``: zero rows on padded slots."""
        rij = x[j] - x[i0:i1, None, :] - shift
        rij = torch.where(live[..., None], rij, 1.0)
        r = torch.sqrt(torch.sum(rij * rij, dim=-1))
        u = torch.clamp((r - rs) / (rc - rs), 0.0, 1.0)
        w = torch.where(live, u * u * u * (-6.0 * u * u + 15.0 * u - 10.0)
                        + 1.0, 0.0)
        s = w / r
        env = torch.cat([s[..., None], (s / r)[..., None] * rij], dim=-1)
        return torch.where(live[..., None], env, 0.0), w

    def _lists(self, pos: torch.Tensor, box: torch.Tensor,
               nbr: torch.Tensor) -> List[_Block]:
        """Each block's pairs within rcut and within repformer_rcut, each
        packed to the block's widest row."""
        out = []
        with torch.no_grad():
            for a0 in range(0, pos.shape[0], self.block_atoms):
                a1 = min(pos.shape[0], a0 + self.block_atoms)
                idx = nbr[a0:a1]
                j = torch.clamp(idx, min=0)
                d = pos[j] - pos[a0:a1, None, :]
                shift = box * torch.round(d / box)
                r2 = torch.sum((d - shift) ** 2, dim=-1)
                packed = []
                for rc in (self.rcut, self.rcut2):
                    inside = (idx >= 0) & (r2 < rc * rc)
                    width = max(int(inside.sum(dim=1).max()), 1)
                    order = torch.argsort((~inside).to(torch.int8), dim=1,
                                          stable=True)[:, :width]
                    packed += [torch.gather(j, 1, order),
                               torch.gather(shift, 1, order[..., None]
                                            .expand(-1, -1, 3)),
                               torch.gather(inside, 1, order)]
                out.append(_Block(a0, a1, *packed))
        return out

    def _inputs(self, x: torch.Tensor, typ: torch.Tensor, b: _Block
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """g1 (B, g1) from repinit and g2 (B, P2, g2) of one block."""
        tebd = self._tebd()
        env, _ = self._env(x, b.a0, b.a1, b.j1, b.s1, b.m1, self.rcut_smth,
                           self.rcut)
        ti = typ[b.a0:b.a1]
        inp = torch.cat([env[..., :1], tebd[typ[b.j1]],
                         tebd[ti][:, None, :].expand(-1, env.shape[1], -1)],
                        dim=-1)
        g = self._mlp(self.w["repinit"], inp)
        t_mat = self._mm(env.transpose(1, 2), g) / float(self.sel)
        dsc = self._mm(t_mat[:, :, :self.d["a1"]].transpose(1, 2), t_mat)
        g1 = torch.tanh(self._dense(self.w["g1_map"],
                                    dsc.reshape(dsc.shape[0], -1)))
        env2, _ = self._env(x, b.a0, b.a1, b.j2, b.s2, b.m2, self.rcut2_smth,
                            self.rcut2)
        g2 = torch.tanh(self._dense(self.w["g2_embed"], env2[..., :1]))
        return g1, g2

    def _symmetrize(self, h2: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        hg = self._mm(h2.transpose(1, 2), g) / math.sqrt(self.sel2)
        a = self.d["axis"]
        out = self._mm(hg[:, :, :a].transpose(1, 2), hg) / 3.0
        return out.reshape(out.shape[0], -1)

    def _layer(self, lyr: Dict, x: torch.Tensor, g1_all: torch.Tensor,
               g2: torch.Tensor, b: _Block
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One repformer layer on one block: (g1, g2) of its atoms."""
        heads, hid = self.d["heads"], self.d["hid"]
        env2, sw = self._env(x, b.a0, b.a1, b.j2, b.s2, b.m2,
                             self.rcut2_smth, self.rcut2)
        h2 = env2[..., 1:]
        live = b.m2
        g1 = g1_all[b.a0:b.a1]
        gg1 = torch.where(live[..., None], g1_all[b.j2], 0.0)
        nb, p, d2 = g2.shape

        u1 = torch.tanh(self._dense(lyr["g2_mlp"], g2))
        qk = self._mm(g2, lyr["attn_qk"]["w"]).view(nb, p, hid, 2 * heads)
        vv = self._mm(g2, lyr["attn_v"]["w"]).view(nb, p, d2, heads)
        hh = self._mm(h2, h2.transpose(1, 2))
        sw2 = sw[:, :, None] * sw[:, None, :]
        keys = live[:, None, :]
        outs = []
        for h in range(heads):
            q, k = qk[..., h], qk[..., heads + h]
            logit = self._mm(q, k.transpose(1, 2)) / math.sqrt(hid) * hh
            logit = (logit + SHIFT) * sw2 - SHIFT
            att = torch.softmax(torch.where(keys, logit, -1e30), dim=-1)
            att = torch.where(keys, att, 0.0) * sw2 * hh / math.sqrt(3.0)
            outs.append(self._mm(att, vv[..., h]))
        o = torch.stack(outs, dim=-1).reshape(nb, p, d2 * heads)
        u2 = self._layer_norm(self._dense(lyr["attn_out"], o), lyr["attn_ln"])
        g2_new = g2 + lyr["g2_res"][0] * u1 + lyr["g2_res"][1] * u2

        v1 = torch.tanh(self._dense(lyr["g1_self"], g1))
        v2 = torch.sum(self._mm(g2, lyr["conv"]["w"]) * gg1
                       * sw[..., None], dim=1) / float(self.sel2)
        sym = torch.cat([self._symmetrize(h2, g2 * sw[..., None]),
                         self._symmetrize(h2, gg1 * sw[..., None])], dim=-1)
        v3 = torch.tanh(self._dense(lyr["g1_mlp"], sym))
        r1 = lyr["g1_res"]
        return g1 + r1[0] * v1 + r1[1] * v2 + r1[2] * v3, g2_new

    def _energies(self, x: torch.Tensor, typ: torch.Tensor,
                  blocks: List[_Block], saved: bool,
                  states: Optional[list] = None) -> torch.Tensor:
        """E_i (N,) from positions ``x``, layer by layer over the blocks;
        with ``saved`` each block's work is checkpointed. ``states``, where
        given, gets (g1, [g2 of each block]) after the inputs and after
        each layer."""
        def run(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False) if saved \
                else fn(*args)

        firsts = [run(lambda xx, b=b: self._inputs(xx, typ, b), x)
                  for b in blocks]
        g1 = torch.cat([f[0] for f in firsts])
        g2s = [f[1] for f in firsts]
        for lyr in [None] + self.w["repformers"]:
            if lyr is not None:
                outs = [run(lambda xx, gg, g2, b=b, lyr=lyr:
                            self._layer(lyr, xx, gg, g2, b), x, g1, g2s[i])
                        for i, b in enumerate(blocks)]
                g1 = torch.cat([o[0] for o in outs])
                g2s = [o[1] for o in outs]
            if states is not None:
                states.append((g1, g2s))
        tebd = self._tebd()
        h = torch.cat([g1, tebd[typ]], dim=-1)
        for lyr in self.w["fit"]["hidden"]:
            y = torch.tanh(self._dense(lyr, h))
            h = h + lyr["idt"] * y if "idt" in lyr else y
        return self._dense(self.w["fit"]["head"], h)[:, 0] \
            + self.w["ebias"][typ]

    # ------------------------------------------------------------ public

    def atomic_energies(self, pos: torch.Tensor, typ: torch.Tensor,
                        box: torch.Tensor, nbr: torch.Tensor
                        ) -> torch.Tensor:
        """E_i (N,) of every atom (no forces)."""
        with self._matmul_mode(), torch.no_grad():
            return self._energies(pos, typ, self._lists(pos, box, nbr),
                                  saved=False)

    def layer_states(self, pos: torch.Tensor, typ: torch.Tensor,
                     box: torch.Tensor, nbr: torch.Tensor
                     ) -> List[Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]]:
        """After the inputs and after each layer: (g1 (N, g1), and of the
        repformers' list, padded to its widest row, the neighbours (N, P),
        the live slots (N, P) and g2 (N, P, g2))."""
        states: list = []
        with self._matmul_mode(), torch.no_grad():
            blocks = self._lists(pos, box, nbr)
            self._energies(pos, typ, blocks, saved=False, states=states)
        width = max(b.j2.shape[1] for b in blocks)

        def pad(parts, fill):
            return torch.cat([torch.nn.functional.pad(
                p, (0, 0) * (p.dim() - 2) + (0, width - p.shape[1]),
                value=fill) for p in parts])

        j = pad([b.j2 for b in blocks], 0)
        live = pad([b.m2 for b in blocks], False)
        return [(g1, j, live, pad(g2s, 0.0)) for g1, g2s in states]

    def energy_forces(self, pos: torch.Tensor, typ: torch.Tensor,
                      box: torch.Tensor, nbr: torch.Tensor,
                      forces: bool = True
                      ) -> Tuple[float, Optional[torch.Tensor]]:
        """Total energy (a float, summed in float64) and forces (N, 3) of
        positions ``pos`` (N, 3) under the minimum image of ``box`` (3,),
        from the padded neighbour table ``nbr`` (N, P) (-1 past each row's
        neighbours; any superset of the pairs within rcut)."""
        with self._matmul_mode():
            blocks = self._lists(pos, box, nbr)
            if not forces:
                with torch.no_grad():
                    e = self._energies(pos, typ, blocks, saved=False)
                return float(e.double().sum()), None
            with torch.enable_grad():
                x = pos.detach().clone().requires_grad_(True)
                e = self._energies(x, typ, blocks, saved=True)
                (g,) = torch.autograd.grad(e.sum(), x)
            return float(e.detach().double().sum()), -g


# ------------------------------------------------------------------ counts

def _layer_terms(cfg: Dict) -> Tuple[float, float, float]:
    """Forward FP32 operations of one repformer layer: (per atom, per live
    slot of the repformers' list, per live pair of its slots j, k of one
    atom, over every head)."""
    d = _dims(cfg)
    g1, g2, heads, hid, a = d["g1"], d["g2"], d["heads"], d["hid"], d["axis"]
    per_atom = (2.0 * g1 * g1              # v1
                + 2.0 * a * (g1 + g2) * g1  # v3's input, 640 -> 128
                + 2.0 * 3 * a * (g1 + g2)   # grrg and drrd from H
                + 8.0 * g1)                 # tanh, residuals, v2's scale
    per_slot = (2.0 * g2 * g2              # u1
                + 2.0 * g2 * 2 * heads * hid   # q, k
                + 2.0 * g2 * g2 * heads        # v
                + 2.0 * g2 * heads * g2        # the output projection
                + 10.0 * g2                    # LayerNorm, tanh, residuals
                + 2.0 * g2 * g1 + 2.0 * g1     # v2: g2 W_p, times gg1, sum
                + 2.0 * g1 + g2                # switch gg1 and g2
                + 2.0 * 3 * (g1 + g2))         # H of both
    per_pair = heads * (2.0 * hid          # q . k
                        + 8.0              # gates, shift, softmax, weights
                        + 2.0 * g2)        # the weights times v
    return per_atom, per_slot, per_pair


def repformer_cost(cfg: Dict, atoms: float, pairs: float, pairs_sq: float
                   ) -> Tuple[float, float]:
    """(bytes, FP32 operations) of the repformer layers, forward and
    backward, over the live slots of the repformers' list only: ``pairs``
    = sum_i n_i and ``pairs_sq`` = sum_i n_i^2, n_i atom i's neighbours
    within repformer_rcut.

    Operations: each layer's per-atom, per-slot and per-pair terms, and
    once the inputs (g2's embedding, 2 x g2 a slot) and the shared gates
    (8 a pair), forward and backward counted as three times the forward.
    Bytes, each read or written once, a layer: forward g1 in and out (2 x
    g1 an atom), g2 in and out, h2 and sw in, the neighbours' g1 gathered
    (2 x g2 + 4 + g1 a slot); backward dg1 in and out and g1 again (3 x
    g1 an atom), dg2 in and out, g2, h2 and sw again, dh2 and dsw out, the
    neighbours' dg1 scattered (3 x g2 + 8 + g1 a slot); each layer's
    weights twice."""
    d = _dims(cfg)
    g1, g2, layers = d["g1"], d["g2"], d["layers"]
    per_atom, per_slot, per_pair = _layer_terms(cfg)
    ops = 3.0 * (layers * (atoms * per_atom + pairs * per_slot
                           + pairs_sq * per_pair)
                 + 2.0 * g2 * pairs + 8.0 * pairs_sq)
    w = weights_per_layer(cfg)
    nbytes = 4.0 * layers * (atoms * (2 * g1 + 3 * g1)
                             + pairs * ((2 * g2 + 4 + g1)
                                        + (3 * g2 + 8 + g1))
                             + 2.0 * w)
    return nbytes, ops


def weights_per_layer(cfg: Dict) -> int:
    """The parameters of one repformer layer."""
    d = _dims(cfg)
    g1, g2, heads, hid, a = d["g1"], d["g2"], d["heads"], d["hid"], d["axis"]
    return (g1 * g1 + g1 + g2 * g2 + g2 + g2 * 2 * heads * hid
            + g2 * g2 * heads + g2 * heads * g2 + g2 + 2 * g2 + g2 * g1
            + a * (g1 + g2) * g1 + g1 + 3 * g1 + 2 * g2)


def force_eval_flops(cfg: Dict, atoms: int, live_pairs: float,
                     sub_pairs: Optional[float] = None,
                     sub_pairs_sq: Optional[float] = None) -> float:
    """FP32 operations of one DPA-2 energy-and-forces evaluation of
    ``atoms`` atoms with ``live_pairs`` pairs within rcut and
    ``sub_pairs`` within repformer_rcut (where not given: live_pairs x
    (repformer_rcut / rcut)^3, a uniform density), by the least work over
    the live slots, forward and backward counted as three times the
    forward. Per live slot of the repinit list: the environment row and
    switch (30), N with its first layer's type terms made once per pair of
    types (2 x 25 + 25 for s and the added term, then the rest of N), T (8
    M); per atom D (4 x axis x M multiply-adds), W0 and the fitting net;
    the repformers (``repformer_cost``), their pairs of slots
    ``sub_pairs_sq`` or, from the totals alone, sub_pairs^2 / atoms (the
    least sum_i n_i^2 for that sum_i n_i)."""
    d = _dims(cfg)
    widths = [int(w) for w in cfg["repinit_widths"]]
    per_slot = 30.0 + 3.0 * widths[0] + mlp_flops(widths[1:], widths[0]) \
        + 8.0 * d["m"]
    fit = mlp_flops(list(cfg["fit_widths"]) + [1], d["g1"] + d["tebd"])
    per_atom = 2.0 * 4 * d["a1"] * d["m"] + 2.0 * d["a1"] * d["m"] * d["g1"] \
        + fit
    if sub_pairs is None:
        ratio = float(cfg["repformer_rcut"]) / float(cfg["rcut"])
        sub_pairs = live_pairs * ratio ** 3
    if sub_pairs_sq is None:
        sub_pairs_sq = sub_pairs * sub_pairs / max(atoms, 1)
    _, rep = repformer_cost(cfg, atoms, sub_pairs, sub_pairs_sq)
    return 3.0 * (atoms * per_atom + live_pairs * per_slot) + rep
