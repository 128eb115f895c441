"""DPA-1: the attention-based Deep Potential (Zhang et al., arXiv:2208.08236)
as DeePMD-kit's ``se_atten_v2`` descriptor writes it (``tebd_input_mode``
"strip", ``smooth_type_embedding``), with one type-conditioned fitting net.

For centre i of type t_i and its neighbours j within rcut, in ONE mixed-type
section of ``cap`` slots (any order; padded slots masked):

  w_ij = the C^2 switch (``descriptor.switching_s`` x r), s_ij = w_ij / r_ij
  R~_ij = s (1, x/r, y/r, z/r) / dstd[t_i]     r^_ij = r_ij / |r_ij|
  tebd(t) = tanh(W onehot(t) + b)
  G0_ij = N_s(R~_ij,0) * (1 + w_ij N_t([tebd(t_j), tebd(t_i)]))
  per attention layer:  q, k, v = G W_in + b_in, each L2-normalised
      A = softmax_k((q_j . k_k / sqrt(attn) + 20) w_j w_k - 20), over the
          live slots k only
      G = LayerNorm(G + (A * w_j w_k * r^_j . r^_k) v W_out + b_out)
  T = R~^T G / sel,  D = (T[:, :M<])^T T
  E_i = F([D, tebd(t_i)]) + ebias[t_i]   (F: tanh MLP, ``idt`` residuals)

N_t has ntypes^2 distinct inputs, so it runs once per pair of types and
is gathered. The softmax over live slots only makes the energy independent
of ``cap``; DeePMD-kit's smooth mode lets each padded slot add e^-20 to
the denominator.

Each attention layer's core, from q . k^T to the weights times v, is
``kernels.dp_fused.attention.gated_attention``: on the card one forward and
one backward kernel that keep the (A, S, S) logits, softmax and weights and
their gradients out of device memory; on the CPU the same algorithm in plain
torch. The in-projection, the L2 norms, the out-projection, the residual and
LayerNorm stay torch ops (per-slot work and cuBLAS GEMMs), as do the gates
w_j w_k and w_j w_k r^_j . r^_k, made once for both layers.

The model's section is compacted every step from the MD engines' list
(the pairs within rcut + skin, in type sections) by :func:`compact`, which
reports the pairs that did not fit; forces and virial come from autograd
through r_ij into ``kernels.dp_fused.force.prod_force_virial``, fed the
compacted list (``dp_model.energy_forces_from_rij``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import descriptor, dp_model, layers
from repro_torch.core.types import DPA1Config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dp_fused.attention import gated_attention

#: the logits' shift: a slot at the cut-off (w = 0) reads -SHIFT
SHIFT = 20.0
#: added to the logits of padded keys, so that exp() of them is exactly 0;
#: below the attention kernel's ``PADDED_AT``, which reads such a slot as
#: padded
MASKED = -1e4
LN_EPS = 1e-5


# ------------------------------------------------------------------ weights

def init_params(gen: torch.Generator, cfg: DPA1Config,
                dstd: Optional[torch.Tensor] = None,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """A DPA-1 parameter dict from a generator: DeePMD's initialisation
    (``layers.init_linear``), LayerNorm at scale 1 and shift 0, ``idt``
    0.1; the keys of the benchmark's raw weights."""
    cfg.validate()
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    m, a = cfg.m_embed, int(cfg.attn)

    def lin(d_in, d_out):
        return layers.init_linear(gen, d_in, d_out, dt, dev)

    tebd = lin(cfg.ntypes, cfg.tebd_dim)
    attn = []
    for _ in range(cfg.attn_layer):
        attn.append({"in": lin(m, 3 * a), "out": lin(a, m),
                     "ln": {"scale": torch.ones(m, dtype=dt, device=dev),
                            "shift": torch.zeros(m, dtype=dt, device=dev)}})
    hidden = layers.init_mlp(gen, cfg.fit_widths,
                             cfg.descriptor_dim + cfg.tebd_dim, dt, dev)
    for i in range(1, len(hidden)):
        if cfg.fit_widths[i] == cfg.fit_widths[i - 1]:
            hidden[i]["idt"] = torch.full((int(cfg.fit_widths[i]),), 0.1,
                                          dtype=dt, device=dev)
    if dstd is None:
        dstd = torch.ones((cfg.ntypes, 4), dtype=dt)
    return {
        "tebd": tebd,
        "embed_s": layers.init_mlp(gen, cfg.embed_widths, 1, dt, dev),
        "embed_t": layers.init_mlp(gen, cfg.embed_widths, 2 * cfg.tebd_dim,
                                   dt, dev),
        "attn": attn,
        "fit": {"hidden": hidden, "head": lin(int(cfg.fit_widths[-1]), 1)},
        "dstd": dstd.to(device=dev, dtype=dt),
        "ebias": torch.zeros((cfg.ntypes,), dtype=dt, device=dev),
    }


# ---------------------------------------------------------- the model's list

def compact(pos: torch.Tensor, nlist: torch.Tensor,
            box: Optional[torch.Tensor], rcut: float, cap: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pairs of ``nlist`` (any sections, -1 padded) within ``rcut``,
    packed in list order into one section of ``cap`` slots.

    Returns the (N, cap) list, the excess (the most pairs of a row past
    ``cap``, a 0-d int32; > 0: pairs left out, the caller must grow
    ``cap``) and the pairs within rcut (0-d int64). Fixed shapes, no host
    sync: a row's k-th pair goes to its slot k, pairs past ``cap`` to a
    spare column that is cut off.
    """
    with torch.no_grad():
        rij, nmask = dp_model.gather_rij(pos, nlist, box)
        live = nmask & (torch.sum(rij * rij, dim=-1) < rcut * rcut)
        rank = torch.cumsum(live, dim=1) - 1
        count = live.sum(dim=1)
        col = torch.where(live & (rank < cap), rank, cap)
        out = torch.full((nlist.shape[0], cap + 1), -1, dtype=nlist.dtype,
                         device=nlist.device)
        out.scatter_(1, col, nlist)
        excess = (count.max() - cap).to(torch.int32) if count.numel() \
            else torch.full((), -cap, dtype=torch.int32, device=pos.device)
        return out[:, :cap].contiguous(), excess, count.sum()


# ------------------------------------------------------------------- layers

def type_embedding(params: Dict[str, Any]) -> torch.Tensor:
    """(ntypes, tebd_dim): tanh(W onehot(t) + b) for every type."""
    return torch.tanh(params["tebd"]["w"] + params["tebd"]["b"])


def pair_embedding(params: Dict[str, Any], tebd: torch.Tensor
                   ) -> torch.Tensor:
    """N_t([tebd(t_j), tebd(t_i)]) for every pair of types, (ntypes^2, M),
    row t_j * ntypes + t_i."""
    n = tebd.shape[0]
    pairs = torch.cat([tebd.repeat_interleave(n, dim=0), tebd.repeat(n, 1)],
                      dim=-1)
    return layers.resnet_mlp(params["embed_t"], pairs)


def embedding(params: Dict[str, Any], cfg: DPA1Config, rij: torch.Tensor,
              nmask: torch.Tensor, atype: torch.Tensor,
              nbr_type: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """(G0 (..., S, M), R~ (..., S, 4), w (..., S), r^ (..., S, 3)) of
    pair vectors ``rij`` (..., S, 3); padded slots give zero rows of R~,
    w and r^."""
    env, s = descriptor.env_matrix(rij, nmask, cfg.rcut_smth, cfg.rcut)
    env_n, s_n = descriptor.normalize_env(env, s, atype, params["dstd"])
    m3 = nmask[..., None]
    r = torch.linalg.vector_norm(torch.where(m3, rij, 1.0), dim=-1)
    w = s * r
    unit = torch.where(m3, rij / r[..., None], 0.0)
    g_s = layers.resnet_mlp(params["embed_s"], s_n[..., None])
    g_t = pair_embedding(params, type_embedding(params))
    g_t = g_t[nbr_type * cfg.ntypes + atype[..., None]]
    return g_s * (1.0 + w[..., None] * g_t), env_n, w, unit


def attention_gates(w: torch.Tensor, unit: torch.Tensor, nmask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What every layer shares: w_j w_k and the weights' gate w_j w_k
    (r^_j . r^_k), both (..., S, S), and the logits' additive term
    -SHIFT, plus MASKED on padded keys (..., 1, S)."""
    ww = w[..., :, None] * w[..., None, :]
    gate = ww * torch.matmul(unit, unit.transpose(-1, -2))
    pad = torch.where(nmask, -SHIFT, MASKED - SHIFT)[..., None, :]
    return ww, gate, pad.to(w.dtype)


def attention_layer(lyr: Dict[str, Any], cfg: DPA1Config, g: torch.Tensor,
                    ww: torch.Tensor, gate: torch.Tensor, pad: torch.Tensor
                    ) -> torch.Tensor:
    """One gated self-attention layer over the slots of G (A, S, M), with
    its residual and LayerNorm.

    The core, softmax((q . k^T + SHIFT) ww + pad) * gate times v, is
    ``gated_attention``: the hand-written kernels on the card, their plain
    version on the CPU; the q/k/v projection and norms, the out-projection,
    the residual and LayerNorm are torch ops."""
    a = int(cfg.attn)
    q, k, v = layers.linear(lyr["in"], g).split(a, dim=-1)
    q = F.normalize(q, dim=-1) * a ** -0.5
    k = F.normalize(k, dim=-1)
    v = F.normalize(v, dim=-1)
    out = layers.linear(lyr["out"],
                        gated_attention(q, k, v, ww, gate, pad, SHIFT))
    return F.layer_norm(g + out, (g.shape[-1],), lyr["ln"]["scale"],
                        lyr["ln"]["shift"], LN_EPS)


def attention(params: Dict[str, Any], cfg: DPA1Config, g: torch.Tensor,
              ww: torch.Tensor, gate: torch.Tensor, pad: torch.Tensor
              ) -> torch.Tensor:
    """The attention layers, one after the other (a ``dpa1.attention``
    span)."""
    with obs.span("dpa1.attention", layers=len(params["attn"])):
        for lyr in params["attn"]:
            g = attention_layer(lyr, cfg, g, ww, gate, pad)
    return g


def fitting(net: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """DeePMD's fitting net: tanh layers, ``h + idt * tanh(.)`` where the
    width repeats (``resnet_dt``), a linear head. (..., d) -> (...,)."""
    h = x
    for lyr in net["hidden"]:
        y = torch.tanh(layers.linear(lyr, h))
        h = h + lyr["idt"] * y if "idt" in lyr else y
    return layers.linear(net["head"], h)[..., 0]


def atomic_energy(params: Dict[str, Any], cfg: DPA1Config, rij: torch.Tensor,
                  nmask: torch.Tensor, atype: torch.Tensor,
                  nbr_type: torch.Tensor) -> torch.Tensor:
    """E_i (A,) of pair vectors ``rij`` (A, S, 3) in one mixed section,
    ``nbr_type`` (A, S) the neighbours' types. The normalization stays
    ``cfg.sel`` whatever S is."""
    g, env_n, w, unit = embedding(params, cfg, rij, nmask, atype, nbr_type)
    ww, gate, pad = attention_gates(w, unit, nmask)
    g = attention(params, cfg, g, ww, gate, pad)
    t_mat = torch.matmul(env_n.transpose(-1, -2), g)
    d = descriptor.descriptor_from_t(t_mat, cfg.axis_neuron, cfg.sel)
    tebd = type_embedding(params)[atype]
    return fitting(params["fit"], torch.cat([d, tebd], dim=-1)) \
        + params["ebias"][atype]


def energy_forces(params: Dict[str, Any], cfg: DPA1Config, pos: torch.Tensor,
                  nlist: torch.Tensor, atype: torch.Tensor,
                  box: Optional[torch.Tensor] = None,
                  cap: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Energy, forces, virial and the compaction's excess from the engines'
    list ``nlist`` (the pairs within rcut + skin): the pairs within rcut
    are compacted into ``cap`` slots (``cfg.sel`` by default) first."""
    mixed, excess, _ = compact(pos, nlist, box, cfg.rcut,
                               int(cap or cfg.sel))
    nbr_type = atype[torch.clamp(mixed, min=0)]

    def energy(rij, nmask):
        return torch.sum(atomic_energy(params, cfg, rij, nmask, atype,
                                       nbr_type))

    e, f, virial = dp_model.energy_forces_from_rij(energy, pos, mixed, box)
    return e, f, virial, excess

