"""DPA-2: the large atomic model's descriptor (Zhang et al.,
arXiv:2312.15492) as DeePMD-kit's ``dpa2`` writes it with its water
example's flags (``update_style`` "res_residual", g1 updated by its own
MLP, by the convolution with the neighbours' g1 and by grrg and drrd; g2
by its MLP and by the gated attention; ``use_sqrt_nnei``, ``smooth``,
``concat_output_tebd``), with one type-conditioned fitting net.

Two mixed-type sections (slots in any order; padded slots masked): ``S1``
slots within rcut (repinit) and ``S2`` within ``repformer_rcut``, the
second given as slot indices into the first. For each section w is the C^2
switch (``descriptor.switching_s`` x r), s = w / r and
R~ = s (1, x/r, y/r, z/r) (davg 0, dstd 1); tebd(t) = tanh(W onehot(t) + b).

  repinit    G_ij = N([s_ij, tebd(t_j), tebd(t_i)]) (17 -> 25 -> 50 -> 100,
             DeePMD's residuals), T = R~^T G / sel, D = T[:, :12]^T T,
             g1 = tanh(D W0) (no bias)
  inputs     on the second section: h2 = R~[:, 1:4], fixed through the
             layers; g2 = tanh(R~[:, 0] W + b) (1 -> 32); sw its switch
  a layer    from its input g1 (A, 128) and g2 (A, S2, 32), with
             gg1_ij = g1[j] (the neighbours' g1: message passing):
               u1 = tanh(g2 W2 + b2)
               per head h of 4: q, k from g2 W_qk (32 -> 256, DeePMD's
                 layout: column d * 8 + c, c < 4 the q heads);
                 P = softmax_k((q_j . k_k / sqrt(32) (h2_j . h2_k) + 20)
                 sw_j sw_k - 20) over the live k only;
                 A = P sw_j sw_k (h2_j . h2_k) / sqrt(3); v = g2 W_v (32 ->
                 32 x 4, column d * 4 + h); u2 = LayerNorm(concat_h(A v)
                 W_o + b_o), concatenated as column d * 4 + h
               g2 <- g2 + a1 u1 + a2 u2
               v1 = tanh(g1 W_s + b_s)
               v2 = (1 / sel2) sum_j sw_j (g2_j W_p) * gg1_j
               H = h2^T (sw g) / sqrt(sel2); grrg, drrd = H[:, :4]^T H / 3
                 for g = g2 and g = gg1
               v3 = tanh([grrg, drrd] W1 + b1)
               g1 <- g1 + b1 v1 + b2 v2 + b3 v3
  energy     E_i = F([g1, tebd(t_i)]) + ebias[t_i] (DPA-1's ``fitting``)

The softmax runs over live slots only, so the energy depends on neither
section's capacity (the normalizations stay at ``sel`` and
``repformer_sel``). Every term above is a torch op: the gather of g1 by
neighbour index, and the scatter-add its backward makes, included.

Both sections are compacted every step from the MD engines' list (the pairs
within rcut + skin, in type sections) by :func:`compact`, which reports
each section's excess; the second section's r_ij are gathered from the
first's, so forces and virial come from autograd through the first
section's r_ij into ``kernels.dp_fused.force.prod_force_virial``
(``dp_model.energy_forces_from_rij``). The energy is a function of those
minimum-image pair vectors alone, so W = -sum r_ij (x) dE/dr_ij is the
virial.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import descriptor, dp_model, layers
from repro_torch.core.dpa1 import LN_EPS, MASKED, SHIFT, fitting, \
    type_embedding
from repro_torch.core.types import DPA2Config
from repro_torch.device import DeviceLike, resolve_device

#: the scale DeePMD draws the residual vectors from (``update_residual``)
RESIDUAL_STD = 0.01


# ------------------------------------------------------------------ weights

def init_params(gen: torch.Generator, cfg: DPA2Config,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """A DPA-2 parameter dict from a generator: DeePMD's initialisation
    (``layers.init_linear``; no bias where DeePMD has none), LayerNorm at
    scale 1 and shift 0, residual vectors N(0, RESIDUAL_STD^2), ``idt``
    0.1; the keys of the benchmark's raw weights."""
    cfg.validate()
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    g1, g2 = cfg.g1_dim, cfg.g2_dim
    heads, hid = cfg.attn2_heads, cfg.attn2_hidden

    def lin(d_in, d_out, bias=True):
        out = layers.init_linear(gen, d_in, d_out, dt, dev)
        if not bias:
            del out["b"]
        return out

    def residual(n, width):
        r = torch.randn((n, width), generator=gen) * RESIDUAL_STD
        return r.to(device=dev, dtype=dt)

    reps = []
    for _ in range(cfg.repformer_layers):
        reps.append({
            "g1_self": lin(g1, g1), "g2_mlp": lin(g2, g2),
            "attn_qk": lin(g2, 2 * heads * hid, bias=False),
            "attn_v": lin(g2, g2 * heads, bias=False),
            "attn_out": lin(g2 * heads, g2),
            "attn_ln": {"scale": torch.ones(g2, dtype=dt, device=dev),
                        "shift": torch.zeros(g2, dtype=dt, device=dev)},
            "conv": lin(g2, g1, bias=False),
            "g1_mlp": lin(cfg.g1_mlp_dim, g1),
            "g1_res": residual(3, g1), "g2_res": residual(2, g2)})
    fit_in = g1 + cfg.tebd_dim
    hidden = layers.init_mlp(gen, cfg.fit_widths, fit_in, dt, dev)
    for i in range(1, len(hidden)):
        if cfg.fit_widths[i] == cfg.fit_widths[i - 1]:
            hidden[i]["idt"] = torch.full((int(cfg.fit_widths[i]),), 0.1,
                                          dtype=dt, device=dev)
    return {
        "tebd": lin(cfg.ntypes, cfg.tebd_dim),
        "repinit": layers.init_mlp(gen, cfg.repinit_widths,
                                   1 + 2 * cfg.tebd_dim, dt, dev),
        "g1_map": lin(cfg.repinit_dim, g1, bias=False),
        "g2_embed": lin(1, g2),
        "repformers": reps,
        "fit": {"hidden": hidden, "head": lin(int(cfg.fit_widths[-1]), 1)},
        "ebias": torch.zeros((cfg.ntypes,), dtype=dt, device=dev),
    }


# -------------------------------------------------------- the model's lists

def compact(pos: torch.Tensor, nlist: torch.Tensor,
            box: Optional[torch.Tensor], cfg: DPA2Config,
            caps: Tuple[int, int]
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """Both sections from the engines' list ``nlist`` (any sections, -1
    padded), in one pass: the pairs within rcut packed in list order into
    ``caps[0]`` slots (atom indices), and the pairs within
    ``repformer_rcut`` packed into ``caps[1]`` slots as indices of their
    slots in the first section.

    Returns (mixed (N, caps[0]), sub (N, caps[1]), excess (2,) int32, live
    (2,) int64): each section's excess (the most pairs of a row past its
    capacity; > 0, the caller must grow that section) and its pairs. Fixed
    shapes, no host sync. A pair of the second section whose slot in the
    first was cut off is left out of it too (the first's excess then
    reads > 0, and the evaluation is not used)."""
    cap1, cap2 = (int(c) for c in caps)
    with torch.no_grad():
        rij, nmask = dp_model.gather_rij(pos, nlist, box)
        r2 = torch.sum(rij * rij, dim=-1)
        live1 = nmask & (r2 < cfg.rcut * cfg.rcut)
        live2 = live1 & (r2 < cfg.repformer_rcut * cfg.repformer_rcut)
        rank1 = torch.cumsum(live1, dim=1) - 1
        rank2 = torch.cumsum(live2, dim=1) - 1
        n = nlist.shape[0]
        mixed = torch.full((n, cap1 + 1), -1, dtype=nlist.dtype,
                           device=nlist.device)
        mixed.scatter_(1, torch.where(live1 & (rank1 < cap1), rank1, cap1),
                       nlist)
        sub = torch.full((n, cap2 + 1), -1, dtype=rank1.dtype,
                         device=nlist.device)
        sub.scatter_(1, torch.where(live2 & (rank2 < cap2), rank2, cap2),
                     torch.where(rank1 < cap1, rank1, -1))
        counts = torch.stack([live1.sum(dim=1), live2.sum(dim=1)])
        most = counts.amax(dim=1) if n else counts.new_zeros(2)
        excess = torch.stack([most[0] - cap1, most[1] - cap2])
        return (mixed[:, :cap1].contiguous(), sub[:, :cap2].contiguous(),
                excess.to(torch.int32), counts.sum(dim=1))


def sub_section(rij: torch.Tensor, mixed: torch.Tensor, sub: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The second section's pair vectors (A, S2, 3), gathered from the
    first's ``rij`` (so their gradient flows back into it), its mask and
    its neighbours' atom indices (-1 padded)."""
    mask = sub >= 0
    at = torch.clamp(sub, min=0)
    rij2 = torch.gather(rij, 1, at[..., None].expand(-1, -1, 3))
    rij2 = torch.where(mask[..., None], rij2, 0.0)
    nbr = torch.where(mask, torch.gather(mixed, 1, at), -1)
    return rij2, mask, nbr


# ------------------------------------------------------------------- layers

def _switch(rij: torch.Tensor, nmask: torch.Tensor, rcut_smth: float,
            rcut: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R~ (..., S, 4), w (..., S)) of a section, davg 0 and dstd 1."""
    env, s = descriptor.env_matrix(rij, nmask, rcut_smth, rcut)
    r = torch.linalg.vector_norm(torch.where(nmask[..., None], rij, 1.0),
                                 dim=-1)
    return env, s * r


def repinit(params: Dict[str, Any], cfg: DPA2Config, rij: torch.Tensor,
            nmask: torch.Tensor, atype: torch.Tensor, nbr_type: torch.Tensor,
            tebd: torch.Tensor) -> torch.Tensor:
    """g1 (A, g1_dim) from the first section (a ``dpa2.repinit`` span).

    N's first layer on [s, tebd(t_j), tebd(t_i)] is s W_s plus a term of
    the pair of types alone, made once per pair of types and gathered."""
    with obs.span("dpa2.repinit", slots=int(rij.shape[1])):
        env, _ = _switch(rij, nmask, cfg.rcut_smth, cfg.rcut)
        first, *rest = params["repinit"]
        d = cfg.tebd_dim
        w = first["w"]
        nt = tebd.shape[0]
        pairs = (torch.matmul(tebd, w[1:1 + d])[:, None, :]
                 + torch.matmul(tebd, w[1 + d:])[None, :, :] + first["b"])
        h = torch.tanh(env[..., :1] * w[0]
                       + pairs.reshape(nt * nt, -1)[nbr_type * nt
                                                    + atype[:, None]])
        g = layers.resnet_mlp(rest, h)
        t_mat = torch.matmul(env.transpose(-1, -2), g)
        t_mat = t_mat / float(cfg.sel)
        dsc = torch.matmul(t_mat[..., :cfg.repinit_axis].transpose(-1, -2),
                           t_mat)
        return torch.tanh(torch.matmul(dsc.flatten(1), params["g1_map"]["w"]))


def _symmetrize(h2: torch.Tensor, g: torch.Tensor, axis: int, sel: int
                ) -> torch.Tensor:
    """H = h2^T g / sqrt(sel) (the switch already in g), then
    H[:, :axis]^T H / 3, flattened: (A, axis x width)."""
    hg = torch.matmul(h2.transpose(-1, -2), g) * sel ** -0.5
    return (torch.matmul(hg[..., :axis].transpose(-1, -2), hg) / 3.0) \
        .flatten(1)


def attention_gates(h2: torch.Tensor, sw: torch.Tensor, mask: torch.Tensor,
                    hidden: int) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """What every layer's attention shares, (A, 1, S2, S2) each: the
    logits' scale (h2_j . h2_k) sw_j sw_k / sqrt(hidden), their shift
    SHIFT (sw_j sw_k - 1) plus MASKED on padded keys, and the weights' gate
    sw_j sw_k (h2_j . h2_k) / sqrt(3)."""
    hh = torch.matmul(h2, h2.transpose(-1, -2))
    ww = sw[:, :, None] * sw[:, None, :]
    gate = hh * ww
    shift = SHIFT * (ww - 1.0) + torch.where(mask, 0.0, MASKED)[:, None, :]
    return ((gate * hidden ** -0.5)[:, None], shift[:, None],
            (gate * 3.0 ** -0.5)[:, None])


def repformer_layer(lyr: Dict[str, Any], cfg: DPA2Config, g1: torch.Tensor,
                    g2: torch.Tensor, h2: torch.Tensor, sw: torch.Tensor,
                    nbr: torch.Tensor, gates: Tuple[torch.Tensor, ...]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One repformer layer: (g1, g2) -> (g1, g2), every update from the
    layer's input."""
    a, s2, d2 = g2.shape
    heads, hid = cfg.attn2_heads, cfg.attn2_hidden
    scale, shift, weight = gates
    # the neighbours' g1, switched (a padded slot's sw is 0); index_select,
    # whose backward is one index_add_ (atomics): indexing's backward sorts
    # the ~27 x A duplicate indices, 1.3 s an evaluation on an H100 at
    # 24,000 atoms
    gg1 = g1.index_select(0, torch.clamp(nbr, min=0).flatten()).view(
        a, s2, -1) * sw[..., None]
    g2s = g2 * sw[..., None]

    # g2: its MLP and the gated multi-head attention
    u1 = torch.tanh(layers.linear(lyr["g2_mlp"], g2))
    qk = torch.matmul(g2, lyr["attn_qk"]["w"]).view(a, s2, hid, 2 * heads)
    q, k = qk.permute(0, 3, 1, 2).split(heads, dim=1)     # (A, H, S2, hid)
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale + shift
    att = torch.softmax(logits, dim=-1) * weight
    v = torch.matmul(g2, lyr["attn_v"]["w"]).view(a, s2, d2, heads)
    o = torch.matmul(att, v.permute(0, 3, 1, 2))           # (A, H, S2, d2)
    o = o.permute(0, 2, 3, 1).reshape(a, s2, d2 * heads)
    u2 = F.layer_norm(layers.linear(lyr["attn_out"], o), (d2,),
                      lyr["attn_ln"]["scale"], lyr["attn_ln"]["shift"],
                      LN_EPS)
    res2 = lyr["g2_res"]

    # g1: its MLP, the convolution with the neighbours' g1, grrg and drrd
    v1 = torch.tanh(layers.linear(lyr["g1_self"], g1))
    v2 = torch.sum(torch.matmul(g2, lyr["conv"]["w"]) * gg1, dim=1) \
        / float(cfg.repformer_sel)
    sym = torch.cat([_symmetrize(h2, g2s, cfg.repformer_axis,
                                 cfg.repformer_sel),
                     _symmetrize(h2, gg1, cfg.repformer_axis,
                                 cfg.repformer_sel)], dim=-1)
    v3 = torch.tanh(layers.linear(lyr["g1_mlp"], sym))
    res1 = lyr["g1_res"]
    return (g1 + res1[0] * v1 + res1[1] * v2 + res1[2] * v3,
            g2 + res2[0] * u1 + res2[1] * u2)


def repformer(params: Dict[str, Any], cfg: DPA2Config, g1: torch.Tensor,
              rij2: torch.Tensor, mask: torch.Tensor, nbr: torch.Tensor
              ) -> torch.Tensor:
    """The repformer layers on the second section (a ``dpa2.repformer``
    span: counters ``layers`` and ``slots``); g1 after the last."""
    with obs.span("dpa2.repformer", layers=len(params["repformers"]),
                  slots=int(rij2.shape[1])):
        env, sw = _switch(rij2, mask, cfg.repformer_rcut_smth,
                          cfg.repformer_rcut)
        h2 = env[..., 1:]
        g2 = torch.tanh(layers.linear(params["g2_embed"], env[..., :1]))
        gates = attention_gates(h2, sw, mask, cfg.attn2_hidden)
        for lyr in params["repformers"]:
            g1, g2 = repformer_layer(lyr, cfg, g1, g2, h2, sw, nbr, gates)
    return g1


def atomic_energy(params: Dict[str, Any], cfg: DPA2Config, rij: torch.Tensor,
                  nmask: torch.Tensor, atype: torch.Tensor,
                  mixed: torch.Tensor, sub: torch.Tensor) -> torch.Tensor:
    """E_i (A,) of the first section's pair vectors ``rij`` (A, S1, 3),
    ``mixed`` its neighbours' atom indices and ``sub`` the second
    section's slots in it (:func:`compact`). Every atom of the system is a
    row: the layers gather the neighbours' g1 from these rows."""
    tebd = type_embedding(params)
    g1 = repinit(params, cfg, rij, nmask, atype,
                 atype[torch.clamp(mixed, min=0)], tebd)
    rij2, mask, nbr = sub_section(rij, mixed, sub)
    g1 = repformer(params, cfg, g1, rij2, mask, nbr)
    return fitting(params["fit"], torch.cat([g1, tebd[atype]], dim=-1)) \
        + params["ebias"][atype]


def energy_forces(params: Dict[str, Any], cfg: DPA2Config, pos: torch.Tensor,
                  nlist: torch.Tensor, atype: torch.Tensor,
                  box: Optional[torch.Tensor] = None,
                  caps: Optional[Tuple[int, int]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Energy, forces, virial and both sections' excess (2,) from the
    engines' list ``nlist`` (the pairs within rcut + skin): the sections
    are compacted into ``caps`` slots (``cfg.sections`` by default)
    first."""
    mixed, sub, excess, _ = compact(pos, nlist, box, cfg,
                                    tuple(caps or cfg.sections))

    def energy(rij, nmask):
        return torch.sum(atomic_energy(params, cfg, rij, nmask, atype, mixed,
                                       sub))

    e, f, virial = dp_model.energy_forces_from_rij(energy, pos, mixed, box)
    return e, f, virial, excess

