"""Deep Potential model assembly: energy, forces, virial; impl dispatch.

The implementation ladder follows the paper's optimization story:

  impl="mlp"         baseline — full embedding-net matmuls, G materialized
  impl="quintic"     + Sec. 3.2 tabulation (fifth-order polynomials)
  impl="cheb"        + Chebyshev tabulation (basis matmul, plain torch)
  impl="cheb_pallas" + Sec. 3.4.1 kernel fusion and Sec. 3.4.2 redundancy
                       removal: the hand-written CUDA kernel pair in
                       ``repro_torch.kernels.dp_fused`` (G never
                       materialized), and the environment matrix as one
                       kernel each way (``kernels/dp_fused/env.py``). The
                       rung keeps the reference's name.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import descriptor, embedding, fitting, tabulation
from repro_torch.core.types import DPConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dp_fused import env as env_ops
from repro_torch.kernels.dp_fused import force as force_ops
from repro_torch.kernels.dp_fused import ops as dp_fused_ops

def _dtype(cfg: DPConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_dp_params(gen: torch.Generator, cfg: DPConfig,
                   dstd: Optional[torch.Tensor] = None,
                   device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Initialize a Deep Potential parameter dict (the reference pytree's
    keys: ``embed``, ``fit``, ``dstd``, ``ebias``) from a generator."""
    cfg.validate()
    dev = resolve_device(device)
    dt = _dtype(cfg)
    if dstd is None:
        dstd = torch.ones((cfg.ntypes, 4), dtype=dt)
    return {
        "embed": embedding.init_embedding_params(gen, cfg, dt, dev),
        "fit": fitting.init_fitting_params(gen, cfg, dt, dev),
        "dstd": dstd.to(device=dev, dtype=dt),
        "ebias": torch.zeros((cfg.ntypes,), dtype=dt, device=dev),
    }


def tabulate_model(params: Dict[str, Any], cfg: DPConfig,
                   kind: str = "quintic", step: Optional[float] = None,
                   order: Optional[int] = None) -> Dict[str, Any]:
    """Compress the embedding nets into tables (paper Sec. 3.2).

    Returns a new params dict with a "table" entry on the params' device;
    the embedding MLP weights are kept but unused by tabulated impls.
    """
    if kind not in ("quintic", "cheb"):
        raise ValueError(f"unknown table kind {kind}")
    dev = params["dstd"].device
    tables = {}
    with torch.no_grad():
        for idx, net in params["embed"].items():
            g = embedding.embedding_scalar_fn(net)
            if kind == "quintic":
                tables[idx] = tabulation.build_quintic_table(
                    g, cfg.table_lower, cfg.table_upper,
                    step or cfg.table_step, dev)
            else:
                tables[idx] = tabulation.build_cheb_table(
                    g, cfg.table_lower, cfg.table_upper,
                    order or cfg.cheb_order, dev)
    out = dict(params)
    out["table"] = {"nets": tables}
    return out


def _t_matrix_onetype(params, cfg: DPConfig, impl: str, center_type: int,
                      env_n: torch.Tensor, s_n: torch.Tensor) -> torch.Tensor:
    """T = R~^T G (..., 4, M) for a fixed center type."""
    t_mat = None
    for nbr_type, (a, b) in enumerate(cfg.sel_sections()):
        key = str(embedding.embed_index(cfg, center_type, nbr_type))
        env_sec = env_n[..., a:b, :]                     # (..., sel_t, 4)
        s_sec = s_n[..., a:b]
        if impl == "cheb_pallas":
            table = params["table"]["nets"][key]
            # the domain bounds come from cfg, as in the reference
            part = dp_fused_ops.fused_env_tab_contract(
                env_sec, s_sec, table["coeffs"], cfg.table_lower,
                cfg.table_upper)
        else:
            if impl == "mlp":
                g_sec = embedding.embed_net_apply(params["embed"][key], s_sec)
            elif impl == "cheb":
                g_sec = tabulation.cheb_eval(params["table"]["nets"][key],
                                             s_sec)
            elif impl == "quintic":
                g_sec = tabulation.quintic_eval(
                    params["table"]["nets"][key], s_sec)
            else:
                raise ValueError(f"unknown impl {impl!r}")
            part = torch.einsum("...na,...nm->...am", env_sec, g_sec)
        t_mat = part if t_mat is None else t_mat + part
    return t_mat


def dp_atomic_energy(params: Dict[str, Any], cfg: DPConfig, rij: torch.Tensor,
                     nmask: torch.Tensor, atype: torch.Tensor,
                     impl: Optional[str] = None,
                     nsel_norm: Optional[int] = None,
                     comm: Optional[Any] = None) -> torch.Tensor:
    """Per-atom potential energies E_i.

    Args:
      rij:   (..., Na, Nm, 3) relative neighbor positions.
      nmask: (..., Na, Nm) neighbor validity.
      atype: (..., Na) center atom types.
      nsel_norm: the model's native neighbor capacity, which pins the
        descriptor normalization when ``cfg.sel`` has been escalated (or is
        one model shard's slice of it).
      comm: a rank of ``md.comm`` whose model-axis shards each hold a slice
        of every atom's neighbor slots (``cfg.sel`` describes the slice): the
        partial T matrices are summed over the model axis before the
        descriptor, with an identity backward, so each shard's autograd
        gives its own slice's part of the forces (the distributed step sums
        the forces over the model axis after the backward pass).
    """
    impl = impl or cfg.impl
    if impl == "cheb_pallas":
        # one hand-written kernel each way (inference only: no double
        # backward); the other rungs keep the plain ops, which training needs
        env_n, s_n = env_ops.env_mat(rij, nmask, atype, params["dstd"],
                                     cfg.rcut_smth, cfg.rcut)
    else:
        env, s = descriptor.env_matrix(rij, nmask, cfg.rcut_smth, cfg.rcut)
        env_n, s_n = descriptor.normalize_env(env, s, atype, params["dstd"])

    if cfg.ntypes == 1 or cfg.type_one_side:
        t_mat = _t_matrix_onetype(params, cfg, impl, 0, env_n, s_n)
    else:
        t_mat = None
        for ct in range(cfg.ntypes):
            t_ct = _t_matrix_onetype(params, cfg, impl, ct, env_n, s_n)
            sel = (atype == ct)[..., None, None]
            t_mat = torch.where(sel, t_ct, 0.0 if t_mat is None else t_mat)

    if comm is not None:
        t_mat = comm.psum_same_grad(t_mat, comm.MODEL)
    d = descriptor.descriptor_from_t(t_mat, cfg.axis_neuron,
                                     nsel_norm or cfg.nsel)
    e_i = fitting.fitting_energy(params["fit"], cfg, d, atype)
    return e_i + params["ebias"][atype]


def dp_energy(params: Dict[str, Any], cfg: DPConfig, rij: torch.Tensor,
              nmask: torch.Tensor, atype: torch.Tensor, amask: torch.Tensor,
              impl: Optional[str] = None,
              nsel_norm: Optional[int] = None) -> torch.Tensor:
    """Total energy E = sum_i E_i over valid atoms."""
    e_i = dp_atomic_energy(params, cfg, rij, nmask, atype, impl,
                           nsel_norm=nsel_norm)
    return torch.sum(e_i * amask, dim=-1)


def gather_rij(pos: torch.Tensor, nlist: torch.Tensor,
               box: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relative positions from a neighbor index list.

    nlist: (Na, Nm) indices into pos, -1 for padding. With ``box``
    (orthorhombic lengths (3,)) the minimum-image convention is applied.
    """
    nmask = nlist >= 0
    j = torch.clamp(nlist, min=0)
    rij = pos[j] - pos[:, None, :]
    if box is not None:
        rij = rij - box * torch.round(rij / box)
    rij = torch.where(nmask[..., None], rij, 0.0)
    return rij, nmask


def energy_forces_from_rij(energy_of_rij, pos: torch.Tensor,
                           nlist: torch.Tensor,
                           box: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Energy, forces and virial of any pair-list energy ``E(r_ij, nmask)``.

    Forces come from reverse-mode autodiff with respect to r_ij (the paper's
    backward propagation); the virial is the pair-wise contraction
    W = -sum_ij r_ij (x) dE/dr_ij. The graph lives only inside this call:
    the returned tensors are detached.

    The reduction to atoms is ``kernels.dp_fused.force.prod_force_virial``:
    on the card a hand-written kernel whose neighbour-side sums are
    atomics, so the forces' summation order (and last bits) varies from
    run to run; on the CPU the plain version, where padded slots add their
    zero into atom 0, as in the reference.
    """
    with torch.no_grad():
        rij, nmask = gather_rij(pos, nlist, box)
    with torch.enable_grad():
        rij = rij.requires_grad_(True)
        e = energy_of_rij(rij, nmask)
        (de_drij,) = torch.autograd.grad(e, rij)

    # Pair forces: f_ij = -dE/dr_ij acts on atom j, reaction +dE/dr_ij on i.
    f, virial = force_ops.prod_force_virial(
        de_drij.contiguous(), rij.detach(), nlist.contiguous(), pos.shape[0])
    return e.detach(), f, virial


def dp_energy_forces(params: Dict[str, Any], cfg: DPConfig, pos: torch.Tensor,
                     nlist: torch.Tensor, atype: torch.Tensor,
                     box: Optional[torch.Tensor] = None,
                     impl: Optional[str] = None,
                     nsel_norm: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-process energy, forces, virial (see ``energy_forces_from_rij``).

    ``nsel_norm`` pins the descriptor normalization to the model's native
    neighbor capacity when ``cfg.sel`` has been escalated past it.
    """
    amask = torch.ones(pos.shape[0], dtype=_dtype(cfg), device=pos.device)

    def energy(rij, nmask):
        return dp_energy(params, cfg, rij, nmask, atype, amask, impl,
                         nsel_norm=nsel_norm)

    return energy_forces_from_rij(energy, pos, nlist, box)
