"""Fitting net: descriptor -> atomic energy E_i (paper Sec. 2.1, Fig. 1d)."""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import layers
from repro_torch.core.types import DPConfig


def init_fitting_params(gen: torch.Generator, cfg: DPConfig,
                        dtype: torch.dtype, device: torch.device
                        ) -> Dict[str, Dict]:
    """One fitting net per center atom type: 3 hidden layers + linear head."""
    nets = {}
    for t in range(cfg.ntypes):
        hidden = layers.init_mlp(gen, cfg.fit_widths, cfg.descriptor_dim,
                                 dtype, device)
        head = layers.init_linear(gen, int(cfg.fit_widths[-1]), 1, dtype,
                                  device)
        nets[str(t)] = {"hidden": hidden, "head": head}
    return nets


def fitting_apply(net: Dict[str, Dict], d: torch.Tensor) -> torch.Tensor:
    """Descriptor (..., M< * M) -> per-atom energy (...,)."""
    h = layers.resnet_mlp(net["hidden"], d)
    e = layers.linear(net["head"], h)
    return e[..., 0]


def fitting_energy(fit_params: Dict[str, Dict], cfg: DPConfig,
                   d: torch.Tensor, atype: torch.Tensor) -> torch.Tensor:
    """Per-atom energies with the net selected by center type (``where`` mix)."""
    if cfg.ntypes == 1:
        return fitting_apply(fit_params["0"], d)
    e = torch.zeros(d.shape[:-1], dtype=d.dtype, device=d.device)
    for t in range(cfg.ntypes):
        e_t = fitting_apply(fit_params[str(t)], d)
        e = torch.where(atype == t, e_t, e)
    return e
