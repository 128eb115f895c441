"""Embedding net: the scalar->R^M map g (paper Eq. 3-5).

The embedding net maps each component of s(r_ij) to one row of the
embedding matrix G_i. It is exactly the function the paper tabulates:
a 3-hidden-layer residual MLP with widths (d1, 2*d1, 4*d1).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from repro_torch.core import layers
from repro_torch.core.types import DPConfig


def init_embedding_params(gen: torch.Generator, cfg: DPConfig,
                          dtype: torch.dtype, device: torch.device
                          ) -> Dict[str, List[layers.Layer]]:
    """One residual MLP per embedding-net index.

    type_one_side=True : index = neighbor type            (ntypes nets)
    type_one_side=False: index = center * ntypes + nbr    (ntypes^2 nets)
    """
    return {str(i): layers.init_mlp(gen, cfg.embed_widths, 1, dtype, device)
            for i in range(cfg.n_embed_nets)}


def embed_net_apply(net: List[layers.Layer], s: torch.Tensor) -> torch.Tensor:
    """Apply one embedding net to scalars s (...,) -> G rows (..., M)."""
    return layers.resnet_mlp(net, s[..., None])


def embedding_scalar_fn(net: List[layers.Layer]
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """g: R -> R^M as a function of a batch of scalars — the tabulation target."""

    def g(x: torch.Tensor) -> torch.Tensor:
        return embed_net_apply(net, x)

    return g


def embed_index(cfg: DPConfig, center_type: int, nbr_type: int) -> int:
    if cfg.type_one_side:
        return nbr_type
    return center_type * cfg.ntypes + nbr_type
