"""Shared MLP building blocks for embedding and fitting nets."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

Layer = Dict[str, torch.Tensor]


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype, device: torch.device) -> Layer:
    """DeePMD-style init: weights ~ N(0, 1/sqrt(d_in+d_out)), bias ~ N(0, 0.1).

    Draws on the generator's device (the CPU for a default generator), so a
    seed gives the same weights whatever ``device`` they are moved to.
    """
    std = 1.0 / float(d_in + d_out) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen) * std
    b = torch.randn((d_out,), generator=gen) * 0.1
    return {"w": w.to(device=device, dtype=dtype),
            "b": b.to(device=device, dtype=dtype)}


def init_mlp(gen: torch.Generator, widths: Sequence[int], d_in: int,
             dtype: torch.dtype, device: torch.device) -> List[Layer]:
    layers = []
    prev = d_in
    for w in widths:
        layers.append(init_linear(gen, prev, int(w), dtype, device))
        prev = int(w)
    return layers


def resnet_mlp(layers: List[Layer], x: torch.Tensor) -> torch.Tensor:
    """DeePMD residual MLP (paper Eq. 4-5).

    Layer widths may repeat (identity shortcut), double (duplicated shortcut
    ``(x, x)``), or change arbitrarily (no shortcut, first layer).
    tanh activation throughout (paper Sec. 3.5.3: chosen for accuracy).
    """
    h = x
    for lyr in layers:
        d_in, d_out = lyr["w"].shape
        y = torch.tanh(h @ lyr["w"] + lyr["b"])
        if d_out == d_in:
            h = h + y
        elif d_out == 2 * d_in:
            h = torch.cat([h, h], dim=-1) + y
        else:
            h = y
    return h


def linear(params: Layer, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]
