"""Configuration dataclasses for the Deep Potential model (copy of
``repro.core.types``; the port keeps its own so it never imports ``repro``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Deep Potential (se_e2_a descriptor) model configuration.

    Mirrors the paper's setup: 3-hidden-layer embedding net (d1, 2*d1, 4*d1),
    3-hidden-layer fitting net with shortcut connections, symmetry-preserving
    descriptor D = (G<)^T R~ R~^T G.
    """

    # --- physics ---
    ntypes: int = 1
    rcut: float = 8.0           # cutoff radius (Angstrom); paper: Cu 8, H2O 6
    rcut_smth: float = 2.0      # switching-function onset radius
    sel: Tuple[int, ...] = (512,)   # max neighbors per neighbor-type section
    type_map: Tuple[str, ...] = ("Cu",)

    # --- embedding net ---
    embed_widths: Tuple[int, ...] = (32, 64, 128)   # d1, 2*d1, 4*d1 (= M)
    axis_neuron: int = 16                           # M< (sub-matrix columns)
    type_one_side: bool = True   # nets indexed by neighbor type only

    # --- fitting net ---
    fit_widths: Tuple[int, ...] = (240, 240, 240)

    # --- implementation selection (the paper's optimization ladder) ---
    # "mlp"         : baseline, full embedding-net matmuls (pre-optimization)
    # "quintic"     : fifth-order polynomial tabulation (paper Sec. 3.2)
    # "cheb"        : Chebyshev basis-matmul tabulation (plain torch)
    # "cheb_pallas" : the fused tabulation + R~^T G contraction kernel; in
    #                 this package a hand-written CUDA kernel (the rung keeps
    #                 its reference name so specs match across packages)
    impl: str = "mlp"

    # --- tabulation parameters ---
    table_step: float = 0.01     # quintic interval size (paper default 0.01)
    table_lower: float = -2.0    # domain of the normalized s input
    table_upper: float = 10.0
    cheb_order: int = 32         # Chebyshev expansion order K

    # --- numerics ---
    dtype: str = "float32"

    @property
    def nsel(self) -> int:
        return int(sum(self.sel))

    @property
    def m_embed(self) -> int:
        """M: embedding output width."""
        return int(self.embed_widths[-1])

    @property
    def n_embed_nets(self) -> int:
        return self.ntypes if self.type_one_side else self.ntypes * self.ntypes

    @property
    def descriptor_dim(self) -> int:
        return self.axis_neuron * self.m_embed

    def sel_sections(self) -> Tuple[Tuple[int, int], ...]:
        """(start, stop) slot ranges of each neighbor-type section."""
        out = []
        off = 0
        for s in self.sel:
            out.append((off, off + int(s)))
            off += int(s)
        return tuple(out)

    def validate(self) -> None:
        if len(self.sel) != self.ntypes:
            raise ValueError("sel must have one entry per type")
        if len(self.embed_widths) < 1:
            raise ValueError("embed_widths must not be empty")
        for a, b in zip(self.embed_widths[:-1], self.embed_widths[1:]):
            if b not in (a, 2 * a):
                raise ValueError("embedding widths must double or repeat")
        if self.axis_neuron > self.m_embed:
            raise ValueError("axis_neuron must not exceed the embedding width")
        if self.impl not in ("mlp", "quintic", "cheb", "cheb_pallas"):
            raise ValueError(f"unknown impl {self.impl!r}")


# Paper's two physical systems (Sec. 4).
WATER_DP = DPConfig(
    ntypes=2,
    rcut=6.0,
    rcut_smth=0.5,
    sel=(46, 92),            # O, H sections; total 138 = paper's water N_m
    type_map=("O", "H"),
    embed_widths=(32, 64, 128),
    axis_neuron=16,
    fit_widths=(240, 240, 240),
)

COPPER_DP = DPConfig(
    ntypes=1,
    rcut=8.0,
    rcut_smth=2.0,
    sel=(512,),              # paper's copper N_m (high-pressure headroom)
    type_map=("Cu",),
    embed_widths=(32, 64, 128),
    axis_neuron=16,
    fit_widths=(240, 240, 240),
)
