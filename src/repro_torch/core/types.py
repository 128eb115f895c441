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


@dataclasses.dataclass(frozen=True)
class DPA1Config:
    """DPA-1, the attention-based Deep Potential (Zhang et al.,
    arXiv:2208.08236), as DeePMD-kit's ``se_atten_v2`` descriptor writes it
    (``tebd_input_mode`` "strip", ``smooth_type_embedding``) with one
    type-conditioned fitting net.

    Unlike :class:`DPConfig`, ``sel`` is ONE mixed-type section: the
    neighbours of any type within ``rcut``, ``sel`` slots (also the
    descriptor's normalization). The MD engines' list holds the pairs
    within rcut + skin in type sections, and the model compacts the pairs
    within rcut into its own section every step. The attention weights
    are always gated by r^_j . r^_k (``attn_dotr``, as published).
    """

    ntypes: int = 2
    rcut: float = 6.0
    rcut_smth: float = 0.5
    sel: int = 120
    type_map: Tuple[str, ...] = ("O", "H")
    embed_widths: Tuple[int, ...] = (25, 50, 100)   # N_s and N_t
    axis_neuron: int = 16
    tebd_dim: int = 8            # type embedding width
    attn: int = 128              # q/k/v width
    attn_layer: int = 2
    fit_widths: Tuple[int, ...] = (240, 240, 240)
    dtype: str = "float32"

    @property
    def nsel(self) -> int:
        return int(self.sel)

    @property
    def m_embed(self) -> int:
        return int(self.embed_widths[-1])

    @property
    def descriptor_dim(self) -> int:
        return self.axis_neuron * self.m_embed

    def validate(self) -> None:
        if len(self.type_map) != self.ntypes:
            raise ValueError("type_map must name every type")
        for a, b in zip(self.embed_widths[:-1], self.embed_widths[1:]):
            if b not in (a, 2 * a):
                raise ValueError("embedding widths must double or repeat")
        if self.axis_neuron > self.m_embed:
            raise ValueError("axis_neuron must not exceed the embedding width")
        if self.attn_layer < 0 or self.sel < 1:
            raise ValueError("need sel >= 1 and attn_layer >= 0")


# DeePMD-kit's examples/water/se_atten (se_atten_v2) at its published widths.
WATER_DPA1 = DPA1Config()


@dataclasses.dataclass(frozen=True)
class DPA2Config:
    """DPA-2 (Zhang et al., arXiv:2312.15492) as DeePMD-kit's ``dpa2``
    descriptor writes it: a *repinit* block (DPA-1's embedding in
    ``concat`` mode, no attention) over one mixed section within ``rcut``,
    then ``repformer_layers`` *repformer* layers over a second mixed
    section within ``repformer_rcut``, with one fitting net on
    [g1, tebd(t_i)].

    Two model sections, each with its own cut-offs and ``sel`` (also its
    normalization): ``sel`` slots within ``rcut`` (repinit) and
    ``repformer_sel`` within ``repformer_rcut``, taken from the first. The
    MD engines' list holds the pairs within rcut + skin in type sections,
    as for DPA-1.
    """

    ntypes: int = 2
    type_map: Tuple[str, ...] = ("O", "H")
    tebd_dim: int = 8
    rcut: float = 6.0                 # repinit's section
    rcut_smth: float = 0.5
    sel: int = 120
    repinit_widths: Tuple[int, ...] = (25, 50, 100)
    repinit_axis: int = 12
    repformer_rcut: float = 4.0       # the repformers' section
    repformer_rcut_smth: float = 3.5
    repformer_sel: int = 40
    repformer_layers: int = 6
    g1_dim: int = 128
    g2_dim: int = 32
    attn2_hidden: int = 32            # each head's q/k width
    attn2_heads: int = 4
    repformer_axis: int = 4           # the columns of grrg and drrd
    fit_widths: Tuple[int, ...] = (240, 240, 240)
    dtype: str = "float32"

    #: the model's sections, outer first
    SECTIONS = ("repinit", "repformer")

    @property
    def sections(self) -> Tuple[int, int]:
        return (int(self.sel), int(self.repformer_sel))

    @property
    def repinit_dim(self) -> int:
        return self.repinit_axis * int(self.repinit_widths[-1])

    @property
    def g1_mlp_dim(self) -> int:
        """grrg and drrd side by side."""
        return self.repformer_axis * (self.g2_dim + self.g1_dim)

    def validate(self) -> None:
        if len(self.type_map) != self.ntypes:
            raise ValueError("type_map must name every type")
        for a, b in zip(self.repinit_widths[:-1], self.repinit_widths[1:]):
            if b not in (a, 2 * a):
                raise ValueError("repinit widths must double or repeat")
        if self.repinit_axis > self.repinit_widths[-1]:
            raise ValueError("repinit_axis must not exceed its width")
        if self.repformer_axis > min(self.g1_dim, self.g2_dim):
            raise ValueError("repformer_axis must not exceed g1 and g2")
        if not 0 < self.repformer_rcut <= self.rcut:
            raise ValueError("the repformers' cut-off lies within rcut")
        if self.sel < 1 or self.repformer_sel < 1 \
                or self.repformer_layers < 0:
            raise ValueError("need sel, repformer_sel >= 1 and "
                             "repformer_layers >= 0")


# DeePMD-kit's examples/water/dpa2 at its published widths.
WATER_DPA2 = DPA2Config()
