"""N-D Cartesian brick decomposition: the ``Topology`` abstraction — the
counterpart of ``repro.md.topology``, kept as its own copy.

The paper reaches 10-billion atoms by cutting the simulation cell into 3-D
sub-regions spread over the whole machine (its 100M-atom predecessor details
the same 3-D ghost-region scheme); a 1-D slab layout caps the spatial rank
count at ``floor(Lx / rcut)`` — a hard weak-scaling ceiling. This module is
the pure-geometry half of the generalization: a brick shape like ``(4,)``,
``(2, 4)`` or ``(2, 2, 2)`` over the flattened ``spatial`` mesh axis, with

  * rank <-> brick-coordinate maps (C-order: the LAST shape axis varies
    fastest, so a ``(k,)`` topology is the identity map onto the legacy
    slab ring — the degenerate case is bit-exact by construction);
  * per-axis ``ppermute`` rings (``md/comm.py``) (plus/minus one brick along one axis with
    periodic wrap) — the communication pattern of the staged axis sweeps:
    halo exchange and migration run x-then-y-then-z, which routes edge and
    corner ghosts/migrants through two or three axis-aligned exchanges
    instead of 26 explicit neighbor sends (the standard staged-sweep trick);
  * per-axis brick widths derived from any (launch-time or carried) box.

Everything here is host-side Python over ints; :meth:`coord_along` also
takes an integer tensor (plain ``//``/``%``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class Topology:
    """Brick counts per decomposed spatial axis (axis 0 = x, 1 = y, 2 = z).

    Ranks flatten in C order (last axis fastest): for shape ``(sx, sy, sz)``
    rank ``r`` sits at ``(r // (sy*sz), (r // sz) % sy, r % sz)``. Axes not
    named in the shape are undecomposed — the whole box, periodic via
    min-image, exactly like y/z under the legacy 1-D slab layout.
    """

    shape: Tuple[int, ...]

    def __post_init__(self):
        shape = tuple(int(s) for s in self.shape)
        object.__setattr__(self, "shape", shape)
        if not 1 <= len(shape) <= 3:
            raise ValueError(f"topology decomposes 1-3 spatial axes, "
                             f"got shape {shape}")
        if any(s < 2 for s in shape):
            raise ValueError(
                f"every decomposed axis needs >= 2 bricks (ghost images "
                f"must not alias their owners); drop axes with 1 brick from "
                f"the shape instead — got {shape}")

    @classmethod
    def parse(cls, text) -> "Topology":
        """``"2x2x2"`` / ``"2,4"`` / ``"4"`` / an int / a tuple -> Topology."""
        if isinstance(text, Topology):
            return text
        if isinstance(text, int):
            return cls((text,))
        if isinstance(text, (tuple, list)):
            return cls(tuple(int(s) for s in text))
        parts = str(text).lower().replace(",", "x").split("x")
        return cls(tuple(int(p) for p in parts if p))

    # ------------------------------------------------------------- geometry

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def n_ranks(self) -> int:
        return math.prod(self.shape)

    @property
    def axes(self) -> Tuple[int, ...]:
        """The decomposed spatial axes, in sweep order (x, then y, then z)."""
        return tuple(range(self.ndim))

    @property
    def strides(self) -> Tuple[int, ...]:
        """C-order rank strides: ``rank = sum(coord[a] * strides[a])``."""
        out, acc = [], 1
        for s in reversed(self.shape):
            out.append(acc)
            acc *= s
        return tuple(reversed(out))

    def widths(self, box) -> Tuple[float, ...]:
        """Per-decomposed-axis brick width for a host-side ``box``."""
        return tuple(float(box[a]) / self.shape[a] for a in self.axes)

    def label(self) -> str:
        return "x".join(str(s) for s in self.shape)

    # ------------------------------------------------------ rank <-> coords

    def coords_of(self, rank: int) -> Tuple[int, ...]:
        return tuple((rank // st) % s for st, s in zip(self.strides,
                                                      self.shape))

    def rank_of(self, coords) -> int:
        assert len(coords) == self.ndim, (coords, self.shape)
        return sum((int(c) % s) * st
                   for c, s, st in zip(coords, self.shape, self.strides))

    def coord_along(self, rank, axis: int):
        """Brick coordinate along ``axis`` — works on ints and on integer
        tensors (plain ``//``/``%``)."""
        return (rank // self.strides[axis]) % self.shape[axis]

    # ------------------------------------------------------- ppermute rings

    def ring(self, axis: int, step: int) -> List[Tuple[int, int]]:
        """``(src, dst)`` pairs shifting every rank ``step`` bricks along
        ``axis`` (periodic). ``ring(a, +1)`` sends to the plus neighbor,
        ``ring(a, -1)`` to the minus neighbor. For a ``(k,)`` topology these
        are exactly the legacy slab ring's ``right``/``left`` pair lists.
        """
        pairs = []
        for r in range(self.n_ranks):
            c = list(self.coords_of(r))
            c[axis] = (c[axis] + step) % self.shape[axis]
            pairs.append((r, self.rank_of(c)))
        return pairs

    def plus_ring(self, axis: int) -> List[Tuple[int, int]]:
        return self.ring(axis, +1)

    def minus_ring(self, axis: int) -> List[Tuple[int, int]]:
        return self.ring(axis, -1)
