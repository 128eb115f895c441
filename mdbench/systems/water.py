"""Water as the paper runs it (Sec. 4): a 64-molecule cell of 12.42 A
(rigid molecules, OH 0.9572 A, HOH 104.52 degrees, on a 4 x 4 x 4 sub-grid,
orientations from a fixed seed) replicated to size. The traffic file's
``system``: ``{"kind": "water", "cells": [nx, ny, nz],
"orientation_seed": s}``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

WATER_CELL_A = 12.42


def water(cells: Sequence[int], orientation_seed: int
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replicated 64-molecule water cells; types 0 = O, 1 = H."""
    rng = np.random.default_rng(orientation_seed)
    m = 4
    spacing = WATER_CELL_A / m
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    o_pos = (grid + 0.5) * spacing
    d_oh, ang = 0.9572, np.deg2rad(104.52)
    h1 = np.array([d_oh, 0.0, 0.0])
    h2 = np.array([d_oh * np.cos(ang), d_oh * np.sin(ang), 0.0])
    q = rng.normal(size=(len(o_pos), 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([
        np.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x**2 + z**2),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x**2 + y**2)], -1)], axis=1)
    cell_pos = np.concatenate([o_pos, o_pos + np.einsum("nij,j->ni", rot, h1),
                               o_pos + np.einsum("nij,j->ni", rot, h2)])
    cell_typ = np.concatenate([np.zeros(64, np.int32), np.ones(128, np.int32)])
    rep = np.stack(np.meshgrid(*[np.arange(c) for c in cells], indexing="ij"),
                   axis=-1).reshape(-1, 1, 3)
    pos = (cell_pos[None] + rep * WATER_CELL_A).reshape(-1, 3)
    return (pos, np.tile(cell_typ, int(np.prod(cells))),
            np.asarray(cells, float) * WATER_CELL_A)


def build(spec: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return water(spec["cells"], int(spec["orientation_seed"]))
