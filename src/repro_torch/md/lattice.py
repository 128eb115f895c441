"""System builders for the paper's two benchmark systems (Sec. 4); a copy of
``repro.md.lattice`` (numpy only, so a seed gives the reference's atoms bit
for bit).

Copper: perfect FCC lattice, lattice constant 3.634 A (paper value).
Water: a 192-atom (64-molecule) cell replicated to size — a jittered cubic
molecular packing at liquid density (1 O : 2 H, ~0.997 g/cm^3), not an
equilibrated configuration.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# atomic masses (amu)
MASS = {"Cu": 63.546, "O": 15.999, "H": 1.008}

FCC_CU_A = 3.634          # paper Sec. 4
WATER_CELL_ATOMS = 192    # paper Sec. 4: 64 molecules
# 64 molecules in a cubic cell at ~0.997 g/cm^3 -> cell edge ~12.42 A
WATER_CELL_A = 12.42


def fcc_copper(nx: int, ny: int, nz: int, a: float = FCC_CU_A
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FCC lattice: returns (positions (N,3), types (N,), box (3,)). N = 4*nx*ny*nz."""
    base = np.array(
        [[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]
    )
    grid = np.stack(
        np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"),
        axis=-1,
    ).reshape(-1, 1, 3)
    pos = (grid + base[None, :, :]).reshape(-1, 3) * a
    box = np.array([nx * a, ny * a, nz * a])
    types = np.zeros(len(pos), dtype=np.int32)
    return pos.astype(np.float64), types, box.astype(np.float64)


def water_box(nx: int, ny: int, nz: int, seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replicated 64-molecule water cells. Types: 0 = O, 1 = H."""
    rng = np.random.default_rng(seed)
    # 4x4x4 molecular sub-grid inside one cell
    m = 4
    spacing = WATER_CELL_A / m
    grid = np.stack(
        np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), axis=-1
    ).reshape(-1, 3)
    o_pos = (grid + 0.5) * spacing                     # (64, 3) oxygen sites
    # rigid water geometry (OH 0.9572 A, HOH 104.52 deg), random orientation
    d_oh = 0.9572
    ang = np.deg2rad(104.52)
    h1 = np.array([d_oh, 0.0, 0.0])
    h2 = np.array([d_oh * np.cos(ang), d_oh * np.sin(ang), 0.0])

    def rand_rot(n):
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        w, x, y, z = q.T
        return np.stack(
            [
                np.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - w * z),
                          2 * (x * z + w * y)], -1),
                np.stack([2 * (x * y + w * z), 1 - 2 * (x**2 + z**2),
                          2 * (y * z - w * x)], -1),
                np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                          1 - 2 * (x**2 + y**2)], -1),
            ],
            axis=1,
        )

    rot = rand_rot(len(o_pos))
    h1r = np.einsum("nij,j->ni", rot, h1)
    h2r = np.einsum("nij,j->ni", rot, h2)
    cell_pos = np.concatenate([o_pos, o_pos + h1r, o_pos + h2r], axis=0)
    cell_typ = np.concatenate(
        [np.zeros(64, np.int32), np.ones(128, np.int32)]
    )

    # replicate
    rep = np.stack(
        np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 1, 3)
    pos = (cell_pos[None] + rep * WATER_CELL_A).reshape(-1, 3)
    types = np.tile(cell_typ, nx * ny * nz)
    box = np.array([nx, ny, nz]) * WATER_CELL_A
    return (pos.astype(np.float64), types.astype(np.int32),
            box.astype(np.float64))


def masses_for(type_map: Tuple[str, ...], types: np.ndarray) -> np.ndarray:
    table = np.array([MASS[t] for t in type_map])
    return table[types]
