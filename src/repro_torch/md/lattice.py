"""System builders for the paper's copper benchmark (Sec. 4); a copy of the
parts of ``repro.md.lattice`` the port needs (numpy only).

Copper: perfect FCC lattice, lattice constant 3.634 A (paper value).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# atomic masses (amu)
MASS = {"Cu": 63.546, "O": 15.999, "H": 1.008}

FCC_CU_A = 3.634          # paper Sec. 4


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


def masses_for(type_map: Tuple[str, ...], types: np.ndarray) -> np.ndarray:
    table = np.array([MASS[t] for t in type_map])
    return table[types]
