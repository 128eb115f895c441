"""An FCC lattice (the paper's copper, Sec. 4: a = 3.634 A). The traffic
file's ``system``: ``{"kind": "fcc", "cells": [nx, ny, nz], "lattice_a": a}``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def fcc(cells: Sequence[int], a: float) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """FCC lattice of ``cells`` unit cells: (pos (N, 3), types, box (3,))."""
    base = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                     [0.0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*[np.arange(c) for c in cells],
                                indexing="ij"), axis=-1).reshape(-1, 1, 3)
    pos = (grid + base[None]).reshape(-1, 3) * a
    box = np.asarray(cells, float) * a
    return pos, np.zeros(len(pos), np.int32), box


def build(spec: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return fcc(spec["cells"], float(spec["lattice_a"]))
