"""O(N) cell-list neighbor search inside one brick (+ ghost shell) — the
counterpart of ``repro.md.slab_cells``.

Geometry is static per ``DomainSpec``: on every DECOMPOSED axis the brick
frame spans [-rc_halo, width_a + rc_halo) (ghosts included, non-periodic —
ghosts ARE the periodicity there), undecomposed axes are periodic via
min-image. All shapes are static (fixed cell capacity, fixed slot layout):
overflow is reported through a flag, never a host read, so the search runs
inside the distributed step. The brute-force O(N^2) search in
``md/domain.py`` is for tests.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import DPConfig
from repro_torch.md.neighbors import GRID_INVALID, pack_type_sections


def _allowed(n: int, periodic: bool):
    # With <3 cells on a periodic dim, +/-1 offsets alias the same cell
    # (duplicate candidates); keep a duplicate-free covering stencil.
    # Non-periodic dims keep the full stencil: out-of-range offsets are
    # routed to the always-empty dump row instead of wrapping.
    if n >= 3 or not periodic:
        return [-1, 0, 1]
    return [-1, 0] if n == 2 else [0]


def static_grid(box: Tuple[float, float, float], slab_width: float,
                rc_halo: float, topology: Optional[Tuple[int, ...]] = None
                ) -> Tuple[List[int], List[float]]:
    """The brick frame's static cell grid: cells per axis and cell size per
    axis (A). Decomposed axes span the brick + ghost shell (non-periodic —
    ghosts cover the wrap), undecomposed axes the full box (periodic)."""
    ndim = len(topology) if topology is not None else 1
    ncs, cs = [], []
    for a in range(3):
        if a >= ndim:
            span = float(box[a])
        elif topology is not None:
            span = float(box[a]) / int(topology[a]) + 2 * rc_halo
        else:
            span = float(slab_width) + 2 * rc_halo
        nc = max(int(np.floor(span / rc_halo)), 1)
        ncs.append(nc)
        cs.append(span / nc)
    return ncs, cs


def make_slab_neighbor_fn(cfg: DPConfig, box: Tuple[float, float, float],
                          slab_width: float, rc_halo: float,
                          n_centers: int, cell_capacity: int = 96,
                          topology: Optional[Tuple[int, ...]] = None):
    """Neighbor lists for ``n_centers`` center atoms of a brick array.

    Returns fn(pos_all, typ_all, mask_all, brick_lo, center_start=0,
    box=None, widths=None) -> (nlist (n_centers, nsel) int64, overflow 0-d
    int32). ``center_start`` is the first center row (model shards pass
    ``model_index * n_centers`` in atom decomposition). pos_all = owned
    atoms then the staged-sweep ghosts; nlist indexes pos_all rows.
    ``brick_lo`` is the brick's low-face position: a scalar (the x face) or
    a (3,) vector (undecomposed entries ignored).

    ``topology`` names the decomposed axes (``None`` -> a ``(k,)`` x-slab
    layout whose x-width is ``slab_width``). The cell COUNTS are static,
    derived from the launch-time ``box`` / brick widths given here; the
    optional per-call ``box``/``widths`` (tensors of the carried box under a
    barostat) move the cell SIZES. If the carried box shrinks until a cell
    dimension no longer covers ``rc_halo`` (the stencil would miss pairs),
    the overflow flag returns ``>= GRID_INVALID`` — geometry, not capacity.
    """
    rc2 = rc_halo * rc_halo
    shape = tuple(int(s) for s in topology) if topology is not None else None
    ndim = len(shape) if shape is not None else 1
    box_static = tuple(float(b) for b in box)
    if shape is not None:
        widths_static = tuple(box_static[a] / shape[a] for a in range(ndim))
    else:
        widths_static = (float(slab_width),)
    decomposed = tuple(a < ndim for a in range(3))
    ncs, cs0 = static_grid(box, slab_width, rc_halo, topology)
    ncx, ncy, ncz = ncs
    ncells = ncx * ncy * ncz
    cap = int(cell_capacity)

    offsets_np = np.array([
        (ox, oy, oz)
        for ox in _allowed(ncx, not decomposed[0])
        for oy in _allowed(ncy, not decomposed[1])
        for oz in _allowed(ncz, not decomposed[2])
    ])
    # host constants copied to each device once: a copy from host memory
    # waits for the stream, and the distributed step must not wait
    consts = {}

    def fn(pos_all, typ_all, mask_all, brick_lo, center_start=0,
           box=None, widths=None):
        dev = pos_all.device
        f32 = pos_all.dtype
        if dev not in consts:
            consts[dev] = (
                torch.as_tensor(offsets_np, device=dev),
                torch.tensor(decomposed, device=dev),
                torch.tensor([1e30 if decomposed[a] else box_static[a]
                              for a in range(3)], dtype=f32, device=dev))
        offsets, dec_t, box_launch = consts[dev]
        lo_v = torch.as_tensor(brick_lo, dtype=f32, device=dev).reshape(-1)
        lo = [lo_v[min(a, lo_v.shape[0] - 1)] if decomposed[a] else 0.0
              for a in range(3)]
        if box is None:
            cs = list(cs0)
            grid_bad = torch.zeros((), dtype=torch.int32, device=dev)
            boxj = box_launch
        else:
            # dynamic geometry from the carried box: static counts, sizes
            # from the box — flag the grid when a cell stops covering rc_halo
            cs = []
            for a in range(3):
                if decomposed[a]:
                    w = (widths[a] if widths is not None
                         else widths_static[a])
                    cs.append((w + 2 * rc_halo) / ncs[a])
                else:
                    cs.append(box[a] / ncs[a])
            grid_bad = torch.zeros((), dtype=torch.bool, device=dev)
            for a in range(3):
                grid_bad = grid_bad | torch.as_tensor(cs[a] < rc_halo,
                                                      device=dev)
            grid_bad = grid_bad.to(torch.int32)
            # min-image on undecomposed axes only: decomposed axes are
            # ghost-resolved (see domain.py)
            boxj = torch.where(dec_t, 1e30, box)
        n_all = pos_all.shape[0]
        # per-axis cell index: brick frame (shifted so the low ghost shell
        # starts at 0, clipped) on decomposed axes; periodic bins elsewhere
        cidx = []
        for a in range(3):
            if decomposed[a]:
                xf = pos_all[:, a] - lo[a] + rc_halo
                cidx.append(torch.clamp((xf / cs[a]).to(torch.int64),
                                        0, ncs[a] - 1))
            else:
                cidx.append(torch.floor(pos_all[:, a] / cs[a])
                            .to(torch.int64) % ncs[a])
        ci, cj, ck = cidx
        cflat = (ci * ncy + cj) * ncz + ck
        cflat = torch.where(mask_all, cflat, ncells)         # park invalid

        order = torch.argsort(cflat, stable=True)
        sorted_cells = cflat[order]
        starts = torch.searchsorted(
            sorted_cells, torch.arange(ncells + 1, device=dev))
        rank = torch.arange(n_all, device=dev) - starts[sorted_cells]
        # row ncells: parked invalid atoms; row ncells+1: ALWAYS EMPTY —
        # the dump target for out-of-range stencil cells (distinct rows, or
        # padding atoms would leak back in as candidates).
        # rank is in SORTED atom order — align the validity mask before
        # reducing, or parked atoms' ranks (bin ncells) leak into the max.
        cell_ovf = (torch.max(torch.where(mask_all[order], rank, 0))
                    - (cap - 1)).to(torch.int32)
        # atoms past the capacity go to one spare entry past the table
        spare = (ncells + 2) * cap
        flat = torch.where(rank < cap, sorted_cells * cap + rank, spare)
        table = torch.full((spare + 1,), -1, dtype=torch.int64, device=dev)
        table = table.scatter_(0, flat, order)[:spare].view(ncells + 2, cap)

        start = int(center_start)
        rows = slice(start, start + n_centers)
        nbr3 = torch.stack([ci[rows], cj[rows], ck[rows]], -1)
        nbr3 = nbr3[:, None, :] + offsets[None, :, :]
        # decomposed axes are NON-periodic in the brick frame (ghosts cover
        # the wrap): out-of-range stencil cells go to the dump row
        valid_cell = torch.ones(nbr3.shape[:-1], dtype=torch.bool,
                                device=dev)
        nbrc = []
        for a in range(3):
            if decomposed[a]:
                valid_cell = valid_cell & (nbr3[..., a] >= 0) \
                    & (nbr3[..., a] <= ncs[a] - 1)
                nbrc.append(torch.clamp(nbr3[..., a], 0, ncs[a] - 1))
            else:
                nbrc.append(nbr3[..., a] % ncs[a])
        nbrflat = (nbrc[0] * ncy + nbrc[1]) * ncz + nbrc[2]
        nbrflat = torch.where(valid_cell, nbrflat, ncells + 1)
        cand = table[nbrflat].reshape(n_centers, len(offsets_np) * cap)
        self_idx = start + torch.arange(n_centers, device=dev)[:, None]
        cand = torch.where(cand == self_idx, -1, cand)

        # Gate by CENTER validity too (as the brute-force search does): an
        # invalidated slot can hold a stale copy of a migrated atom whose
        # live ghost sits at the SAME coordinates — a d2 == 0 "pair" whose
        # norm has a NaN gradient that survives the energy mask (0 * nan).
        center_pos = pos_all[rows]
        center_mask = mask_all[rows]
        safe = cand.clamp(min=0)
        rij = pos_all[safe] - center_pos[:, None, :]
        rij = rij - boxj * torch.round(rij / boxj)
        d2 = torch.where(cand >= 0, torch.sum(rij * rij, -1), torch.inf)
        ctype = typ_all[safe]

        valid = (cand >= 0) & (d2 < rc2) & center_mask[:, None]
        nlist, sec_ovf = pack_type_sections(cand, valid, ctype, cfg.sel)
        overflow = torch.maximum(sec_ovf, cell_ovf)
        return nlist, torch.maximum(overflow, grid_bad * int(GRID_INVALID))

    return fn
