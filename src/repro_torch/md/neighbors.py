"""O(N) cell-list neighbor search with PBC and type-sectioned padded lists.

Output layout matches the descriptor's expectation: for each atom, slots
[0, sel_0) hold type-0 neighbors, [sel_0, sel_0+sel_1) type-1, ... with -1
padding — the DeePMD type-sectioned convention that makes per-type embedding
nets static slices.

All capacities are fixed, so every shape is static; capacity overflow is
*reported* (a flag), never silently truncated — the driver escalates
capacities on overflow. Neighbor indices are int64 (torch's index type).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NeighborSpec:
    rcut_nbr: float              # rcut + skin buffer (paper: +2 A)
    sel: Tuple[int, ...]         # per-type slot capacities
    cell_capacity: int = 64      # max atoms per cell-list bin

    @property
    def nsel(self) -> int:
        return int(sum(self.sel))


#: Overflow-flag sentinel: the dynamic box has shrunk below the static cell
#: grid's validity (a cell dimension < rcut_nbr, so the +/-1 stencil no
#: longer covers the cutoff). Escalating slot capacities cannot fix this —
#: the driver must re-derive the grid from the current box. Far above any
#: real capacity excess, so ``flag >= GRID_INVALID`` is unambiguous.
GRID_INVALID = np.int32(1 << 20)


def _min_image(rij: torch.Tensor, box: Optional[torch.Tensor]) -> torch.Tensor:
    if box is None:
        return rij
    return rij - box * torch.round(rij / box)


def pack_type_sections(
    cand: torch.Tensor,       # (N, C) candidate indices (-1 invalid)
    valid: torch.Tensor,      # (N, C) candidate validity (distance-gated)
    cand_type: torch.Tensor,  # (N, C)
    sel: Tuple[int, ...],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack valid candidates into the DeePMD type-sectioned padded layout.

    Stable-sort compaction with fixed shapes. Returns (nlist (N, nsel),
    overflow excess count as a 0-d int32 tensor).
    """
    sections = []
    overflow = torch.zeros((), dtype=torch.int32, device=cand.device)
    for t, cap_t in enumerate(sel):
        vt = valid & (cand_type == t)
        # Stable-sort invalids to the back; ties keep candidate order.
        order = torch.argsort((~vt).to(torch.int8), dim=1, stable=True)
        packed = torch.gather(cand, 1, order)
        pvalid = torch.gather(vt, 1, order)
        if packed.shape[1] < cap_t:   # fewer candidates than capacity: pad
            pad = cap_t - packed.shape[1]
            packed = torch.nn.functional.pad(packed, (0, pad), value=-1)
            pvalid = torch.nn.functional.pad(pvalid, (0, pad), value=False)
        sec = torch.where(pvalid[:, :cap_t], packed[:, :cap_t], -1)
        excess = vt.sum(dim=1).max().to(torch.int32) - cap_t
        overflow = torch.maximum(overflow, excess)
        sections.append(sec)
    return torch.cat(sections, dim=1), overflow


def _pack_sections(cand, dist2, cand_type, spec: NeighborSpec, rc2: float):
    """Distance-gate candidates, then pack into type sections."""
    return pack_type_sections(cand, (cand >= 0) & (dist2 < rc2), cand_type,
                              spec.sel)


def brute_force_neighbors(
    pos: torch.Tensor, atype: torch.Tensor, spec: NeighborSpec,
    box: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(N^2) reference / small-box fallback (cells would alias under PBC)."""
    n = pos.shape[0]
    rij = _min_image(pos[None, :, :] - pos[:, None, :], box)
    d2 = torch.sum(rij * rij, dim=-1)
    idx = torch.arange(n, device=pos.device)
    cand = idx[None, :].expand(n, n)
    valid = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    cand = torch.where(valid, cand, -1)
    d2 = torch.where(valid, d2, torch.inf)
    ctype = atype[cand.clamp(min=0)]
    return _pack_sections(cand, d2, ctype, spec, spec.rcut_nbr ** 2)


def make_cell_list_fn(spec: NeighborSpec, box: np.ndarray,
                      dynamic_box: bool = False):
    """Build an O(N) neighbor function for an orthorhombic box.

    Static form (default): ``fn(pos, atype)`` with the box fixed.
    Dynamic form (``dynamic_box=True``): ``fn(pos, atype, box)``
    — the cell COUNTS stay those of the reference ``box`` given here, while
    cell sizes and the min-image wrap follow the per-call box. If that box
    shrinks until a cell dimension no longer covers ``rcut_nbr``, the
    overflow flag returns ``>= GRID_INVALID``.

    Falls back to brute force when the reference box is too small for 3
    cells per dimension (min-image always uses the per-call box).
    """
    ncell = np.maximum(np.floor(np.asarray(box, float) / spec.rcut_nbr)
                       .astype(int), 1)
    if np.any(ncell < 3):
        if dynamic_box:
            def small_dyn_fn(pos, atype, box_t):
                return brute_force_neighbors(pos, atype, spec, torch.as_tensor(
                    box_t, dtype=pos.dtype, device=pos.device))
            return small_dyn_fn

        def small_fn(pos, atype):
            return brute_force_neighbors(pos, atype, spec, torch.as_tensor(
                box, dtype=pos.dtype, device=pos.device))
        return small_fn

    ncells = int(np.prod(ncell))
    offsets_np = np.stack(
        np.meshgrid(*[[-1, 0, 1]] * 3, indexing="ij"), axis=-1
    ).reshape(-1, 3)                                   # (27, 3)
    # host constants copied to each device once: a copy from host memory
    # cannot run under CUDA-graph capture, so the first (eager) call makes
    # them and a captured call finds them here
    consts = {}

    def core(pos, atype, box_t):
        n = pos.shape[0]
        dev = pos.device
        cap = spec.cell_capacity
        if dev not in consts:
            consts[dev] = (torch.as_tensor(ncell, device=dev),
                           torch.as_tensor(offsets_np, device=dev))
        ncell_t, offsets = consts[dev]
        cell_size = box_t / ncell_t.to(box_t.dtype)
        # grid validity under a moving box: every cell dim must still cover
        # the cutoff, or the +/-1 stencil silently misses pairs
        grid_bad = torch.any(cell_size < spec.rcut_nbr).to(torch.int32)
        cidx3 = torch.minimum(torch.clamp((pos / cell_size).to(torch.int64),
                                          min=0), ncell_t - 1)
        cflat = (cidx3[:, 0] * int(ncell[1]) + cidx3[:, 1]) * int(ncell[2]) \
            + cidx3[:, 2]

        # Bucket atoms: rank within cell via sorted order.
        order = torch.argsort(cflat, stable=True)
        sorted_cells = cflat[order]
        starts = torch.searchsorted(sorted_cells,
                                    torch.arange(ncells, device=dev))
        rank = torch.arange(n, device=dev) - starts[sorted_cells]
        cell_overflow = (rank.max() - (cap - 1)).to(torch.int32)
        # Out-of-capacity atoms drop: they are written to one spare slot
        # past the table (a fixed-shape scatter, no host sync).
        spare = ncells * cap
        flat = torch.where(rank < cap, sorted_cells * cap + rank, spare)
        table = torch.full((spare + 1,), -1, dtype=torch.int64, device=dev)
        table = table.scatter_(0, flat, order)[:spare].view(ncells, cap)

        # Candidates: 27 neighbor cells per atom.
        nbr3 = torch.remainder(cidx3[:, None, :] + offsets[None, :, :],
                               ncell_t)
        nbrflat = (nbr3[..., 0] * int(ncell[1]) + nbr3[..., 1]) \
            * int(ncell[2]) + nbr3[..., 2]
        cand = table[nbrflat].reshape(n, 27 * cap)
        self_mask = cand == torch.arange(n, device=dev)[:, None]
        cand = torch.where(self_mask, -1, cand)

        rij = _min_image(pos[cand.clamp(min=0)] - pos[:, None, :], box_t)
        d2 = torch.where(cand >= 0, torch.sum(rij * rij, dim=-1), torch.inf)
        ctype = atype[cand.clamp(min=0)]
        nlist, sec_overflow = _pack_sections(
            cand, d2, ctype, spec, spec.rcut_nbr ** 2)
        overflow = torch.maximum(sec_overflow, cell_overflow)
        return nlist, torch.maximum(overflow, grid_bad * int(GRID_INVALID))

    if dynamic_box:
        def dyn_fn(pos, atype, box_t):
            return core(pos, atype, torch.as_tensor(
                box_t, dtype=pos.dtype, device=pos.device))
        return dyn_fn

    def fn(pos, atype):
        return core(pos, atype, torch.as_tensor(box, dtype=pos.dtype,
                                                device=pos.device))

    return fn
