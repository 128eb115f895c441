"""The reference's helpers that no model family owns: the brute-force
neighbour table, the count of pairs within a cut-off, and rounding to TF32
for the control one precision below float32. Nothing here imports the port.
"""

from __future__ import annotations

from typing import List

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, to nearest even.
    The gradient passes straight through."""
    i = x.detach().contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    i = torch.bitwise_and(i + 0xFFF + lsb, ~0x1FFF)
    return x + (i.view(torch.float32) - x.detach())


def pair_counts(pos: torch.Tensor, typ: torch.Tensor, box: torch.Tensor,
                nbr: torch.Tensor, rcut: float, ntypes: int) -> List[int]:
    """Pairs (i, j) with |r_ij| < rcut, by the neighbour's type: the live
    slots that the work needs."""
    out = [0] * ntypes
    for a0 in range(0, pos.shape[0], 8192):
        idx = nbr[a0:a0 + 8192]
        valid = idx >= 0
        j = torch.clamp(idx, min=0)
        rij = pos[j] - pos[a0:a0 + 8192, None, :]
        rij = rij - box * torch.round(rij / box)
        live = valid & (torch.sum(rij * rij, dim=-1) < rcut * rcut)
        for t in range(ntypes):
            out[t] += int((live & (typ[j] == t)).sum())
    return out


def neighbor_table(pos: torch.Tensor, box: torch.Tensor, rc: float,
                   block: int = 1024) -> torch.Tensor:
    """(N, P) indices of every atom within ``rc`` of each atom (minimum
    image; the box must be at least 2 rc wide), -1 past each row's count.
    Brute force over all pairs, a block of rows at a time."""
    n = pos.shape[0]
    if bool(torch.any(box < 2.0 * rc)):
        raise ValueError(f"box {box.tolist()} narrower than 2 x {rc} A")
    rows: List[torch.Tensor] = []
    cols: List[torch.Tensor] = []
    rc2 = rc * rc
    ar = torch.arange(n, device=pos.device)
    for a0 in range(0, n, block):
        a1 = min(n, a0 + block)
        d2 = torch.zeros((a1 - a0, n), dtype=pos.dtype, device=pos.device)
        for a in range(3):
            d = pos[None, :, a] - pos[a0:a1, None, a]
            d = d - box[a] * torch.round(d / box[a])
            d2 += d * d
        hit = d2 < rc2
        hit[torch.arange(a1 - a0, device=pos.device), ar[a0:a1]] = False
        r, c = torch.nonzero(hit, as_tuple=True)
        rows.append(r + a0)
        cols.append(c)
    r = torch.cat(rows)
    c = torch.cat(cols)
    counts = torch.bincount(r, minlength=n)
    width = int(counts.max()) if n else 0
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(r.shape[0], device=pos.device) - start[r]
    table = torch.full((n, max(width, 1)), -1, dtype=torch.int64,
                       device=pos.device)
    table[r, slot] = c
    return table
