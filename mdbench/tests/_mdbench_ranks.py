"""Rank targets for the multi-card tests: each breaks the port in its own
process (spawned processes import afresh), then runs the rank."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def no_exchange(*args):
    """The bricks' halo and reverse-force exchange left out: every
    point-to-point transfer delivers zeros."""
    import torch
    from repro_torch.md import comm

    def silent(self, xs, pairs):
        return tuple(torch.zeros_like(x) for x in xs)

    comm.DistComm.ppermute = silent
    from mdbench import ranks
    return ranks.rank_main(*args)
