"""What a run holds: the cell, its inputs, the port's calls and what was
read from them. The readers under ``metrics/`` take a :class:`Run`."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from mdbench import manifest


@dataclasses.dataclass
class CallRecord:
    """What one call of the port returned."""
    seed: int
    pe: np.ndarray              # (steps,) eV after each step
    ke: np.ndarray
    pos: np.ndarray             # (N, 3) after the last step
    vel: np.ndarray
    sel: tuple
    wall_s: float               # the port's own stepping-loop clock
    capture_s: float
    graph_captures: int
    graph_replays: int
    escalations: int
    host_syncs: int
    #: the types of ``pos``'s rows where the entry returns the atoms in
    #: another order than the system's (bricks); None: the system's order
    typ: Optional[np.ndarray] = None


@dataclasses.dataclass
class Run:
    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    pos0: Optional[np.ndarray] = None
    typ: Optional[np.ndarray] = None
    box: Optional[np.ndarray] = None
    weights: Optional[Dict] = None
    entry: object = None
    calls: List[CallRecord] = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    window_s: float = 0.0
    memory_peak_bytes: int = 0
    stretch: Optional[object] = None         # prof.Stretch
    profile: Optional[Dict] = None
    extra: Dict = dataclasses.field(default_factory=dict)
    check: Optional[object] = None           # check.Outcome

    @property
    def atoms(self) -> int:
        return int(len(self.pos0))

    @property
    def steps(self) -> int:
        return int(self.cell.traffic["steps"])
