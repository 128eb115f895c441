"""The comparison that decides ``correct``.

After the window, with the port's state freed, the plain reference of the
configuration's model family (``reference/<family>.py``) takes one call of
the window drawn from the seed and works it out again from what the
benchmark handed to the port (the system, the raw weights, the call's
seed): its own tables (the se_e2_a family's Chebyshev table), its own
neighbour table, its own starting velocities, and velocity Verlet for the
traffic's ``follow_steps`` (the whole call where that is the call's length).
The numbers compared, each against the cell's limit
(``limits/<cell>.json``):

  pe_rows   max over the followed steps of |PE_port - PE_ref| / atoms (eV)
  ke_rows   the same for the kinetic energy (eV)
  vel_end   max over atoms of |v_port - v_ref| after the call (A/fs), where
            the reference follows the whole call; an entry that returns the
            atoms in another order (bricks) is paired atom by atom with the
            reference's nearest atom by minimum image
  pos_end   max over atoms of |x_port - x_ref| by minimum image (A), idem
  pe_end    |PE_port - PE_ref| / atoms at the port's own final positions,
            the largest over every call of the window: the model and the
            neighbour list at the end of each call, however long it ran

The control (``mdbench/control.py``) puts the reference, computed one
precision lower (TF32), in the port's place and reads the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from mdbench.reference import md as ref_md
from mdbench.reference.shared import neighbor_table, pair_counts

ORDER = ("pe_rows", "ke_rows", "vel_end", "pos_end", "pe_end")


@dataclasses.dataclass
class Outcome:
    numbers: Dict[str, float]
    limits: Dict[str, Optional[float]]
    failed: int
    live_pairs: List[int]            # pairs within rcut by neighbour type
    rebuilds: int
    # pairs within rcut + skin, the slots a list built there fills (traced
    # runs only: the force-and-virial roofline reads them)
    filled_pairs: Optional[int] = None

    @classmethod
    def held(cls, numbers: Dict[str, float], cell_limits: Dict[str, float],
             live_pairs: Optional[List[int]] = None,
             rebuilds: int = 0) -> "Outcome":
        """The numbers that the cell's limits name (every number, with no
        limit, where the cell has none), each beside its limit; ``failed``
        is for the caller to count."""
        if cell_limits:
            numbers = {n: v for n, v in numbers.items() if n in cell_limits}
        return cls(numbers, {n: cell_limits.get(n) for n in numbers}, 0,
                   live_pairs or [], rebuilds)

    @property
    def correct(self) -> bool:
        return all(self.limits.get(k) is not None
                   and self.numbers[k] <= self.limits[k]
                   for k in self.numbers)

    def line(self) -> Dict[str, Dict[str, Optional[float]]]:
        return {k: {"value": self.numbers[k], "limit": self.limits.get(k)}
                for k in ORDER if k in self.numbers}


def stderr_lines(checks: Dict) -> List[str]:
    return [f"check {k} {v['value']!r} limit {v['limit']!r}"
            for k, v in checks.items()]


def sampled_call(seed: int, n_calls: int) -> int:
    """The call the reference follows: drawn from the seed."""
    return int(np.random.default_rng([int(seed) & (2**64 - 1), 7])
               .integers(n_calls))


def nearest(pos: np.ndarray, typ: np.ndarray, ref_pos: torch.Tensor,
            ref_typ: torch.Tensor, box: np.ndarray,
            block: int = 128) -> Optional[np.ndarray]:
    """For each row of ``pos``, the row of ``ref_pos`` nearest to it by
    minimum image, among the atoms of its type; None where two rows pick
    the same atom, so that the pairing is no permutation."""
    x = torch.as_tensor(pos, dtype=torch.float64, device=ref_pos.device)
    t = torch.as_tensor(typ, dtype=torch.int64, device=ref_pos.device)
    r = ref_pos.double()
    b = torch.as_tensor(box, dtype=torch.float64, device=ref_pos.device)
    pick = torch.empty(len(x), dtype=torch.int64, device=ref_pos.device)
    for i in range(0, len(x), block):
        d = x[i:i + block, None, :] - r[None, :, :]
        d -= b * torch.round(d / b)
        d2 = (d * d).sum(-1)
        d2[t[i:i + block, None] != ref_typ[None, :]] = float("inf")
        pick[i:i + block] = d2.argmin(1)
    pick = pick.cpu().numpy()
    return pick if len(np.unique(pick)) == len(pick) else None


def compare(pe: np.ndarray, ke: np.ndarray, pos: Optional[np.ndarray],
            vel: Optional[np.ndarray], traj: ref_md.Trajectory, atoms: int,
            box: np.ndarray, typ: Optional[np.ndarray] = None,
            ref_typ: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """The trajectory numbers of a candidate (the port, or the control)
    against the reference's ``traj`` over its steps; ``pos``/``vel`` only
    where the candidate's end is the trajectory's end, with the rows' types
    ``typ`` where they come in another order than the reference's."""
    k = len(traj.pe)
    out = {"pe_rows": float(np.max(np.abs(np.asarray(pe[:k], np.float64)
                                          - traj.pe))) / atoms,
           "ke_rows": float(np.max(np.abs(np.asarray(ke[:k], np.float64)
                                          - traj.ke))) / atoms}
    if pos is not None:
        ref_v = traj.vel.double().cpu().numpy()
        ref_x = traj.pos.double().cpu().numpy()
        if typ is not None:
            pick = nearest(pos, typ, traj.pos, ref_typ, box)
            if pick is None:
                out["vel_end"] = out["pos_end"] = float("inf")
                return out
            ref_v, ref_x = ref_v[pick], ref_x[pick]
        out["vel_end"] = float(np.max(np.abs(vel.astype(np.float64) - ref_v)))
        d = pos.astype(np.float64) - ref_x
        d -= box * np.round(d / box)
        out["pos_end"] = float(np.max(np.abs(d)))
    return out


def end_energy_gap(model, pe_port: float,
                   pos: np.ndarray, typ: torch.Tensor, box: torch.Tensor,
                   dev: torch.device):
    """|PE_port - PE_ref| / atoms at the port's positions ``pos`` under the
    family's reference ``model``, and the pairs within rcut there by
    neighbour type."""
    x = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    e, nbr = ref_md.energy_at(model, x, typ, box)
    live = pair_counts(x, typ, box, nbr, model.rcut, model.ntypes)
    return abs(float(pe_port) - e) / len(pos), live


def reference_inputs(run, precision: str = "float32"):
    """(model, typ, box, mass) of the reference on the run's device: the
    model is the configuration's family's ``Reference`` in ``precision``."""
    dev = run.device
    cfg = run.cell.config
    model = run.cell.family.Reference(cfg, run.weights, dev,
                                      precision=precision)
    typ = torch.as_tensor(run.typ, dtype=torch.int64, device=dev)
    box = torch.as_tensor(run.box, dtype=torch.float32, device=dev)
    mass = torch.as_tensor(ref_md.masses(cfg["type_map"], run.typ),
                           dtype=torch.float32, device=dev)
    return model, typ, box, mass


def follow(run, model, typ, box, mass, seed: int) -> ref_md.Trajectory:
    """The reference's trajectory of the call whose velocity seed is
    ``seed``, for the traffic's ``follow_steps``."""
    tr = run.cell.traffic
    pos = torch.as_tensor(run.pos0, dtype=torch.float32, device=run.device)
    vel = ref_md.start_velocities(seed, mass, float(tr["temp_k"]))
    steps = min(int(tr["check"]["follow_steps"]), run.steps)
    return ref_md.nve(model, pos, vel, typ, box, mass, float(tr["dt_fs"]),
                      steps, float(tr["skin"]))


def run_check(run) -> Outcome:
    """Hold the run's calls against the reference (see the module's
    docstring)."""
    model, typ, box, mass = reference_inputs(run)
    k = sampled_call(run.seed, len(run.calls))
    rec = run.calls[k]
    traj = follow(run, model, typ, box, mass, rec.seed)
    whole = len(traj.pe) == run.steps
    numbers = compare(rec.pe, rec.ke, rec.pos if whole else None,
                      rec.vel if whole else None, traj, run.atoms, run.box,
                      rec.typ, typ)
    gaps, live = {}, None
    for i in range(len(run.calls)):
        c = run.calls[i]
        typ_i = typ if c.typ is None else torch.as_tensor(
            c.typ, dtype=torch.int64, device=run.device)
        gaps[i], live_i = end_energy_gap(model, c.pe[-1], c.pos, typ_i, box,
                                         run.device)
        if i == k:
            live = live_i
    numbers["pe_end"] = max(gaps.values())
    out = Outcome.held(numbers, run.cell.limits, live, traj.rebuilds)
    if run.trace:
        x = torch.as_tensor(rec.pos, dtype=torch.float32, device=run.device)
        rc = model.rcut + float(run.cell.traffic["skin"])
        out.filled_pairs = int((neighbor_table(x, box, rc) >= 0).sum())
    limits = out.limits

    def bad(name, value):
        return limits[name] is None or value > limits[name]

    out.failed = sum(1 for i, g in gaps.items()
                     if ("pe_end" in limits and bad("pe_end", g))
                     or (i == k and any(bad(n, out.numbers[n])
                                        for n in out.numbers
                                        if n != "pe_end")))
    return out
