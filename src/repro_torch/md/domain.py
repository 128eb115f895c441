"""Distributed MD: N-D brick domain decomposition + halo exchange + migration
— the counterpart of ``repro.md.domain``.

The paper's parallelization (Sec. 3.3, 3.5.4), per brick:

  * N-D Cartesian brick decomposition behind :class:`Topology`: a shape like
    ``(4,)``, ``(2, 4)`` or ``(2, 2, 2)`` maps the spatial rank to a brick
    coordinate. Each brick holds a fixed-capacity, mask-padded atom array.
  * Halo (ghost) exchange as STAGED PER-AXIS SWEEPS (x, then y, then z):
    each sweep packs boundary layers from owned atoms PLUS the ghosts of
    earlier sweeps and exchanges them with the +/- neighbor along that axis,
    so edge and corner ghosts ride through two/three axis-aligned exchanges
    instead of 26 neighbor sends. Capacity-bounded with overflow flags.
  * Forces are computed on ghosts too; ghost forces go BACK owner-ward by
    running the sweeps IN REVERSE (z, then y, then x), scatter-adding into
    owned slots AND earlier-axis ghost slots.
  * The model axis splits each brick's work: ``decomp="slots"`` gives model
    shards complementary NEIGHBOR-SLOT slices of every atom (the fused DP
    kernels run on the slice) and sums the partial T matrices over the model
    axis; ``decomp="atoms"`` gives them complementary ATOM slices and sums
    the forces.
  * Atom migration at rebuild cadence as the same staged per-axis sweeps:
    split along x -> exchange -> merge, then y, then z. Capacity-bounded;
    overflow is reported per axis, never silently dropped.

Where the reference writes ``shard_map`` over a mesh, the port runs the
per-brick code on every rank of a communicator (``md/comm.py``):
:class:`~repro_torch.md.comm.LocalComm` (all ranks in one process, one thread
each) or :class:`~repro_torch.md.comm.DistComm` (one process per rank). The
per-brick code is the same under both. A process holds the bricks
``comm.bricks``; stacked states and ensemble states have one entry per held
brick, in that order.

Two differences from the reference, both deliberate:

  * The step is velocity Verlet with the force carried in the state, as in
    the single-process engines (``md/stepper.make_md_step``): kick with the
    carried force, drift, halo + rebuild + force at the new positions, kick,
    thermostat, barostat; the thermo reports the new positions' energy. The
    reference's distributed step kicks twice with the force of the step's
    starting positions. The carried force migrates with its atom, and
    :meth:`DistributedStep.prime` (or ``OuterMDProgram.prime``) computes it
    at the start and after a repartition.
  * No value is read on the host inside a step: overflow flags and atom
    counts stay device tensors in the thermo, checked once per segment.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import DPConfig
from repro_torch.kernels.dp_fused import ops as dp_fused_ops
from repro_torch.md import api, comm as comm_mod, integrator, neighbors, stepper
from repro_torch.md import slab_cells
from repro_torch.md.topology import Topology

SPATIAL, MODEL = comm_mod.SPATIAL, comm_mod.MODEL


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    box: Tuple[float, float, float]      # global orthorhombic box (A)
    n_slabs: int                          # spatial axis size (= prod(topology))
    atom_capacity: int                    # max owned atoms per brick
    halo_capacity: int                    # max ghost atoms per side per sweep
    rcut_halo: float                      # rcut + skin
    #: brick counts per decomposed axis; ``None`` -> the 1-D
    #: ``(n_slabs,)`` x-slab layout
    topology: Optional[Tuple[int, ...]] = None
    #: atoms per bin of the brick cell list (``neighbor="cells"``);
    #: ``None`` derives it (:meth:`derived_cell_capacity`). The reference
    #: fixes it at 96, which full-width copper bricks (rcut_halo 10 A, ~120
    #: atoms a cell on average) outgrow
    cell_capacity: Optional[int] = None

    def __post_init__(self):
        shape = tuple(int(s) for s in (self.topology
                                       if self.topology is not None
                                       else (self.n_slabs,)))
        object.__setattr__(self, "topology", shape)
        Topology(shape)                        # validates the shape itself
        if math.prod(shape) != self.n_slabs:
            raise ValueError(f"topology {shape} has {math.prod(shape)} "
                             f"bricks but n_slabs={self.n_slabs}")
        if self.cell_capacity is None:
            object.__setattr__(self, "cell_capacity",
                               self.derived_cell_capacity())

    def derived_cell_capacity(self) -> int:
        """A cell's share of a full brick, with a margin: the density of
        ``atom_capacity`` atoms in the brick times the static cell's volume,
        times 1.5 (a crystal's atomic planes can put up to
        (1 + plane spacing / cell size)^3 times the mean into one cell), and
        at least the reference's 96. Escalation grows it like the other
        capacities."""
        _, cs = slab_cells.static_grid(self.box, self.slab_width,
                                       self.rcut_halo, self.topology)
        brick_volume = math.prod(self.box) / self.n_slabs
        return max(96, math.ceil(1.5 * self.atom_capacity / brick_volume
                                 * math.prod(cs)))

    @classmethod
    def for_topology(cls, box, topology, atom_capacity, halo_capacity,
                     rcut_halo, cell_capacity: Optional[int] = None
                     ) -> "DomainSpec":
        """Topology-first constructor: ``n_slabs`` derived from the shape."""
        topo = Topology.parse(topology)
        return cls(box=tuple(box), n_slabs=topo.n_ranks,
                   atom_capacity=atom_capacity, halo_capacity=halo_capacity,
                   rcut_halo=rcut_halo, topology=topo.shape,
                   cell_capacity=cell_capacity)

    @property
    def topo(self) -> Topology:
        return Topology(self.topology)

    @property
    def slab_width(self) -> float:
        """The brick width along x."""
        return self.box[0] / self.topology[0]

    @property
    def brick_widths(self) -> Tuple[float, ...]:
        """Launch-time brick width per DECOMPOSED axis."""
        return tuple(self.box[a] / s for a, s in enumerate(self.topology))

    def validate(self) -> None:
        for a, (w, s) in enumerate(zip(self.brick_widths, self.topology)):
            if w < self.rcut_halo:
                raise ValueError(
                    f"brick width box[{a}]/{s} = {w:.2f} < halo cutoff "
                    f"{self.rcut_halo:.2f}: the decomposition needs "
                    f"box[a]/shape[a] >= rcut_halo on every decomposed axis "
                    f"(use fewer bricks along axis {a})")
        if self.n_slabs < 2:
            raise ValueError(
                "brick decomposition assumes >= 2 bricks (ghost images must "
                "not alias their owners); use md/driver.py for single-domain "
                "runs")


class SlabState(NamedTuple):
    """Per-brick padded state; a leading brick dim when stacked.

    ``force`` is the carried force of the velocity-Verlet step (zeros from
    :func:`partition_atoms`; :meth:`DistributedStep.prime` fills it).
    """
    pos: torch.Tensor                  # (cap, 3)
    vel: torch.Tensor                  # (cap, 3)
    typ: torch.Tensor                  # (cap,) int64
    mask: torch.Tensor                 # (cap,) bool — owned-atom validity
    force: Optional[torch.Tensor] = None   # (cap, 3) eV/A


def partition_atoms(pos: np.ndarray, vel: np.ndarray, typ: np.ndarray,
                    spec: DomainSpec, box: Optional[np.ndarray] = None
                    ) -> Tuple[SlabState, int]:
    """Host-side initial partition -> stacked (n_slabs, cap, ...) CPU tensors.

    ``box`` overrides the launch-time geometry (a barostat-moved carried box
    changes every brick width): repartitioning after a capacity escalation
    must bin by the box the atoms actually live in.
    """
    topo = spec.topo
    box_np = np.asarray(box if box is not None else spec.box, float)
    rank = np.zeros(len(pos), np.int64)
    for a in topo.axes:
        w = box_np[a] / topo.shape[a]
        # clamp BOTH ends: a slightly-negative coordinate (an atom that
        # drifted past a face since the last migration) must bin to brick
        # 0, never to a nonexistent negative rank (silent atom loss)
        c = np.clip((pos[:, a] / w).astype(np.int64), 0, topo.shape[a] - 1)
        rank += c * topo.strides[a]
    cap = spec.atom_capacity
    out_pos = np.zeros((spec.n_slabs, cap, 3), np.float32)
    out_vel = np.zeros((spec.n_slabs, cap, 3), np.float32)
    out_typ = np.zeros((spec.n_slabs, cap), np.int64)
    out_mask = np.zeros((spec.n_slabs, cap), bool)
    overflow = 0
    for s in range(spec.n_slabs):
        idx = np.nonzero(rank == s)[0]
        n = len(idx)
        overflow = max(overflow, n - cap)
        idx = idx[:cap]
        out_pos[s, :len(idx)] = pos[idx]
        out_vel[s, :len(idx)] = vel[idx]
        out_typ[s, :len(idx)] = typ[idx]
        out_mask[s, :len(idx)] = True
    state = SlabState(torch.from_numpy(out_pos), torch.from_numpy(out_vel),
                      torch.from_numpy(out_typ), torch.from_numpy(out_mask),
                      torch.zeros((spec.n_slabs, cap, 3), dtype=torch.float32))
    return state, overflow


def gather_atoms(state: SlabState) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side inverse of :func:`partition_atoms`: live atoms, flat."""
    pos = state.pos.detach().cpu().numpy().reshape(-1, 3)
    vel = state.vel.detach().cpu().numpy().reshape(-1, 3)
    typ = state.typ.detach().cpu().numpy().reshape(-1)
    mask = state.mask.detach().cpu().numpy().reshape(-1)
    return pos[mask], vel[mask], typ[mask]


def capacity_scale_for_box(spec: DomainSpec, box_now) -> float:
    """Launch-volume / current-volume, clamped >= 1: the density rise a
    barostat-compressed box implies, by which every per-brick capacity must
    grow (:meth:`stepper.EscalationPolicy.volume_scale`)."""
    return stepper.EscalationPolicy.volume_scale(spec.box, box_now)


def escalate_capacities(spec: DomainSpec, policy, box_now=None,
                        n_model: int = 1) -> DomainSpec:
    """Grow DomainSpec capacities on overflow, folding the carried box in.

    The growth factor is ``max(policy.growth, V_launch / V_now)``, so a
    replay after a barostat squeeze jumps straight to a capacity that holds
    the CURRENT density. ``atom_capacity`` stays divisible by ``n_model``
    (the atoms-decomposition layout). The cell capacity grows by the same
    factor (a neighbor overflow may come from a full cell). The returned
    spec is REBASED onto ``box_now``: the static cell grids and the next
    volume comparison derive from the box the atoms actually live in.
    """
    scale = 1.0 if box_now is None else capacity_scale_for_box(spec, box_now)
    atom = policy.grow(spec.atom_capacity, scale)
    atom = -(-atom // n_model) * n_model
    halo = policy.grow(spec.halo_capacity, scale)
    new_box = (spec.box if box_now is None
               else tuple(float(b) for b in np.asarray(box_now).reshape(-1)))
    return dataclasses.replace(spec, box=new_box, atom_capacity=atom,
                               halo_capacity=halo,
                               cell_capacity=policy.grow(spec.cell_capacity,
                                                         scale))


def repartition_state(state: SlabState, spec_new: DomainSpec,
                      box_now=None) -> Tuple[SlabState, int]:
    """Host-side re-partition of a whole stacked state into (escalated)
    ``spec_new`` capacities, binned by ``box_now`` when the box moved. The
    carried forces are not kept: prime the new state."""
    pos, vel, typ = gather_atoms(state)
    return partition_atoms(pos, vel, typ, spec_new, box=box_now)


def pad_sel_for(cfg: DPConfig, n_shards: int) -> DPConfig:
    """Pad each neighbor-type section to a model-axis-divisible size."""
    sel = tuple(-(-s // n_shards) * n_shards for s in cfg.sel)
    return dataclasses.replace(cfg, sel=sel)


# ------------------------------------------------------ bricks <-> ranks

def shard_state(state: SlabState, comm, device) -> SlabState:
    """The bricks this process holds (``comm.bricks``) of a whole stacked
    host state, on ``device``."""
    idx = list(comm.bricks)
    return SlabState(*(None if x is None else x[idx].to(device)
                       for x in state))


def gather_state(state: SlabState, comm) -> SlabState:
    """The whole stacked state on the host from every process's bricks (a
    host round-trip: for repartitions and final output, not the hot loop)."""
    host = SlabState(*(None if x is None else x.detach().cpu()
                       for x in state))
    if isinstance(comm, comm_mod.LocalComm):
        return host
    import torch.distributed as dist
    parts: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (comm.bricks, host))
    by_brick = {}
    for bricks, part in parts:
        for i, b in enumerate(bricks):
            by_brick.setdefault(b, SlabState(*(None if x is None else x[i]
                                               for x in part)))
    return _stack_states([by_brick[b] for b in range(comm.n_spatial)])


def init_ensemble_state(ensemble: api.Ensemble, comm, device) -> Tuple:
    """Per-brick ensemble state for the bricks this process holds.

    Stateless ensembles give ``()`` per brick; a Langevin generator is
    seeded per brick (from the ensemble's seed and the brick index), so
    bricks draw independent noise while the model shards of one brick
    draw the same.
    """
    out = []
    for b in comm.bricks:
        st = ensemble.init_state(torch.device(device))
        for gen in stepper.generators_of(st):
            gen.manual_seed(gen.initial_seed() * comm.n_spatial + b)
        out.append(st)
    return tuple(out)


def _clone_gens(tree):
    """``tree`` with each generator replaced by a copy in the same state:
    every rank draws from its own copy."""
    def clone(g):
        c = torch.Generator(device=g.device)
        c.set_state(g.get_state())
        return c
    return stepper._map_state(lambda t: t, clone, tree)


def _adopt_gens(dst_tree, src_tree) -> None:
    """Set the generators of ``dst_tree`` to the states of ``src_tree``'s."""
    for d, s in zip(stepper.generators_of(dst_tree),
                    stepper.generators_of(src_tree)):
        d.set_state(s.get_state())


def _on_bricks(comm, fn: Callable, state: SlabState, ens, baro,
               trees: Optional[Dict[int, Tuple[Any, Any]]] = None):
    """``fn(rank, brick_state, brick_ens, baro)`` on every rank held here,
    under ``torch.no_grad()``; returns the result of each held brick's
    lowest model shard, in ``comm.bricks`` order. Every rank gets its own
    copy of the generators (the callers' generators take the states of the
    returned ones), or, with ``trees``, the ensemble and barostat states
    ``trees[rank]``."""
    bricks = list(comm.bricks)

    def per_rank(rank):
        i = bricks.index(rank.spatial_index)
        brick = SlabState(*(None if x is None else x[i] for x in state))
        ens_r, baro_r = (trees[rank.rank] if trees is not None
                         else (_clone_gens(ens[i]), _clone_gens(baro)))
        with torch.no_grad():
            return fn(rank, brick, ens_r, baro_r)

    results = comm.run(per_rank)
    lead: Dict[int, Any] = {}
    for r in sorted(results):
        lead.setdefault(r // comm.n_model, results[r])
    return [lead[b] for b in bricks]


def _stack_states(states: List[SlabState]) -> SlabState:
    return SlabState(*(None if states[0][k] is None
                       else torch.stack([s[k] for s in states])
                       for k in range(len(SlabState._fields))))


def _norm_ens(ens, comm) -> Tuple:
    if ens is None or (isinstance(ens, tuple) and len(ens) == 0):
        return tuple(() for _ in comm.bricks)
    return tuple(ens)


# --------------------------------------------------------------- halo pieces

def _pack_boundary(pos, typ, mask, lo_side: bool, spec: DomainSpec,
                   face_lo, width=None, dim: int = 0):
    """Select atoms within rcut of a brick face (along axis ``dim``) into a
    fixed buffer.

    ``width`` may be a tensor from the carried box (the barostat moves the
    box and the brick faces with it); ``None`` keeps the launch-time
    geometry. The caller may pass ghosts of earlier sweeps in
    ``pos``/``mask`` too: that routes edge/corner ghosts through the staged
    axis sweeps.
    """
    if width is None:
        width = spec.brick_widths[dim]
    x_rel = pos[:, dim] - face_lo
    if lo_side:
        sel = mask & (x_rel < spec.rcut_halo)
    else:
        sel = mask & (x_rel > width - spec.rcut_halo)
    # stable-compact selected atoms to the buffer front
    order = torch.argsort((~sel).to(torch.int8), stable=True)
    idx = order[:spec.halo_capacity]
    valid = sel[idx]
    overflow = (sel.sum() - valid.sum()).to(torch.int32)
    buf_pos = torch.where(valid[:, None], pos[idx], 0.0)
    buf_typ = torch.where(valid, typ[idx], 0)
    return buf_pos, buf_typ, valid, idx, overflow


def _shift_axis(p, dim: int, amount):
    out = p.clone()
    out[:, dim] = out[:, dim] + amount
    return out


def _halo_sweep(comm, pos, typ, mask, spec: DomainSpec, dim: int,
                coord_d: int, n_d: int, box_d, width_d, face_lo,
                plus_pairs, minus_pairs):
    """ONE staged halo sweep: ghost atoms from both axis-``dim`` neighbors.

    ``pos``/``typ``/``mask`` are owned atoms plus the ghosts of EARLIER
    sweeps. Returns (ghost_pos (2*hc, 3) shifted into this brick's frame,
    ghost_typ, ghost_mask, reverse-comm bookkeeping, overflow).
    """
    lo_pos, lo_typ, lo_valid, lo_idx, ovf_l = _pack_boundary(
        pos, typ, mask, True, spec, face_lo, width_d, dim)
    hi_pos, hi_typ, hi_valid, hi_idx, ovf_r = _pack_boundary(
        pos, typ, mask, False, spec, face_lo, width_d, dim)

    # my low boundary -> minus neighbor's ghosts; high -> plus neighbor
    fr_pos, fr_typ, fr_valid = comm.ppermute((lo_pos, lo_typ, lo_valid),
                                             minus_pairs)
    fl_pos, fl_typ, fl_valid = comm.ppermute((hi_pos, hi_typ, hi_valid),
                                             plus_pairs)
    # shift ghosts into this brick's coordinate frame (periodic along dim)
    if comm.self_image:               # my own far faces: a ring of one
        fl_pos = _shift_axis(fl_pos, dim, -width_d)
        fr_pos = _shift_axis(fr_pos, dim, width_d)
    else:
        if coord_d == 0:              # from brick n-1, across the wrap
            fl_pos = _shift_axis(fl_pos, dim, -box_d)
        if coord_d == n_d - 1:        # from brick 0, across the wrap
            fr_pos = _shift_axis(fr_pos, dim, box_d)

    ghost_pos = torch.cat([fl_pos, fr_pos], dim=0)
    ghost_typ = torch.cat([fl_typ, fr_typ], dim=0)
    ghost_mask = torch.cat([fl_valid, fr_valid], dim=0)
    book = {"lo_idx": lo_idx, "lo_valid": lo_valid,
            "hi_idx": hi_idx, "hi_valid": hi_valid}
    return ghost_pos, ghost_typ, ghost_mask, book, torch.maximum(ovf_l, ovf_r)


def _reverse_sweep(comm, f_prefix, ghost_force, book, plus_pairs,
                   minus_pairs):
    """Return ONE axis's ghost-force segment to the ranks that packed it.

    Slot order is preserved end to end: my hi-boundary pack became the plus
    neighbor's from-minus ghost buffer, so the returned buffer indexes
    straight back through hi_idx (and symmetrically for lo). The scatter
    targets are owned slots AND earlier-axis ghost slots: running the sweeps
    in reverse hops a corner ghost's force home.
    """
    hc = ghost_force.shape[0] // 2
    f_from_minus = ghost_force[:hc]     # ghosts owned minus-ward of me
    f_from_plus = ghost_force[hc:]      # ghosts owned plus-ward of me
    (recv_hi,) = comm.ppermute((f_from_minus,), minus_pairs)
    (recv_lo,) = comm.ppermute((f_from_plus,), plus_pairs)
    contrib = torch.zeros_like(f_prefix)
    contrib.index_add_(0, book["hi_idx"], recv_hi * book["hi_valid"][:, None])
    contrib.index_add_(0, book["lo_idx"], recv_lo * book["lo_valid"][:, None])
    return f_prefix + contrib


# ------------------------------------------------------ neighbor list (brick)

def _slab_neighbors(pos_all, typ_all, mask_all, cfg: DPConfig, rc2: float,
                    n_local: int, box):
    """Brute-force type-sectioned neighbor list for local atoms vs all atoms
    (tests; ``neighbor="cells"`` is the O(N) search). Undecomposed axes are
    periodic via min-image; the caller passes 1e30 on decomposed axes."""
    rij = pos_all[None, :, :] - pos_all[:n_local, None, :]
    rij = rij - box * torch.round(rij / box)
    d2 = torch.sum(rij * rij, dim=-1)
    n_all = pos_all.shape[0]
    dev = pos_all.device
    cand = torch.arange(n_all, device=dev)[None, :].expand(n_local, n_all)
    self_mask = cand == torch.arange(n_local, device=dev)[:, None]
    valid = (~self_mask) & mask_all[None, :] & mask_all[:n_local, None] \
        & (d2 < rc2)
    return neighbors.pack_type_sections(cand, valid, typ_all[cand], cfg.sel)


def _pair_forces(energy_of_rij, pos_all, nlist, start: int, boxm):
    """Energy, forces on every row of ``pos_all`` and virial of the centers
    ``pos_all[start:start + len(nlist)]``.

    Autodiff with respect to r_ij, then the pair forces scattered to atoms
    with ``index_add_`` (padded slots add their zero into row 0, as the
    single-process path does). The graph lives only inside this call.
    """
    nmask = nlist >= 0
    j = torch.clamp(nlist, min=0)
    centers = pos_all[start:start + nlist.shape[0]]
    rij = pos_all[j] - centers[:, None, :]
    rij = rij - boxm * torch.round(rij / boxm)
    rij = torch.where(nmask[..., None], rij, 0.0)
    with torch.enable_grad():
        rij = rij.requires_grad_(True)
        e = energy_of_rij(rij, nmask)
        (de,) = torch.autograd.grad(e, rij)
    de = de * nmask[..., None].to(de.dtype)
    f = torch.zeros_like(pos_all).index_add_(0, j.reshape(-1),
                                             -de.reshape(-1, 3))
    f[start:start + nlist.shape[0]] += de.sum(dim=1)
    virial = -torch.einsum("ijk,ijl->kl", rij.detach(), de)
    return e.detach(), f, virial


# ---------------------------------------------------------------- the MD step

class _Local(NamedTuple):
    """The per-brick functions of one distributed MD configuration."""
    forces: Callable      # (rank, params, pos, typ, mask, box) -> ForceOut
    step: Callable        # (rank, params, SlabState, ens, box, baro) -> ...
    #: the brick cell list (``neighbor="cells"``; ``None`` for brute force):
    #: (pos_all, typ_all, mask_all, brick_lo, center_start, box=, widths=)
    #: -> (nlist, overflow)
    neighbors: Optional[Callable] = None


class ForceOut(NamedTuple):
    force: torch.Tensor       # (cap, 3) on owned slots, model-reduced
    e_local: torch.Tensor     # () energy of the brick's owned atoms
    virial: torch.Tensor      # (3, 3) of the brick (model-reduced)
    h_ovf: torch.Tensor       # () int32 halo capacity excess
    n_ovf: torch.Tensor       # () int32 neighbor capacity excess
    geom_ovf: torch.Tensor    # () int32 a brick narrower than rcut_halo


def make_local_md_step(cfg: Optional[DPConfig], spec: DomainSpec,
                       n_model: int, masses: Tuple[float, ...], dt_fs: float,
                       impl: Optional[str] = None, decomp: str = "slots",
                       neighbor: str = "brute",
                       potential: Optional[api.Potential] = None,
                       ensemble: Optional[api.Ensemble] = None,
                       barostat: Optional[api.Barostat] = None) -> _Local:
    """The per-brick force evaluation and MD step, run on every rank.

    ``step(rank, params, brick, ens, box, baro) -> ((brick, ens, box,
    baro), thermo)`` on one brick's (unstacked) :class:`SlabState`:
    kick with the carried force, drift, then the staged halo sweeps, the
    neighbor search, the force (with ghost forces sent home by the reverse
    sweeps and the model-axis reduction), the second kick, the thermostat
    and the barostat. ``forces(rank, params, pos, typ, mask, box)`` is the
    force part alone (:class:`ForceOut`).

    The BOX ``box`` (3,) is the dynamic, replicated simulation box: every
    brick extent (per-axis width, faces, min-image wrap) derives from it
    each step; a brick narrower than ``rcut_halo`` on a decomposed axis
    reports through ``thermo["geom_overflow"]``. The per-brick virial and
    kinetic tensors sum over the spatial axis into the global stress; the
    barostat state is replicated, so every brick rescales identically.

    decomp:
      "slots" — model shards take complementary NEIGHBOR-SLOT slices of
                every atom; the partial T matrices (LJ: partial atomic
                energies) sum over the model axis, and so do the forces
                after the backward pass.
      "atoms" — model shards take complementary ATOM slices of the brick
                (search + energy + grad per slice); forces, energies and
                virials sum over the model axis.
    neighbor: "brute" O(N^2) (tests) | "cells" O(N) brick cell list.
    """
    spec.validate()
    topo = spec.topo
    potential = potential or api.DPPotential(cfg, impl=impl)
    ensemble = ensemble or api.NVE()
    if decomp not in ("slots", "atoms"):
        raise ValueError(f"decomp must be slots or atoms, not {decomp!r}")
    if neighbor not in ("brute", "cells"):
        raise ValueError(f"neighbor must be brute or cells, not {neighbor!r}")
    # the neighbor search only reaches rcut_halo: a potential with a larger
    # cutoff would silently lose every pair beyond it (no flag fires)
    if potential.rcut > spec.rcut_halo + 1e-6:
        raise ValueError(
            f"potential rcut {potential.rcut} exceeds DomainSpec.rcut_halo "
            f"{spec.rcut_halo}: pairs past the halo cutoff would be silently "
            f"dropped")
    # model-axis-divisible padded layout; the normalization is pinned to it
    # (the reference's distributed DP normalizes by the PADDED capacity)
    sel_p = tuple(pad_sel_for(potential.layout_cfg(), n_model).sel)
    nsel_p = int(sum(sel_p))
    pot_p = potential.with_layout(sel_p, nsel_norm=nsel_p)
    # per-shard slice layout: each model shard sees 1/n_model of a section
    pot_local = pot_p.with_layout(tuple(s // n_model for s in sel_p),
                                  nsel_norm=nsel_p)
    cfg_layout = pot_p.layout_cfg()
    rc2 = float(spec.rcut_halo) ** 2
    if decomp == "atoms" and spec.atom_capacity % n_model:
        raise ValueError(f"atom_capacity {spec.atom_capacity} must divide by "
                         f"the model axis ({n_model}) under decomp='atoms'")
    atom_slice = spec.atom_capacity // n_model
    n_centers = atom_slice if decomp == "atoms" else spec.atom_capacity
    plus_pairs = [topo.plus_ring(a) for a in topo.axes]
    minus_pairs = [topo.minus_ring(a) for a in topo.axes]
    nbr_fn = None
    if neighbor == "cells":
        nbr_fn = slab_cells.make_slab_neighbor_fn(
            cfg_layout, spec.box, spec.slab_width, spec.rcut_halo, n_centers,
            cell_capacity=spec.cell_capacity, topology=spec.topology)
    # host constants copied to each device once: a copy from host memory
    # waits for the stream, and no step may wait
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def device_consts(dev):
        if dev not in consts:
            consts[dev] = (
                torch.tensor([a < topo.ndim for a in range(3)], device=dev),
                torch.as_tensor(masses, dtype=torch.float32, device=dev))
        return consts[dev]

    def forces(rank, params, pos, typ, mask, box) -> ForceOut:
        dev = pos.device
        decomposed = device_consts(dev)[0]
        cap = pos.shape[0]
        idx_s = rank.spatial_index
        # per-axis brick geometry from the CARRIED box
        widths = [box[a] / float(topo.shape[a]) for a in topo.axes]
        coords = [topo.coord_along(idx_s, a) for a in topo.axes]
        faces = [coords[a] * widths[a] for a in topo.axes]
        # min-image applies to UNDECOMPOSED axes only: decomposed-axis
        # periodicity is ghost-resolved, and a full-box wrap there would
        # alias ghost images back onto local atoms
        boxm = torch.where(decomposed, 1e30, box)
        geom_ovf = torch.zeros((), dtype=torch.int32, device=dev)
        for a in topo.axes:
            geom_ovf = torch.maximum(
                geom_ovf, (widths[a] < spec.rcut_halo).to(torch.int32))

        # -- staged halo sweeps (x, then y, then z) -----------------------
        pos_all, typ_all, mask_all = pos, typ, mask
        books = []
        h_ovf = torch.zeros((), dtype=torch.int32, device=dev)
        with torch.profiler.record_function("domain.halo_sweeps"):
            for a in topo.axes:
                g_pos, g_typ, g_mask, book, ovf = _halo_sweep(
                    rank, pos_all, typ_all, mask_all, spec, a, coords[a],
                    topo.shape[a], box[a], widths[a], faces[a],
                    plus_pairs[a], minus_pairs[a])
                books.append((pos_all.shape[0], book, a))
                pos_all = torch.cat([pos_all, g_pos], dim=0)
                typ_all = torch.cat([typ_all, g_typ], dim=0)
                mask_all = torch.cat([mask_all, g_mask], dim=0)
                h_ovf = torch.maximum(h_ovf, ovf)

        def reverse_comm(force_all):
            # the transpose: the sweeps IN REVERSE (z, y, x)
            with torch.profiler.record_function("domain.reverse_sweeps"):
                for prefix, book, a in reversed(books):
                    force_all = _reverse_sweep(
                        rank, force_all[:prefix], force_all[prefix:], book,
                        plus_pairs[a], minus_pairs[a])
            return force_all

        brick_lo3 = torch.stack(
            [faces[a] if a < topo.ndim else torch.zeros((), device=dev)
             for a in range(3)])

        if decomp == "atoms":
            # -- model axis slices ATOMS: search + energy + grad per slice --
            start = rank.model_index * atom_slice
            if nbr_fn is not None:
                nlist, n_ovf = nbr_fn(pos_all, typ_all, mask_all, brick_lo3,
                                      start, box=box, widths=widths)
            else:
                nlist_full, n_ovf = _slab_neighbors(
                    pos_all, typ_all, mask_all, cfg_layout, rc2, cap, boxm)
                nlist = nlist_full[start:start + n_centers]
            typ_c = typ[start:start + n_centers]
            mask_c = mask[start:start + n_centers].to(pos.dtype)

            def energy(rij, nmask):
                e_i = pot_p.atomic_energy(params, rij, nmask, typ_c)
                return torch.sum(e_i * mask_c)

            e_slice, f_all, virial = _pair_forces(energy, pos_all, nlist,
                                                  start, boxm)
            # disjoint atom slices: plain sums assemble the brick's values
            e_local = rank.psum(e_slice, MODEL)
            f_all = rank.psum(f_all, MODEL)
            virial = rank.psum(virial, MODEL)
            force = reverse_comm(f_all)
        else:
            # -- model axis slices neighbor SLOTS (summed T matrices) -------
            if nbr_fn is not None:
                nlist, n_ovf = nbr_fn(pos_all, typ_all, mask_all, brick_lo3,
                                      0, box=box, widths=widths)
            else:
                nlist, n_ovf = _slab_neighbors(pos_all, typ_all, mask_all,
                                               cfg_layout, rc2, cap, boxm)
            k = rank.model_index
            parts = []
            for (a0, b0) in cfg_layout.sel_sections():
                w = (b0 - a0) // n_model
                parts.append(nlist[:, a0 + k * w:a0 + (k + 1) * w])
            nlist_slice = torch.cat(parts, dim=1)
            mask_f = mask.to(pos.dtype)

            def energy(rij, nmask):
                # the model-axis sum of T has an identity backward, so this
                # shard's gradient is its slice's part of the forces
                e_i = pot_local.atomic_energy(params, rij, nmask, typ,
                                              comm=rank)
                return torch.sum(e_i * mask_f)

            e_local, f_all, virial = _pair_forces(energy, pos_all,
                                                  nlist_slice, 0, boxm)
            force = reverse_comm(f_all)       # ghost contributions go home
            # complementary slot slices: reduce forces and the virial
            force = rank.psum(force, MODEL)
            virial = rank.psum(virial, MODEL)
        return ForceOut(force, e_local, virial, h_ovf, n_ovf, geom_ovf)

    def step(rank, params, brick: SlabState, ens, box, baro):
        pos, vel, typ, mask, force = brick
        m_vec = device_consts(pos.device)[1][typ]
        # -- velocity Verlet: kick, drift, force, kick ---------------------
        vel = ensemble.half_kick(vel, force, m_vec, dt_fs)
        # decomposed-axis bounds restore via migration; undecomposed axes
        # wrap via min-image in rij
        pos = ensemble.drift(pos, vel, dt_fs, None)
        out = forces(rank, params, pos, typ, mask, box)
        force = out.force
        vel = ensemble.half_kick(vel, force, m_vec, dt_fs)
        vel, ens = ensemble.finalize(vel, m_vec, dt_fs, ens, amask=mask)
        pos = torch.where(mask[:, None], pos, 0.0)

        ke = integrator.kinetic_energy(vel, m_vec, mask)
        kin = integrator.kinetic_tensor(vel, m_vec, mask)
        # -- global sums: one psum of the floats, one of the count, one pmax
        # of the flags; every brick then holds the same global values
        sums = rank.psum(torch.cat([out.e_local.reshape(1), ke.reshape(1),
                                    kin.reshape(9), out.virial.reshape(9)]),
                         SPATIAL)
        n_atoms = rank.psum(mask.sum().to(torch.int32), SPATIAL)
        flags = rank.pmax(torch.stack([out.h_ovf, out.n_ovf, out.geom_ovf]),
                          SPATIAL)
        vol = integrator.volume_of(box)
        stress = integrator.stress_tensor(sums[2:11].reshape(3, 3),
                                          sums[11:20].reshape(3, 3), vol)
        if barostat is not None:
            box, pos, vel, baro = barostat.apply(box, pos, vel, stress,
                                                 baro, dt_fs)
            pos = torch.where(mask[:, None], pos, 0.0)
        thermo = {
            "pe": sums[0], "ke": sums[1], "n_atoms": n_atoms,
            "halo_overflow": flags[0], "nbr_overflow": flags[1],
            "geom_overflow": flags[2], "stress": stress,
            "press": integrator.pressure_of(stress), "vol": vol,
        }
        return (SlabState(pos, vel, typ, mask, force), ens, box, baro), thermo

    return _Local(forces, step, nbr_fn)


class DistributedStep:
    """The distributed MD step over a communicator's ranks.

    ``step(params, state, ens, box, baro) -> ((state, ens, box, baro),
    thermo)`` on the stacked bricks this process holds (leading dim
    ``len(comm.bricks)``); ``ens`` from :func:`init_ensemble_state` (``()``
    for a stateless ensemble), ``box`` the (3,) box tensor, ``baro`` the
    barostat state. Thermo values are 0-d device tensors (the stress
    (3, 3)), the same on every rank.
    """

    def __init__(self, local: _Local, spec: DomainSpec, comm):
        self.local = local
        self.spec = spec
        self.comm = comm

    def __call__(self, params, state: SlabState, ens=(), box=None, baro=()):
        (state, ens, box, baro), th = self.run(params, state, 1, ens, box,
                                               baro)
        return (state, ens, box, baro), {k: v[0] for k, v in th.items()}

    def run(self, params, state: SlabState, n_steps: int, ens=(), box=None,
            baro=()):
        """``n_steps`` steps in one pass over the ranks (each rank loops);
        thermo stacked ``(n_steps, ...)``."""
        if box is None:
            raise ValueError("pass the (3,) box: the dynamic box rides in "
                             "the carry")
        ens = _norm_ens(ens, self.comm)
        step = self.local.step

        def per_brick(rank, brick, ens_b, baro_r):
            return run_brick_steps(rank, step, params,
                                   (brick, ens_b, box, baro_r), n_steps)

        return self._finish(per_brick, state, ens, baro)

    def prime(self, params, state: SlabState, box) -> SlabState:
        """The state with its carried force computed at its positions."""
        forces = self.local.forces
        outs = _on_bricks(
            self.comm, lambda rank, b, e, br: forces(
                rank, params, b.pos, b.typ, b.mask, box).force,
            state, _norm_ens((), self.comm), ())
        return state._replace(force=torch.stack(outs))

    def _finish(self, per_brick, state, ens, baro):
        outs = _on_bricks(self.comm, per_brick, state, ens, baro)
        new_state = _stack_states([o[0][0] for o in outs])
        new_ens = tuple(o[0][1] for o in outs)
        for old, new in zip(ens, new_ens):
            _adopt_gens(old, new)
        _, _, box, baro_new = outs[0][0]
        _adopt_gens(baro, baro_new)
        return (new_state, ens, box, baro), outs[0][1]


def _carry_step(step, rank, params, carry):
    brick, ens, box, baro = carry
    return step(rank, params, brick, ens, box, baro)


def run_brick_steps(rank, step, params, carry, n_steps: int):
    """``n_steps`` of ``step`` (a ``make_local_md_step(...).step``) on one
    rank from ``carry = (brick, ens, box, baro)``; thermo stacked
    ``(n_steps,)``."""
    return stepper.run_steps(lambda c, p: _carry_step(step, rank, p, c),
                             carry, n_steps, params)


def make_distributed_md_step(cfg: Optional[DPConfig], spec: DomainSpec, comm,
                             masses: Tuple[float, ...], dt_fs: float,
                             impl: Optional[str] = None,
                             decomp: str = "slots", neighbor: str = "brute",
                             potential: Optional[api.Potential] = None,
                             ensemble: Optional[api.Ensemble] = None,
                             barostat: Optional[api.Barostat] = None
                             ) -> DistributedStep:
    """The distributed step over ``comm`` (see :class:`DistributedStep` and
    :func:`make_local_md_step` for the options)."""
    if comm.n_spatial != spec.n_slabs:
        raise ValueError(f"communicator has {comm.n_spatial} spatial ranks, "
                         f"the spec {spec.n_slabs} bricks")
    local = make_local_md_step(
        cfg, spec, comm.n_model, masses, dt_fs, impl=impl, decomp=decomp,
        neighbor=neighbor, potential=potential, ensemble=ensemble,
        barostat=barostat)
    return DistributedStep(local, spec, comm)


# ------------------------------------------------------- segment integration

def make_segment_runner(step: DistributedStep):
    """``run(state, params, n_steps, ens=(), box=None, baro=())`` ->
    ``((state, ens, box, baro), thermo)``: ``n_steps`` of ``step`` in one
    pass over the ranks, thermo stacked ``(n_steps,)`` on the device. The
    host touches the device once per segment (:func:`check_segment_thermo`),
    migration runs between segments (:func:`make_migration_step`)."""

    def run(state: SlabState, params, n_steps: int, ens=(), box=None,
            baro=()):
        if box is None:
            raise ValueError("make_segment_runner: pass the (3,) box — the "
                             "dynamic box rides in the carry")
        return step.run(params, state, n_steps, ens, box, baro)

    return run


_FLAG_KEYS = ("geom_overflow", "halo_overflow", "nbr_overflow",
              "mig_overflow")


def check_segment_thermo(thermo) -> None:
    """Per-segment overflow check over a segment's stacked thermo flags,
    fetched from the device in ONE transfer.

    Capacity overflow in a capacity-bounded exchange drops atoms silently,
    so a hard error is the only safe exit: escalation means re-partitioning
    with larger capacities (:func:`escalate_capacities`). ``geom_overflow``
    means the carried box shrank until a brick no longer covers
    ``rcut_halo`` on some decomposed axis: re-partition with fewer bricks
    along that axis.
    """
    keys = [k for k in _FLAG_KEYS if k in thermo]
    flat = [torch.as_tensor(thermo[k]).reshape(-1).to(torch.int64)
            for k in keys]
    host = torch.cat([f.to(flat[0].device) for f in flat]).cpu().numpy()
    got, col = {}, 0
    for k in keys:
        size = int(np.prod(np.shape(thermo[k])))
        got[k] = host[col:col + size].reshape(np.shape(thermo[k]))
        col += size
    if "geom_overflow" in got and int(np.max(got["geom_overflow"])) > 0:
        raise RuntimeError(
            "geom_overflow: the carried box shrank below the brick "
            "decomposition's cutoff+halo geometry (a brick width < "
            "rcut_halo); pairs beyond the single-neighbor halo would be "
            "silently lost — re-partition with fewer bricks on that axis "
            "(DomainSpec topology)")
    for key in _FLAG_KEYS[1:]:
        if key not in got:
            continue
        flags = got[key]
        worst = int(np.max(flags))
        if worst > 0:
            detail = ""
            if key == "mig_overflow" and flags.ndim and flags.shape[-1] > 1:
                axis_worst = np.max(flags.reshape(-1, flags.shape[-1]), 0)
                detail = f" (per-axis worst: {axis_worst.tolist()})"
            msg = (f"{key} by {worst} atoms during segment{detail}; rerun "
                   f"with larger halo/atom capacities (DomainSpec) — "
                   f"capacity-bounded exchanges drop atoms past capacity")
            if worst >= int(neighbors.GRID_INVALID):
                msg = (f"{key}: the carried box moved past the static brick "
                       f"cell grid's validity (a cell dimension < "
                       f"rcut_halo) — the stencil would miss pairs; "
                       f"re-partition from the current box")
            raise RuntimeError(msg)


# ------------------------------------------------------------------ migration
#
# Split into PURE pieces (split / merge: no collectives, fixed send/recv
# capacities) composed around one exchange pair PER DECOMPOSED AXIS in
# _migrate_local: the staged sweeps route a corner-crossing migrant through
# two/three axis-aligned hops.

def split_migrants(pos, vel, typ, mask, spec: DomainSpec, face_lo,
                   width=None, dim: int = 0):
    """Partition a brick into compacted stayers + fixed-capacity send
    packets along ONE axis.

    Returns ``(stayers, left_pkt, right_pkt, pack_ovf)``: ``stayers`` is
    ``(pos_c, vel_c, typ_c, mask_c, n_stay)`` (stay-compacted, stale slots
    ZEROED — a stale copy of a departed atom would coincide with its live
    ghost: NaN force gradients at r = 0) and each packet is
    ``(pos (hc, 3), vel, typ, valid)`` bound for the -/+ neighbor along
    axis ``dim``. ``vel`` may carry more per-atom columns (the step passes
    velocity and carried force side by side). Send capacity is
    ``spec.halo_capacity`` per side; excess migrants are reported in
    ``pack_ovf``.
    """
    if width is None:
        width = spec.brick_widths[dim]
    hc = spec.halo_capacity
    x = pos[:, dim] - face_lo
    go_left = mask & (x < 0)
    go_right = mask & (x >= width)
    stay = mask & ~go_left & ~go_right

    def pack(sel):
        order = torch.argsort((~sel).to(torch.int8), stable=True)
        idx = order[:hc]
        valid = sel[idx]
        ovf = (sel.sum() - valid.sum()).to(torch.int32)
        return (torch.where(valid[:, None], pos[idx], 0.0),
                torch.where(valid[:, None], vel[idx], 0.0),
                torch.where(valid, typ[idx], 0), valid), ovf

    left_pkt, l_ovf = pack(go_left)
    right_pkt, r_ovf = pack(go_right)
    order = torch.argsort((~stay).to(torch.int8), stable=True)
    mask_c = stay[order]
    pos_c = torch.where(mask_c[:, None], pos[order], 0.0)
    vel_c = torch.where(mask_c[:, None], vel[order], 0.0)
    typ_c = torch.where(mask_c, typ[order], 0)
    stayers = (pos_c, vel_c, typ_c, mask_c, stay.sum())
    return stayers, left_pkt, right_pkt, torch.maximum(l_ovf, r_ovf)


def _place(buf, slot, rows):
    """``buf`` with ``rows`` written at ``slot``; a slot of ``len(buf)`` is
    dropped (it lands in a spare row that is cut off)."""
    spare = torch.zeros((1,) + buf.shape[1:], dtype=buf.dtype,
                        device=buf.device)
    return torch.cat([buf, spare]).index_copy(0, slot, rows)[:buf.shape[0]]


def merge_arrivals(stayers, in_l, in_r, idx_s: int, spec: DomainSpec,
                   box=None, dim: int = 0):
    """Append arrival packets to the compacted stayers of one brick.

    ``in_l`` / ``in_r`` are the packets received from the -/+ neighbor
    along axis ``dim`` (each ``(pos, vel, typ, valid)``); ``idx_s`` is this
    brick's COORDINATE along that axis. Periodic wrap along ``dim`` applies
    to migrants that crossed the box ends. Returns ``((pos, vel, typ,
    mask), overflow)`` with arrivals at the first free slots; atom-capacity
    overflow is reported and the excess arrivals dropped (the flag fails the
    segment — the data is never silently wrong). ``box`` carries the
    dynamic geometry; ``None`` keeps the launch-time box.
    """
    n = spec.topology[dim]
    box_d = spec.box[dim] if box is None else box[dim]
    pos_c, vel_c, typ_c, mask_c, n_stay = stayers
    cap = pos_c.shape[0]
    ilp, ilv, ilt, ilval = in_l
    irp, irv, irt, irval = in_r
    # from brick n-1 arriving at brick 0: x ~ box_d -> x - box_d;
    # from brick 0 arriving at brick n-1: x < 0 -> x + box_d
    if idx_s == 0:
        col = ilp[:, dim]
        ilp = ilp.clone()
        ilp[:, dim] = torch.where(ilval & (col >= box_d), col - box_d, col)
    if idx_s == n - 1:
        col = irp[:, dim]
        irp = irp.clone()
        irp[:, dim] = torch.where(irval & (col < 0), col + box_d, col)

    arr_pos = torch.cat([ilp, irp], 0)
    arr_vel = torch.cat([ilv, irv], 0)
    arr_typ = torch.cat([ilt, irt], 0)
    arr_val = torch.cat([ilval, irval], 0)
    # arrival j goes to slot n_stay + rank(j); invalid -> cap (dropped)
    rank = torch.cumsum(arr_val.to(torch.int64), 0) - 1
    slot = torch.where(arr_val, n_stay + rank, cap)
    m_ovf = torch.clamp(torch.max(torch.where(arr_val, slot, 0))
                        - (cap - 1), min=0).to(torch.int32)
    slot = torch.clamp(slot, max=cap)
    pos_c = _place(pos_c, slot, arr_pos)
    vel_c = _place(vel_c, slot, arr_vel)
    typ_c = _place(typ_c, slot, arr_typ)
    mask_c = _place(mask_c, slot, arr_val)
    return (pos_c, vel_c, typ_c, mask_c), m_ovf


def _migrate_local(rank, pos, vel, typ, mask, spec: DomainSpec, box=None):
    """Per-rank migration: staged per-axis sweeps of split -> exchange both
    ways -> merge. After the axis-a sweep every atom sits in the right
    brick column along a; the next sweep routes it within that column.
    Returns ``((pos, vel, typ, mask), per_axis_overflow (ndim,))``, not yet
    reduced over the ranks."""
    topo = spec.topo
    ovfs = []
    with torch.profiler.record_function("domain.migration"):
        for a in topo.axes:
            coord = topo.coord_along(rank.spatial_index, a)
            width = (spec.box[a] if box is None else box[a]) \
                / float(topo.shape[a])
            face_lo = coord * width
            stayers, left_pkt, right_pkt, pack_ovf = split_migrants(
                pos, vel, typ, mask, spec, face_lo, width, a)
            in_l = rank.ppermute(right_pkt, topo.plus_ring(a))
            in_r = rank.ppermute(left_pkt, topo.minus_ring(a))
            if rank.self_image:       # my own leavers re-enter across a face
                in_l = (_shift_axis(in_l[0], a, -width),) + in_l[1:]
                in_r = (_shift_axis(in_r[0], a, width),) + in_r[1:]
            (pos, vel, typ, mask), m_ovf = merge_arrivals(
                stayers, in_l, in_r, coord, spec, box, a)
            ovfs.append(torch.maximum(pack_ovf, m_ovf))
    return (pos, vel, typ, mask), torch.stack(ovfs)


def _migrate_brick(rank, brick: SlabState, spec: DomainSpec, box):
    """Migrate one brick, its carried force riding beside the velocity;
    returns the brick and the per-axis overflow maxed over the ranks."""
    payload = torch.cat([brick.vel, brick.force], dim=1)
    (pos, payload, typ, mask), ovf = _migrate_local(
        rank, brick.pos, payload, brick.typ, brick.mask, spec, box)
    return (SlabState(pos, payload[:, :3].contiguous(), typ, mask,
                      payload[:, 3:].contiguous()),
            rank.pmax(ovf, SPATIAL))


def make_migration_step(spec: DomainSpec, comm):
    """Move atoms that crossed a brick boundary to the neighbor brick.

    ``migrate(state, box=None) -> (state, overflow)``: pass the carried box
    when a barostat moved it. ``overflow`` is a 0-d device tensor (> 0: an
    exchange ran out of capacity).
    """

    def migrate(state: SlabState, box=None):
        if box is None:
            box = stepper.pack_box(spec.box, state.pos.device)

        def per_brick(rank, brick, ens_b, baro_r):
            brick, ovf = _migrate_brick(rank, brick, spec, box)
            return brick, ovf.max()

        outs = _on_bricks(comm, per_brick, state,
                          _norm_ens((), comm), ())
        return _stack_states([o[0] for o in outs]), outs[0][1]

    return migrate


# ------------------------------------------- whole-trajectory outer program

class OuterMDProgram:
    """Distributed MD with migration at segment boundaries, run as one pass
    over the ranks per chunk of segments.

    ``run(state, params, n_segments, seg_len, ens, box, baro)``: every rank
    runs the segments, each one the staged migration sweeps then
    ``seg_len`` steps (halo + rebuild + force + ensemble each step). The
    ensemble state, the box and the barostat state ride through every step.
    Thermo comes back stacked ``(n_segments, seg_len)`` plus
    ``mig_overflow`` ``(n_segments, ndim)``, checked by
    :func:`check_segment_thermo` once per chunk.

    On the card, under a :class:`~repro_torch.md.comm.LocalComm` (every
    rank in one graph) or a :class:`~repro_torch.md.comm.DistComm` (each
    process records its own rank, its NCCL calls included), one segment is
    captured as a CUDA graph once per ``seg_len`` (a :class:`StaticSegment`)
    and :meth:`run` replays it once per segment, as the reference's
    whole-trajectory program is one dispatch: the host issues a replay per
    segment and reads nothing. A failed capture raises, on every process:
    they agree after the warm-up and after the recording, before any
    replay. The overflow flags are maxed over the grid, so every process
    escalates together; an escalation builds a new program, and with it
    new graphs. On the CPU (gloo included), under ``DryRunComm``, and with
    ``capture=False`` (the oracle a capture is held against), every rank
    loops over the segments eagerly in one pass. ``captures``, ``replays``
    and ``capture_s`` count this process's graphs' work.
    """

    def __init__(self, cfg: Optional[DPConfig], spec: DomainSpec, comm,
                 masses: Tuple[float, ...], dt_fs: float,
                 impl: Optional[str] = None, decomp: str = "atoms",
                 neighbor: str = "cells",
                 potential: Optional[api.Potential] = None,
                 ensemble: Optional[api.Ensemble] = None,
                 barostat: Optional[api.Barostat] = None,
                 capture: bool = True):
        self.step = make_distributed_md_step(
            cfg, spec, comm, masses, dt_fs, impl=impl, decomp=decomp,
            neighbor=neighbor, potential=potential, ensemble=ensemble,
            barostat=barostat)
        self.ensemble = ensemble or api.NVE()
        self.barostat = barostat
        self.spec = spec
        self.comm = comm
        self.capture = capture
        self._graphs: Dict[int, StaticSegment] = {}
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def init_ensemble_state(self, device) -> Tuple:
        return init_ensemble_state(self.ensemble, self.comm, device)

    def init_barostat_state(self, device) -> Any:
        """REPLICATED barostat state (every brick draws the same noise)."""
        return (self.barostat.init_state(torch.device(device))
                if self.barostat is not None else ())

    def prime(self, params, state: SlabState, box) -> SlabState:
        return self.step.prime(params, state, box)

    def run(self, state: SlabState, params, n_segments: int, seg_len: int,
            ens=(), box=None, baro=()):
        """Returns ``(state, ens, box, baro, thermo)``. On the card the
        returned state and box are the graph's static buffers, which the
        next replay overwrites: copy them to keep them."""
        if box is None:
            box = stepper.pack_box(self.spec.box, state.pos.device)
        ens = _norm_ens(ens, self.comm)
        if self.captures_on(state):
            return self._replay(state, params, n_segments, seg_len, ens, box,
                                baro)
        spec, step = self.spec, self.step.local.step

        def per_brick(rank, brick, ens_b, baro_r):
            return run_outer_brick(rank, step, spec, params,
                                   (brick, ens_b, box, baro_r), n_segments,
                                   seg_len)

        (state, ens, box, baro), th = self.step._finish(per_brick, state,
                                                        ens, baro)
        return state, ens, box, baro, th

    def captures_on(self, state: SlabState) -> bool:
        """Whether :meth:`run` records and replays graphs for ``state``."""
        return (self.capture and state.pos.is_cuda and isinstance(
            self.comm, (comm_mod.LocalComm, comm_mod.DistComm)))

    def _replay(self, state, params, n_segments, seg_len, ens, box, baro):
        seg = self._graphs.get(seg_len)
        if seg is not None and seg.params is not params:
            raise ValueError("the captured segment was recorded for other "
                             "params")
        if seg is None:
            t0 = time.perf_counter()
            seg = StaticSegment(self, params, (state, ens, box, baro),
                                seg_len)
            # the segments of one program share one memory pool
            pool = next((g.graph.pool() for g in self._graphs.values()
                         if g.graph is not None), None)
            on_every_process(self.comm, "capture",
                             lambda: seg.capture(pool))
            self._graphs[seg_len] = seg
            self.captures += 1
            self.capture_s += time.perf_counter() - t0
        seg.load(state, ens, box, baro)
        ths = []
        for _ in range(n_segments):
            ths.append(seg.replay())
            self.replays += 1
        seg.store_gens(ens, baro)
        return (seg.state, ens, seg.box, baro,
                {k: torch.cat([t[k] for t in ths]) for k in ths[0]})


#: every StaticSegment that holds a graph, weakly: NCCL does not destroy a
#: communicator while a graph that captured its calls lives
_RECORDED: "weakref.WeakSet[StaticSegment]" = weakref.WeakSet()


def release_graphs() -> None:
    """Drop the graph of every live :class:`StaticSegment` (they then run
    eagerly). Call it before ``torch.distributed.destroy_process_group``,
    also after a run raised, whose frames may still hold its programs:
    destroying a NCCL communicator waits for every graph that recorded its
    calls, for ever."""
    for seg in list(_RECORDED):
        seg.graph = None


def on_every_process(comm, what: str, fn: Callable[[], Any]) -> Any:
    """``fn()``, then every process of ``comm`` learns whether all of them
    got through it (``comm.agree``): the one that failed raises its error
    and the others raise too. A process that went on alone would wait in a
    collective, or in a replay's NCCL kernels, forever."""
    try:
        out = fn()
    except BaseException:
        comm.agree(False)
        raise
    if not comm.agree(True):
        raise RuntimeError(f"the segment's {what} failed on another process")
    return out


class StaticSegment:
    """One segment of :meth:`OuterMDProgram.run` on every rank this process
    runs (``comm.ranks``: all of a :class:`~repro_torch.md.comm.LocalComm`,
    the one of a :class:`~repro_torch.md.comm.DistComm`) over static carry
    buffers: the staged migration sweeps then ``seg_len`` steps from
    ``state`` (the stacked bricks held here, ``comm.bricks``) and ``box``,
    with the new bricks and box written back into them, so n calls run n
    segments in a row.

    Each rank draws from generators of its own that live as long as the
    segment (``trees``: rank -> (ensemble state, barostat state)), since a
    graph draws from the generator objects it was recorded with; the model
    shards of one brick start from the same states and stay equal.
    :meth:`load` sets them to the caller's states and :meth:`store_gens`
    gives the caller those of each held brick's lowest model shard here.

    :meth:`capture` (the card) records the segment as a CUDA graph after
    a one-step warm-up on copies, which issues every collective the
    segment makes (NCCL sets up communicators and peers on first use, which
    a capture refuses); :meth:`replay` then replays it, and otherwise runs
    the same function eagerly. Ensemble and barostat states carry their
    generators only, as in the eager program.
    """

    def __init__(self, program: OuterMDProgram, params, carry, seg_len: int):
        state, ens, box, baro = carry
        # the program's parts, not the program: it holds its segments, and
        # a cycle would keep a dropped program's graphs and pool alive
        comm = self.comm = program.comm
        self._step, self._spec = program.step.local.step, program.spec
        self.params, self.seg_len = params, seg_len
        self.state = SlabState(*(None if x is None else x.clone()
                                 for x in state))
        self.box = box.clone()
        self.trees = {r: (_clone_gens(ens[self._held(r)]), _clone_gens(baro))
                      for r in comm.ranks}
        self.graph = None

    def _held(self, rank: int) -> int:
        """The index in ``comm.bricks`` of ``rank``'s brick."""
        return self.comm.bricks.index(rank // self.comm.n_model)

    def _segment(self, state: SlabState, box, seg_len: int):
        """One segment from ``(state, box)``, written back into them; the
        thermo stacked ``(1, seg_len)``."""
        step, spec, params = self._step, self._spec, self.params

        def per_brick(rank, brick, ens_r, baro_r):
            return run_outer_brick(rank, step, spec, params,
                                   (brick, ens_r, box, baro_r), 1, seg_len)

        outs = _on_bricks(self.comm, per_brick, state, None, None,
                          self.trees)
        new = _stack_states([o[0][0] for o in outs])
        for dst, src in zip(state, new):
            if dst is not None:
                dst.copy_(src)
        box.copy_(outs[0][0][2])
        return outs[0][1]

    def capture(self, pool=None) -> None:
        """Record the segment as a CUDA graph (``capture_error_mode``
        "thread_local": the rank threads and autograd's device thread add
        work to the graph beside the capturing thread)."""
        warm = stepper.snapshot((self.state, self.box)).carry
        self.graph, self.thermo, self.launches = stepper.capture_graph(
            lambda: self._segment(self.state, self.box, self.seg_len),
            lambda: on_every_process(self.comm, "warm-up",
                                     lambda: self._segment(*warm, 1)),
            stepper.generators_of(self.trees), pool, "thread_local")
        _RECORDED.add(self)

    def load(self, state: SlabState, ens, box, baro) -> None:
        """Copy the carry into the static buffers (no-op for the buffers
        themselves) and every rank's generators to the caller's states."""
        if state.pos is not self.state.pos:
            for dst, src in zip(self.state, state):
                if dst is not None:
                    dst.copy_(src)
        if box is not self.box:
            self.box.copy_(box)
        for r, (ens_r, baro_r) in self.trees.items():
            _adopt_gens(ens_r, ens[self._held(r)])
            _adopt_gens(baro_r, baro)

    def store_gens(self, ens, baro) -> None:
        """The caller's generators take the states of each held brick's
        ranks here (its model shards draw alike; the barostat's: any
        rank's, all draw alike)."""
        for r, (ens_r, baro_r) in self.trees.items():
            _adopt_gens(ens[self._held(r)], ens_r)
        _adopt_gens(baro, baro_r)

    def replay(self) -> Dict[str, torch.Tensor]:
        """One segment: the graph's replay (its thermo copied out of the
        graph's pool), or the segment run eagerly before :meth:`capture`."""
        if self.graph is None:
            return self._segment(self.state, self.box, self.seg_len)
        self.graph.replay()
        dp_fused_ops.count_replay(*self.launches)
        return {k: v.clone() for k, v in self.thermo.items()}


def run_outer_brick(rank, step, spec: DomainSpec, params, carry,
                    n_segments: int, seg_len: int):
    """One rank's share of :meth:`OuterMDProgram.run`: ``n_segments`` rounds
    of the staged migration sweeps then ``seg_len`` steps of ``step`` (a
    ``make_local_md_step(...).step``) from ``carry = (brick, ens, box,
    baro)``. Returns the carry and the thermo stacked ``(n_segments,
    seg_len)``, with ``mig_overflow`` ``(n_segments, ndim)``."""
    ths = []
    for _ in range(n_segments):
        brick, ens_b, box_c, baro_c = carry
        brick, mig = _migrate_brick(rank, brick, spec, box_c)
        carry, th = run_brick_steps(rank, step, params,
                                    (brick, ens_b, box_c, baro_c), seg_len)
        th["mig_overflow"] = mig
        ths.append(th)
    return carry, {k: torch.stack([t[k] for t in ths]) for k in ths[0]}


def make_outer_md_program(cfg: Optional[DPConfig], spec: DomainSpec, comm,
                          masses: Tuple[float, ...], dt_fs: float,
                          **kw) -> OuterMDProgram:
    return OuterMDProgram(cfg, spec, comm, masses, dt_fs, **kw)
