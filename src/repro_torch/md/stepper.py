"""MD stepping engines: the inner loop between neighbor rebuilds, and the
outer engine that folds the rebuild in.

The counterpart of ``repro.md.stepper``. Where the reference scans a jitted
step over a ``rebuild_every``-step segment, :class:`SegmentEngine` runs the
step in a Python loop under ``torch.no_grad()``; the per-step thermo stays
on the device, stacked, and the host fetches it ONCE per segment
(:func:`fetch_thermo`). The descriptor normalization stays pinned to the
model's native ``cfg.nsel`` (``nsel_norm``), so escalated capacities change
padding, never physics.

:class:`OuterEngine` is the counterpart of the reference's jitted scan over
segments: one segment is the neighbor rebuild at the carried positions and
box followed by ``seg_len`` steps, with the overflow flag kept on the
device. On the card each segment is captured once as a CUDA graph and
replayed; on the CPU the same segment function runs eagerly.

:class:`Capacities` holds a run's capacities and makes the one regrow
decision after each fetched segment or chunk (``md/driver.py``).

The box rides in the carry; a barostat rescales it after each step's
thermostat, and the thermo streams the stress tensor, pressure and volume.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.types import DPConfig
from repro_torch.kernels.dp_fused import attention as attention_ops
from repro_torch.kernels.dp_fused import env as env_ops
from repro_torch.kernels.dp_fused import force as force_ops
from repro_torch.kernels.dp_fused import ops as dp_fused_ops
from repro_torch.md import api, integrator, neighbors


def segment_schedule(steps: int, rebuild_every: int) -> List[int]:
    """Segment lengths at rebuild cadence: :func:`chunk_schedule`'s."""
    return [n for _, n in chunk_schedule(steps, rebuild_every, 1)]


def run_steps(step_fn: Callable, carry: Any, n_steps: int, *aux: Any):
    """``n_steps`` of ``step_fn(carry, *aux) -> (carry, per_step_out)``.

    The per-step outputs come back stacked with a leading ``(n_steps,)``
    dim; nothing here waits for the device.
    """
    outs = []
    for _ in range(n_steps):
        carry, out = step_fn(carry, *aux)
        outs.append(out)
    return carry, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


#: the reference's name for the inner loop (a ``lax.scan`` there)
scan_segment = run_steps


class SegmentEngine:
    """Runs ``step_fn(carry, *aux) -> (carry, per_step_out)`` for ``n_steps``.

    The loop runs under ``torch.no_grad()`` (forces take their own graph
    inside the potential, so no graph survives a step).
    """

    def __init__(self, step_fn: Callable):
        self._step_fn = step_fn

    def run(self, carry: Any, n_steps: int, *aux: Any):
        with torch.no_grad():
            return run_steps(self._step_fn, carry, n_steps, *aux)


def fetch_thermo(th: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copy stacked thermo to the host in ONE transfer.

    Every entry shares the leading dim; each comes back as float32 with its
    own shape.
    """
    keys = list(th)
    n = th[keys[0]].shape[0]
    flat = torch.cat([th[k].reshape(n, -1).to(torch.float32) for k in keys],
                     dim=1).cpu().numpy()
    out, col = {}, 0
    for k in keys:
        width = int(np.prod(th[k].shape[1:]))
        out[k] = flat[:, col:col + width].reshape(th[k].shape)
        col += width
    return out


# ------------------------------------------------- capacity escalation policy

@dataclasses.dataclass(frozen=True)
class EscalationPolicy:
    """Geometric capacity growth on neighbor overflow (checked per segment)."""
    growth: float = 1.6
    max_attempts: int = 6
    round_to: int = 8

    def grow(self, n: int, scale: float = 1.0) -> int:
        """Grow ``n`` by ``max(growth, scale)``, rounded up to ``round_to``.

        ``scale`` folds an external density factor into the decision — the
        launch-volume / carried-volume ratio under a barostat squeeze — so
        a replay jumps straight to a capacity that holds the current
        density.
        """
        factor = max(self.growth, float(scale))
        n_new = max(int(n * factor), n + 1)
        return -(-n_new // self.round_to) * self.round_to

    def escalate(self, spec: neighbors.NeighborSpec,
                 excess: Optional[Tuple[int, ...]], scale: float = 1.0
                 ) -> Tuple[neighbors.NeighborSpec, Tuple[str, ...]]:
        """``spec`` with the capacity that overflowed grown, and the names
        of what grew (``"sel"``, ``"cell"``).

        ``excess`` is what a build's flag is made of: ``(section_excess,
        bin_excess)``, ``(section_excess,)`` on the brute-force path, which
        has no bins, or None where only the merged flag is known. A
        section's excess grows every type section's ``sel``, a bin's the
        ``cell_capacity``; an unknown cause grows both. While bins
        overflow, the candidates they drop go uncounted, so the sections'
        excess can read low: the rebuild shows a section that really
        overflows. ``scale`` (see :meth:`grow`) folds into whatever grows.
        """
        if excess is None:
            grew = ("sel", "cell")
        else:
            grew = (("sel",) * (excess[0] > 0)
                    + ("cell",) * (len(excess) > 1 and excess[1] > 0))
        if "sel" in grew:
            spec = dataclasses.replace(
                spec, sel=tuple(self.grow(s, scale) for s in spec.sel))
        if "cell" in grew:
            spec = dataclasses.replace(
                spec, cell_capacity=self.grow(spec.cell_capacity, scale))
        return spec, grew

    @staticmethod
    def volume_scale(box_ref, box_now) -> float:
        """Launch-volume / current-volume, clamped >= 1 (grow-only)."""
        v0 = float(np.prod(np.asarray(box_ref, float).reshape(-1)))
        v1 = float(np.prod(np.asarray(box_now, float).reshape(-1)))
        return max(v0 / max(v1, 1e-30), 1.0)


class NeighborBuild(NamedTuple):
    nlist: torch.Tensor
    cfg_run: DPConfig             # cfg with sel matching the nlist layout
    spec: neighbors.NeighborSpec  # possibly escalated
    escalations: int
    overflow: int = 0             # worst flag seen across build attempts
    #                               (> 0 iff escalation fired; <= 0: slack)


def grid_key_for(spec: neighbors.NeighborSpec,
                 box: np.ndarray) -> Tuple[int, ...]:
    """The static cell-grid signature of ``box``: cells per dimension."""
    return tuple(int(n) for n in np.maximum(
        np.floor(np.asarray(box, float) / spec.rcut_nbr).astype(int), 1))


def _dyn_cell_list_fn(spec: neighbors.NeighborSpec, grid_key: Tuple[int, ...]):
    """Dynamic-box neighbor fn for the cell grid ``grid_key``.

    The reference box is ``(k + 0.5) * rcut_nbr``: ``k * rcut_nbr`` can
    floor back to ``k - 1`` in float and build a different grid than the
    key claims.
    """
    ref_box = (np.asarray(grid_key, float) + 0.5) * spec.rcut_nbr
    return neighbors.make_cell_list_fn(spec, ref_box, dynamic_box=True)


def build_neighbors_escalating(
    cfg: DPConfig, spec: neighbors.NeighborSpec, box: np.ndarray,
    pos: torch.Tensor, typ: torch.Tensor,
    policy: Optional[EscalationPolicy] = None,
    ref_box: Optional[np.ndarray] = None,
) -> NeighborBuild:
    """Build the neighbor list; on overflow escalate capacities and retry.

    This is the host sync of a segment boundary: the overflow flag of the
    fresh list decides escalation. Escalation grows what overflowed
    (:meth:`EscalationPolicy.escalate`): every type section's capacity,
    the cell-bin capacity, or both; then it rebuilds from the same
    positions. The returned ``cfg_run`` carries the escalated ``sel``;
    callers evaluate it with ``nsel_norm=cfg.nsel``. The cell grid is
    derived from ``box`` on every call. ``ref_box`` (the box the last
    volume fold was taken against) folds the carried-box volume ratio into
    the first escalation.

    Each attempt is an ``nbr.build`` span. Its counters say what overflowed
    (``section_excess``, ``bin_excess``: > 0 where a type section or a cell
    bin ran out; ``bin_excess`` None on the brute-force path) and how many
    slots the list ``filled``; they come to the host in the flag's fetch.
    An attempt that escalates names what it ``grew``.
    """
    policy = policy or EscalationPolicy()
    box_np = np.asarray(box, float).reshape(-1)
    box_t = torch.as_tensor(box_np, dtype=torch.float32, device=pos.device)
    scale = (policy.volume_scale(ref_box, box_np)
             if ref_box is not None else 1.0)
    escalations = 0
    worst = None
    for attempt in range(policy.max_attempts):
        with obs.span("nbr.build", attempt=attempt, atoms=int(pos.shape[0]),
                      sel=tuple(spec.sel),
                      cell_capacity=spec.cell_capacity) as sp:
            fn = _dyn_cell_list_fn(spec, grid_key_for(spec, box_np))
            nlist, ovf, parts = fn(pos, typ, box_t, parts=True)
            # the flag, its parts and the filled slots in one fetch
            got = torch.cat([ovf.reshape(1).to(torch.int64),
                             parts.to(torch.int64),
                             (nlist >= 0).sum().reshape(1)]).tolist()
            ovf, excess = got[0], tuple(got[1:-1])
            sp.set(overflow=ovf, section_excess=excess[0],
                   bin_excess=excess[1] if len(excess) == 2 else None,
                   filled=got[-1])
            if ovf > 0:
                grown, grew = policy.escalate(spec, excess, scale)
                sp.set(grew=grew)
        worst = ovf if worst is None else max(worst, ovf)
        if ovf <= 0:
            cfg_run = (cfg if tuple(spec.sel) == tuple(cfg.sel)
                       else dataclasses.replace(cfg, sel=tuple(spec.sel)))
            return NeighborBuild(nlist, cfg_run, spec, escalations, worst)
        spec = grown
        scale = 1.0     # the density jump is folded in once
        escalations += 1
    raise RuntimeError(
        f"neighbor capacity overflow persists after {policy.max_attempts} "
        f"escalations (last spec: sel={spec.sel}, "
        f"cell_capacity={spec.cell_capacity})")


# -------------------------------------------------- the run's capacities

class Capacities:
    """A single-process run's capacities, and the one rule that grows them:
    the list's type sections and cell bins (``spec``), its cell grid
    (``grid_key``, which a barostat's box can outgrow) and a potential's
    own sections (``potential.capacities``, named by its
    ``section_names``: DPA-1's one, DPA-2's two). It makes the host builds
    and reads each stretch's fetched thermo (:meth:`regrow`: a scan
    ``"segment"`` or an outer ``"chunk"``)."""

    def __init__(self, potential: api.Potential,
                 spec: neighbors.NeighborSpec, box: np.ndarray,
                 policy: Optional[EscalationPolicy] = None,
                 moving_box: bool = False):
        self.potential, self.spec = potential, spec
        self.policy = policy or EscalationPolicy()
        self.box = np.asarray(box, float)
        self.moving_box = moving_box    # a barostat moves the carried box
        self.grid_key = grid_key_for(spec, self.box)
        self.ref_box = self.box         # the box of the last volume fold
        self.escalations = self.host_syncs = self.overflow_checks = 0
        self.grid_rebuilds = 0
        self.overflow_worst: Optional[int] = None

    @property
    def run_potential(self) -> api.Potential:
        return self.potential.with_layout(self.spec.sel)

    def can_regrow(self, where: str) -> bool:
        """Whether a stretch can overflow (so needs a snapshot)."""
        return where == "chunk" or hasattr(self.potential, "section_count")

    def host_build(self, pos: torch.Tensor, typ: torch.Tensor,
                   box: torch.Tensor) -> Tuple[torch.Tensor, api.Potential]:
        """The list at ``pos`` and the carried ``box`` (escalated until it
        fits) and the section fitted to it: the list and the potential at
        its layout. Under a barostat a build after the first fetches the
        box, re-derives the cell grid and folds the volume lost since the
        last fold into its first escalation."""
        first = self.overflow_worst is None
        box_now = self.box
        if self.moving_box and not first:
            box_now = box.cpu().numpy().astype(float)
            self.host_syncs += 1
            key = grid_key_for(self.spec, box_now)
            if key != self.grid_key:
                self.grid_key = key
                self.grid_rebuilds += 1
        build = build_neighbors_escalating(
            self.potential.layout_cfg(), self.spec, box_now, pos, typ,
            self.policy, ref_box=self.ref_box)
        if build.escalations:
            self.ref_box = box_now
        self.accept(build, self._fit_section(build.nlist, pos, box))
        return build.nlist, self.run_potential

    def accept(self, build: NeighborBuild, fitted: int = 0) -> None:
        """Take an accepted host build's layout; count its attempts and the
        section's ``fitted`` growths (flags inspected too, at the first)."""
        first = self.overflow_worst is None
        self.spec = build.spec
        self.host_syncs += 1
        self.overflow_checks += build.escalations + 1 + (fitted if first else 0)
        self.escalations += build.escalations
        self.overflow_worst = (build.overflow if first
                               else max(self.overflow_worst, build.overflow))

    def regrow(self, host: Dict[str, np.ndarray], where: str) -> bool:
        """Grow what a stretch overflowed, from its fetched thermo; True
        when it must run again from its snapshot.

        An outer chunk's thermo holds its in-graph rebuilds' merged flag
        and its box: ``GRID_INVALID`` re-derives the cell grid, any other
        excess grows both list capacities (the cause is unknown), by the
        volume lost since the last fold too. Each of a potential's
        sections that overflowed grows to hold the most of its
        ``api.MODEL_EXCESS`` seen; the others keep their slots."""
        self.host_syncs += 1
        overflowed = False
        if "overflow" in host:
            ovf = int(host["overflow"][0])
            box = host["box"][0].astype(float)
            self.overflow_checks += 1
            if ovf >= int(neighbors.GRID_INVALID):
                # geometry, not capacity: the box outgrew the cell grid.
                # Re-derive it from the post-chunk box (a smaller box's
                # coarser counts keep cells >= rcut for the chunk's larger
                # early boxes too); a box that dipped and recovered gives
                # the old key back, so coarsen by one.
                key = grid_key_for(self.spec, box)
                if key == self.grid_key:
                    key = tuple(max(1, k - 1) for k in self.grid_key)
                self.grid_key = key
                self.grid_rebuilds += 1
                return True
            self.overflow_worst = max(self.overflow_worst, ovf)
            if ovf > 0:
                # a later fold takes only the volume lost after this one
                scale = self.policy.volume_scale(self.ref_box, box)
                self.ref_box = box
                self.spec, _ = self.policy.escalate(self.spec, None, scale)
                self.escalations += 1
                overflowed = True
        grew = False
        if api.MODEL_EXCESS in host:
            excess = np.asarray(host[api.MODEL_EXCESS]).reshape(
                -1, len(self.potential.capacities)).max(axis=0)
            grew = self._grow_sections([int(x) for x in excess], where)
        return overflowed or grew

    def give_up(self, where: str) -> RuntimeError:
        n, spec = self.policy.max_attempts, self.spec
        return RuntimeError(
            f"the model's section overflows after {n} segment replays "
            f"({self.potential.slots} slots)" if where == "segment" else
            f"neighbor capacity overflow persists after {n} chunk replays "
            f"(last spec: sel={spec.sel}, cell_capacity={spec.cell_capacity})")

    def counters(self) -> Dict[str, Any]:
        return dict(escalations=self.escalations, host_syncs=self.host_syncs,
                    overflow_checks=self.overflow_checks,
                    overflow_worst=self.overflow_worst,
                    grid_rebuilds=self.grid_rebuilds, sel=tuple(self.spec.sel),
                    section_slots=getattr(self.potential, "slots", 0))

    def _grow_sections(self, excess: List[int], where: str) -> bool:
        """Grow each section whose ``excess`` (one a section) is > 0 to
        hold that many more pairs, and no other: an escalation each, one
        ``model.escalate`` span each, its counters the ``section``, the
        slots before and after, the excess and ``where`` (``build``,
        ``segment``, ``chunk``). True when one grew."""
        slots = list(self.potential.capacities)
        names = self.potential.section_names
        for i, more in enumerate(excess):
            if more <= 0:
                continue
            grown = self.policy.grow(slots[i])
            while grown < slots[i] + more:
                grown = self.policy.grow(grown)
            with obs.span("model.escalate", section=names[i], where=where,
                          excess=int(more), slots=slots[i], grown=grown):
                slots[i] = grown
                self.potential = self.potential.with_capacities(tuple(slots))
            self.escalations += 1
        return max(excess, default=0) > 0

    def _fit_section(self, nlist: torch.Tensor, pos: torch.Tensor,
                     box: torch.Tensor) -> int:
        """Grow a potential's own sections (``section_count``) until the
        pairs of ``nlist`` within their cut-offs fit; returns the growths.
        Each count, fetched in one transfer for every section, gives one
        ``model.section`` span a section with the counters ``section``,
        ``atoms``, ``slots``, ``live`` and ``excess``."""
        if not hasattr(self.potential, "section_count"):
            return 0
        for grown in range(self.policy.max_attempts):
            pot = self.potential
            counts = pot.section_count(pos, nlist, box).reshape(-1, 2)
            counts = counts.tolist()
            for name, slots, (live, excess) in zip(
                    pot.section_names, pot.capacities, counts):
                with obs.span("model.section", section=name,
                              atoms=int(pos.shape[0]), slots=slots) as sp:
                    sp.set(live=live, excess=excess)
            if not self._grow_sections([ex for _, ex in counts], "build"):
                return grown
        raise RuntimeError(f"the model's section overflows after "
                           f"{self.policy.max_attempts} escalations "
                           f"({self.potential.slots} slots)")


# --------------------------------------------- single-process MD step

class MDCarry(NamedTuple):
    """State carried from step to step.

    ``ens`` is the ensemble's extra state (a generator for Langevin, empty
    for NVE); ``box`` the (3,) dynamic box; ``baro`` the barostat's extra
    state.
    """
    pos: torch.Tensor     # (N, 3) A
    vel: torch.Tensor     # (N, 3) A/fs
    force: torch.Tensor   # (N, 3) eV/A
    ens: Any = ()
    box: Any = None       # (3,) A
    baro: Any = ()


#: the reference's legacy name for the step carry
VVCarry = MDCarry


def make_md_step(potential: api.Potential, ensemble: api.Ensemble,
                 barostat: Optional[api.Barostat] = None) -> Callable:
    """One kick-drift-(force)-kick step of ``ensemble`` under ``potential``.

    ``(MDCarry, params, nlist, typ, masses, dt) -> (MDCarry, thermo)``; the
    thermo holds pe/ke plus the pressure observables (stress tensor (3, 3)
    eV/A^3, scalar pressure, volume) from the potential's virial, and the
    excess of a potential's own neighbour section (``api.MODEL_EXCESS``)
    where it has one, so that it reaches the host with the thermo. After the
    thermostat the ``barostat`` (if any) rescales box, positions and
    velocities; without one the box is never touched.
    """

    def md_step(carry: MDCarry, params, nlist, typ, masses, dt):
        pos, vel, f, ens, box, baro = carry
        vel = ensemble.half_kick(vel, f, masses, dt)
        pos = ensemble.drift(pos, vel, dt, box)
        e, f_new, stats = potential.energy_forces(params, pos, typ, nlist,
                                                  box=box)
        vel = ensemble.half_kick(vel, f_new, masses, dt)
        vel, ens = ensemble.finalize(vel, masses, dt, ens)
        ke = integrator.kinetic_energy(vel, masses)
        vol = integrator.volume_of(box)
        stress = integrator.stress_tensor(
            integrator.kinetic_tensor(vel, masses), stats["virial"], vol)
        if barostat is not None:
            box, pos, vel, baro = barostat.apply(box, pos, vel, stress,
                                                 baro, dt)
        thermo = {"pe": e, "ke": ke, "stress": stress,
                  "press": integrator.pressure_of(stress), "vol": vol}
        if api.MODEL_EXCESS in stats:
            thermo[api.MODEL_EXCESS] = stats[api.MODEL_EXCESS]
        return MDCarry(pos, vel, f_new, ens, box, baro), thermo

    return md_step


def md_segment_engine(potential: api.Potential, ensemble: api.Ensemble,
                      barostat: Optional[api.Barostat] = None
                      ) -> SegmentEngine:
    """Engine whose step is one full kick-drift-(force)-kick MD step."""
    return SegmentEngine(make_md_step(potential, ensemble, barostat))


def make_vv_step(cfg_run: DPConfig, impl: Optional[str],
                 nsel_norm: Optional[int]) -> Callable:
    """Legacy DP + NVE step body (the reference's shim over
    :func:`make_md_step`)."""
    return make_md_step(api.DPPotential(cfg_run, impl, nsel_norm), api.NVE())


def vv_segment_engine(cfg_run: DPConfig, impl: Optional[str],
                      nsel_norm: Optional[int]) -> SegmentEngine:
    """Legacy DP + NVE engine (shim over :func:`md_segment_engine`). The
    reference's ``donate`` flag is JAX buffer donation and has no
    counterpart here."""
    return md_segment_engine(api.DPPotential(cfg_run, impl, nsel_norm),
                             api.NVE())


# ------------------------------------------------ carried state, by value

def _map_state(fn_tensor, fn_gen, tree):
    if isinstance(tree, torch.Tensor):
        return fn_tensor(tree)
    if isinstance(tree, torch.Generator):
        return fn_gen(tree)
    if isinstance(tree, dict):
        return {k: _map_state(fn_tensor, fn_gen, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_state(fn_tensor, fn_gen, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_state(fn_tensor, fn_gen, v) for v in tree)
    return tree


def generators_of(tree) -> List[torch.Generator]:
    """Every ``torch.Generator`` in a carry (ensemble/barostat noise)."""
    found: List[torch.Generator] = []
    _map_state(lambda t: t, found.append, tree)
    return found


class Snapshot(NamedTuple):
    """A carry by value: its tensors copied on the device (no host sync) and
    its generators' states, so a restored chunk draws the same noise."""
    carry: Any
    rng: List[Tuple[torch.Generator, torch.Tensor]]


def snapshot(carry) -> Snapshot:
    copy = _map_state(lambda t: t.clone(), lambda g: g, carry)
    return Snapshot(copy, [(g, g.get_state()) for g in generators_of(carry)])


def restore(snap: Snapshot):
    """The snapshot's carry, with every generator set back to its state.

    The returned tensors are the snapshot's own; engines never write to a
    carry they are given, so one snapshot serves any number of restores.
    """
    for gen, state in snap.rng:
        gen.set_state(state)
    return snap.carry


# ------------------------------------------------ outer engine (segments)

class OuterCarry(NamedTuple):
    """Carry of the outer engine over segments.

    ``overflow`` accumulates the worst neighbor-capacity excess seen by any
    on-device rebuild in the chunk; it is the only value the host inspects,
    once per chunk. ``ens``/``box``/``baro`` thread the ensemble state, the
    dynamic box and the barostat state (a box past its static cell grid
    surfaces through ``overflow`` as ``neighbors.GRID_INVALID``).
    """
    pos: torch.Tensor       # (N, 3) A
    vel: torch.Tensor       # (N, 3) A/fs
    force: torch.Tensor     # (N, 3) eV/A
    overflow: torch.Tensor  # () int32
    ens: Any = ()
    box: Any = None         # (3,) A
    baro: Any = ()


def _same_inputs(a, b) -> bool:
    """Captured inputs are baked into a graph by address: tensors and
    dicts must be the same objects, numbers equal."""
    return len(a) == len(b) and all(
        x is y if isinstance(x, (torch.Tensor, dict)) else x == y
        for x, y in zip(a, b))


# the side stream of every capture's warm-up, one a device: PyTorch keeps
# cuBLAS workspaces for each stream a product ran on, for the life of the
# process (32 MiB each on the H100), so a new stream a capture held 64 MiB
# more each call of the outer engine
_warm_streams: Dict[int, torch.cuda.Stream] = {}


def _warm_stream() -> torch.cuda.Stream:
    dev = torch.cuda.current_device()
    if dev not in _warm_streams:
        _warm_streams[dev] = torch.cuda.Stream(dev)
    return _warm_streams[dev]


def capture_graph(fn: Callable[[], Any], warm: Callable[[], Any],
                  gens: List[torch.Generator], pool=None,
                  error_mode: str = "global"):
    """Record ``fn()`` as a CUDA graph; returns ``(graph, fn's output,
    the launches the graph recorded)``: dp_fused forward, backward, the
    force reduction, DPA-1's attention forward and backward and the
    environment matrix's forward and backward, as :func:`count_replay`
    takes them.

    ``warm()`` runs first on a side stream, as capture requires (its kernels
    really run and count as launches), and ``gens`` are set back to their
    states afterwards. Each CUDA generator in ``gens`` is registered with the
    graph: each replay then draws fresh noise from the generator's current
    offset, and a restored state draws the same again. ``error_mode`` is
    ``torch.cuda.graph``'s ``capture_error_mode``.
    """
    states = [g.get_state() for g in gens]
    side = _warm_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm()
    torch.cuda.current_stream().wait_stream(side)
    for gen, state in zip(gens, states):
        gen.set_state(state)

    graph = torch.cuda.CUDAGraph()
    for gen in gens:
        if gen.device.type == "cuda":
            graph.register_generator_state(gen)
    f0, b0 = dp_fused_ops.fwd_captured, dp_fused_ops.bwd_captured
    r0 = force_ops.force_captured
    a0, a1 = attention_ops.attn_fwd_captured, attention_ops.attn_bwd_captured
    e0, e1 = env_ops.env_fwd_captured, env_ops.env_bwd_captured
    with torch.cuda.graph(graph, pool=pool, capture_error_mode=error_mode):
        out = fn()
    return graph, out, (dp_fused_ops.fwd_captured - f0,
                        dp_fused_ops.bwd_captured - b0,
                        force_ops.force_captured - r0,
                        attention_ops.attn_fwd_captured - a0,
                        attention_ops.attn_bwd_captured - a1,
                        env_ops.env_fwd_captured - e0,
                        env_ops.env_bwd_captured - e1)


def count_replay(launches: Tuple[int, ...]) -> None:
    """One replay of a graph ran the ``launches`` that
    :func:`capture_graph` counted while recording it."""
    fwd, bwd, reduction, attn_fwd, attn_bwd, env_fwd, env_bwd = launches
    dp_fused_ops.count_replay(fwd, bwd)
    force_ops.count_replay(reduction)
    attention_ops.count_replay(attn_fwd, attn_bwd)
    env_ops.count_replay(env_fwd, env_bwd)


class _CapturedSegment:
    """One segment captured as a CUDA graph over static carry buffers.

    The graph reads ``static`` (the carry's tensors), runs the segment, and
    writes the new carry back into ``static``, so replaying it n times runs
    n segments in a row. Its thermo lands in ``thermo``, tensors of the
    graph's memory pool that each replay overwrites.
    """

    def __init__(self, seg_fn: Callable, carry: OuterCarry, seg_len: int,
                 aux: Tuple[Any, ...], pool=None):
        self.aux = aux
        self.static = snapshot(carry).carry
        # the warm-up: one step of the segment on copies
        warm = snapshot(carry).carry

        def record():
            out, th = seg_fn(self.static, seg_len, *aux)
            self._write_back(out)
            return th

        self.graph, self.thermo, self.launches = capture_graph(
            record, lambda: seg_fn(warm, 1, *aux), generators_of(carry),
            pool)

    def _write_back(self, out: OuterCarry) -> None:
        src, dst = [], []
        _map_state(src.append, lambda g: g, out)
        _map_state(dst.append, lambda g: g, self.static)
        for s, d in zip(src, dst):
            d.copy_(s)

    def load(self, carry: OuterCarry) -> None:
        """Copy ``carry`` into the static buffers (no-op if it is them)."""
        if carry.pos is not self.static.pos:
            self._write_back(carry)

    def replay(self) -> Dict[str, torch.Tensor]:
        self.graph.replay()
        count_replay(self.launches)
        return {k: v.clone() for k, v in self.thermo.items()}


class OuterEngine:
    """Whole-trajectory MD over rebuild segments.

    ``seg_fn(carry, seg_len, *aux) -> (carry, seg_out)`` runs ONE segment
    (neighbor rebuild at current positions + ``seg_len`` steps).
    :meth:`run` runs ``n_segments`` of them and returns their thermo stacked
    with leading ``(n_segments, seg_len)`` dims. On a CUDA carry the segment
    is captured as a CUDA graph once per ``seg_len`` (this engine is built
    per sel and grid) and replayed; a failed capture raises. On a CPU carry
    the segment runs eagerly.
    """

    def __init__(self, seg_fn: Callable):
        self._seg_fn = seg_fn
        self._graphs: Dict[int, _CapturedSegment] = {}
        self.captures = 0
        self.replays = 0
        self.capture_ns = 0     # the outer.capture spans' time

    def run(self, carry: OuterCarry, n_segments: int, seg_len: int,
            *aux: Any):
        outs = []
        with torch.no_grad():
            if carry.pos.device.type != "cuda":
                for _ in range(n_segments):
                    carry, th = self._seg_fn(carry, seg_len, *aux)
                    outs.append(th)
            else:
                seg = self._graphs.get(seg_len)
                if seg is not None and not _same_inputs(seg.aux, aux):
                    raise ValueError("the captured segment was recorded for "
                                     "other params/types/masses/dt")
                if seg is None:
                    with obs.timed("outer.capture", steps=seg_len) as cap:
                        # segments of one engine share one memory pool
                        pool = next((g.graph.pool()
                                     for g in self._graphs.values()), None)
                        seg = _CapturedSegment(self._seg_fn, carry, seg_len,
                                               aux, pool)
                    self._graphs[seg_len] = seg
                    self.captures += 1
                    self.capture_ns += cap.ns
                seg.load(carry)
                for _ in range(n_segments):
                    with obs.span("outer.replay"):
                        outs.append(seg.replay())
                    self.replays += 1
                carry = seg.static
        return carry, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def md_outer_engine(potential: api.Potential, ensemble: api.Ensemble,
                    spec: neighbors.NeighborSpec,
                    grid_key: Tuple[int, ...],
                    barostat: Optional[api.Barostat] = None) -> OuterEngine:
    """Outer engine for the single-process driver.

    Each segment rebuilds the neighbor list on the device at the
    segment-start positions AND box from the carry (the cell grid of
    ``grid_key`` cell counts, with cell sizes from the carried box) and then
    runs ``seg_len`` MD steps against it (``potential.sel`` ==
    ``spec.sel``). Overflow cannot branch inside a captured segment: it
    accumulates in the carry for :meth:`Capacities.regrow`.
    """
    nbr_fn = _dyn_cell_list_fn(spec, grid_key)
    md_step = make_md_step(potential, ensemble, barostat)

    def outer_seg(carry: OuterCarry, seg_len: int, params, typ, masses, dt):
        nlist, ovf = nbr_fn(carry.pos, typ, carry.box)
        inner = MDCarry(carry.pos, carry.vel, carry.force, carry.ens,
                        carry.box, carry.baro)
        inner, th = run_steps(md_step, inner, seg_len,
                              params, nlist, typ, masses, dt)
        return OuterCarry(inner.pos, inner.vel, inner.force,
                          torch.maximum(carry.overflow, ovf), inner.ens,
                          inner.box, inner.baro), th

    return OuterEngine(outer_seg)


def vv_outer_engine(cfg_run: DPConfig, impl: Optional[str],
                    nsel_norm: Optional[int], spec: neighbors.NeighborSpec,
                    box_key: Tuple[float, ...]) -> OuterEngine:
    """Legacy DP + NVE outer engine (shim over :func:`md_outer_engine`), its
    cell grid that of the box ``box_key``."""
    return md_outer_engine(api.DPPotential(cfg_run, impl, nsel_norm),
                           api.NVE(), spec,
                           grid_key_for(spec, np.asarray(box_key, float)))


def chunk_schedule(steps: int, rebuild_every: int,
                   chunk_segments: int) -> List[Tuple[int, int]]:
    """Group the segment schedule into outer-engine runs.

    Returns ``[(n_segments, seg_len), ...]``: full ``rebuild_every``-length
    segments grouped ``chunk_segments`` at a time, then the trailing partial
    segment (if any) as its own ``(1, remainder)`` run. One host sync per
    entry.
    """
    if chunk_segments <= 0:
        raise ValueError(f"chunk_segments={chunk_segments}")
    if steps < 0 or rebuild_every <= 0:
        raise ValueError(f"bad schedule: steps={steps} rebuild={rebuild_every}")
    full, rem = divmod(steps, rebuild_every)
    out: List[Tuple[int, int]] = []
    while full > 0:
        take = min(chunk_segments, full)
        out.append((take, rebuild_every))
        full -= take
    if rem:
        out.append((1, rem))
    return out


# ---------------------------------------------------------------- helpers

def box_lengths(box) -> np.ndarray:
    """Host-side (3,) orthorhombic edge lengths from a box spelling.

    Accepts a length-3 vector or a DIAGONAL (3, 3) matrix; anything else
    (triclinic cells, wrong sizes) raises instead of silently truncating.
    """
    a = np.asarray(box, np.float64).reshape(-1)
    if a.size == 9:
        m = a.reshape(3, 3)
        if np.any(m != np.diag(np.diag(m))):
            raise ValueError(f"non-orthorhombic box not supported: {m}")
        a = np.diag(m)
    if a.size != 3:
        raise ValueError(f"box must be (3,) edge lengths or a diagonal "
                         f"(3, 3) matrix, got shape {np.shape(box)}")
    return a


def pack_box(box, device: torch.device) -> torch.Tensor:
    """The (3,) float32 box carry entry from a host box spelling."""
    return torch.as_tensor(box_lengths(box), dtype=torch.float32,
                           device=device)


def thermo_rows(pe: np.ndarray, ke: np.ndarray, step_base: int, steps: int,
                thermo_every: int, n_atoms: int,
                press: Optional[np.ndarray] = None,
                vol: Optional[np.ndarray] = None) -> List[Dict[str, float]]:
    """Host-side selection of thermo rows from a segment's stacked PE/KE.

    Every ``thermo_every`` global steps plus the final step. Temperature
    follows from KE and 3N degrees of freedom; with the stacked pressure and
    volume each row gains ``press_gpa`` (GPa) and ``vol`` (A^3) columns.
    """
    rows = []
    ndof = 3.0 * max(n_atoms, 1)
    for i in range(len(pe)):
        gstep = step_base + i + 1
        if gstep % thermo_every == 0 or gstep == steps:
            row = {
                "step": gstep, "pe": float(pe[i]), "ke": float(ke[i]),
                "etot": float(pe[i]) + float(ke[i]),
                "temp": 2.0 * float(ke[i]) / (ndof * integrator.KB_EV),
            }
            if press is not None:
                row["press_gpa"] = float(press[i]) * integrator.EV_A3_TO_GPA
            if vol is not None:
                row["vol"] = float(vol[i])
            rows.append(row)
    return rows
