"""Single-process MD driver reproducing the paper's protocol (Sec. 4).

The run is described by a :class:`repro_torch.md.api.SimulationSpec` — a
``Potential``, an ``Ensemble``, an optional ``Barostat`` and the protocol
scalars — and executed by :func:`run_simulation` (what
``api.Simulation.run`` calls). The default protocol is the paper's:
Velocity-Verlet NVE, Maxwell-Boltzmann init at 330 K, neighbor list with a
2 A buffer rebuilt every 50 steps, thermo recorded every 50 steps; 99 steps
=> energy and forces evaluated 100 times.

Three stepping engines share this entry point, as in the reference:

  engine="outer"  the outer engine (``md/stepper.py`` ``OuterEngine``): the
                  neighbor rebuild runs on the device inside each segment,
                  and on the card each segment is a captured CUDA graph,
                  replayed. One host sync and overflow check per *chunk* of
                  segments, with a chunk replay from a snapshot on
                  capacity overflow.
  engine="scan"   (default) the segment engine: a step loop per rebuild
                  segment, thermo fetched once per segment, overflow checked
                  at segment boundaries (host rebuild) with escalation.
  engine="python" the per-step loop, kept as the trajectory reference.

The engines agree on the physics: within the skin buffer every pair inside
rcut is in both lists and pairs beyond rcut contribute exactly zero.

``run_md`` remains as a DEPRECATED thin shim over the spec API.

Each call is one ``md.call`` root of the span recorder (``repro_torch.obs``),
with ``model.first_force``, ``driver.loop`` and ``md.result`` inside it and
each engine's own spans inside the loop; ``wall_s`` is the loop span's
duration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.types import DPConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.md import api, integrator, lattice, neighbors, stepper


@dataclasses.dataclass
class MDResult:
    thermo: List[Dict[str, float]]
    final_pos: np.ndarray
    final_vel: np.ndarray
    wall_s: float                 # the stepping loop (the driver.loop span)
    steps: int
    n_atoms: int
    engine: str = "scan"
    escalations: int = 0          # neighbor capacity escalations taken
    host_syncs: int = 0           # device->host round-trips in the hot loop
    overflow_checks: int = 0      # neighbor-overflow flags inspected
    overflow_worst: int = 0       # worst flag seen (<= 0: slot slack left)
    final_box: Optional[np.ndarray] = None   # (3,) A — moves under a barostat
    stress: Optional[np.ndarray] = None      # (steps, 3, 3) eV/A^3 per-step
    grid_rebuilds: int = 0        # cell grids re-derived from a moved box
    sel: Tuple[int, ...] = ()     # neighbor slot layout at the end of the run
    graph_captures: int = 0       # outer engine on the card: CUDA graphs
    graph_replays: int = 0        # captured, and replays of them
    capture_s: float = 0.0        # part of wall_s spent warming up + capturing
    section_slots: int = 0        # a potential's own section at the end (0:
    #                               none), escalations of it in escalations

    @property
    def us_per_step_atom(self) -> float:
        return self.wall_s * 1e6 / (self.steps * self.n_atoms)

    def press_gpa_trace(self) -> np.ndarray:
        """Per-recorded-row instantaneous pressure (GPa) convenience."""
        return np.asarray([row.get("press_gpa", np.nan)
                           for row in self.thermo])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """The final state's copies to the host."""
    with obs.span("md.result"):
        return [t.cpu().numpy() for t in tensors]


def run_md(cfg: Optional[DPConfig], params: Any, pos: np.ndarray,
           typ: np.ndarray, box: np.ndarray, *, steps: int = 99,
           dt_fs: float = 1.0, temp_k: float = 330.0, rebuild_every: int = 50,
           thermo_every: int = 50, skin: float = 2.0,
           impl: Optional[str] = None, seed: int = 0,
           engine: str = "scan", chunk_segments: int = 8,
           escalation: Optional[stepper.EscalationPolicy] = None,
           potential: Optional[api.Potential] = None,
           ensemble: Optional[api.Ensemble] = None,
           barostat: Optional[api.Barostat] = None,
           device: DeviceLike = "cuda") -> MDResult:
    """DEPRECATED kwarg-pile entry point; thin shim over the spec API.

    Build an :class:`api.SimulationSpec` and call ``api.Simulation.run``
    instead. The shim constructs exactly that spec (a ``DPPotential``
    pinned to ``cfg.nsel`` + NVE unless ``potential``/``ensemble``
    override), so trajectories are bit-identical between the two entry
    points on the CPU.
    """
    spec = api.SimulationSpec(
        potential=potential or api.DPPotential(cfg, impl=impl,
                                               nsel_norm=cfg.nsel),
        ensemble=ensemble or api.NVE(),
        steps=steps, dt_fs=dt_fs, temp_k=temp_k,
        rebuild_every=rebuild_every, thermo_every=thermo_every, skin=skin,
        seed=seed, engine=engine, chunk_segments=chunk_segments,
        escalation=escalation, barostat=barostat)
    return run_simulation(spec, params, pos, typ, box, device=device)


def run_simulation(spec: api.SimulationSpec, params: Any, pos: np.ndarray,
                   typ: np.ndarray, box: np.ndarray,
                   device: DeviceLike = "cuda") -> MDResult:
    """Run ``spec`` on ``(params, pos, typ, box)`` — the one MD entry point.

    ``params`` must already live on ``device`` (see ``bridge`` and
    ``init_dp_params``). ``wall_s`` covers the stepping loop, rebuilds
    included, and ends after the device has finished.
    """
    if spec.engine not in ("outer", "scan", "python"):
        raise ValueError(f"unknown engine {spec.engine!r}")
    with obs.root("md.call", engine=spec.engine, steps=spec.steps,
                  atoms=len(pos)):
        return _simulate(spec, params, pos, typ, box, resolve_device(device))


def _simulate(spec: api.SimulationSpec, params: Any, pos: np.ndarray,
              typ: np.ndarray, box: np.ndarray,
              dev: torch.device) -> MDResult:
    pot, ens_obj, baro = spec.potential, spec.ensemble, spec.barostat
    n = len(pos)
    masses = torch.as_tensor(lattice.masses_for(pot.type_map, np.asarray(typ)),
                             dtype=torch.float32, device=dev)
    nspec = neighbors.NeighborSpec(rcut_nbr=pot.rcut + spec.skin,
                                   sel=pot.sel)
    box_np = stepper.box_lengths(box)

    pos = torch.as_tensor(np.asarray(pos), dtype=torch.float32, device=dev)
    typ = torch.as_tensor(np.asarray(typ), dtype=torch.int64, device=dev)
    boxt = stepper.pack_box(box_np, dev)   # the dynamic box: rides in the carry
    gen = torch.Generator().manual_seed(spec.seed)
    vel = torch.as_tensor(integrator.init_velocities(gen, masses, spec.temp_k),
                          dtype=torch.float32, device=dev)
    ens = ens_obj.init_state(dev)
    baro_state = baro.init_state(dev) if baro is not None else ()

    if spec.engine == "python":
        return _run_md_python(pot, ens_obj, params, pos, vel, typ, boxt,
                              box_np, masses, nspec, ens, baro_state, dev,
                              steps=spec.steps, dt_fs=spec.dt_fs,
                              rebuild_every=spec.rebuild_every,
                              thermo_every=spec.thermo_every, barostat=baro)

    # ------------------------------------------ device paths (scan / outer)
    policy = spec.escalation or stepper.EscalationPolicy()
    build = stepper.build_neighbors_escalating(
        pot.layout_cfg(), nspec, box_np, pos, typ, spec.escalation)
    pot, grown = stepper.fit_section(pot, build.nlist, pos, boxt, policy)
    build = build._replace(escalations=build.escalations + grown)
    pot_run = pot.with_layout(build.spec.sel)
    with obs.span("model.first_force"):
        _, f, _ = pot_run.energy_forces(params, pos, typ, build.nlist,
                                        box=boxt)
        _sync(dev)

    if spec.engine == "outer":
        carry = stepper.OuterCarry(
            pos, vel, f, torch.zeros((), dtype=torch.int32, device=dev), ens,
            boxt, baro_state)
        return _run_md_outer(pot, ens_obj, params, carry, typ, box_np, masses,
                             build, dev, steps=spec.steps, dt_fs=spec.dt_fs,
                             rebuild_every=spec.rebuild_every,
                             thermo_every=spec.thermo_every,
                             chunk_segments=spec.chunk_segments,
                             escalation=spec.escalation, barostat=baro)

    eng = stepper.md_segment_engine(pot_run, ens_obj, baro)
    carry = stepper.MDCarry(pos, vel, f, ens, boxt, baro_state)
    # a potential with a section of its own reports its excess in the
    # thermo: the segment then runs again, from its start, with the
    # section grown
    sectioned = hasattr(pot, "section_count")

    thermo: List[Dict[str, float]] = []
    stress_segs: List[np.ndarray] = []
    escalations = build.escalations
    overflow_checks = build.escalations + 1
    overflow_worst = build.overflow
    host_syncs = 1                      # initial build's overflow check
    grid_rebuilds = 0
    grid_key = stepper.grid_key_for(nspec, box_np)
    ref_box_escal = box_np      # box the last volume fold was taken against
    with obs.timed("driver.loop") as loop:
        step_base = 0
        for seg_len in stepper.segment_schedule(spec.steps,
                                                spec.rebuild_every):
            if step_base > 0:
                # segment boundary: rebuild at the current positions and
                # the current (carried) box; the overflow check +
                # escalation retry lives inside. With no barostat the box
                # never moves, so it is not fetched.
                if baro is not None:
                    box_now = carry.box.cpu().numpy().astype(float)
                    host_syncs += 1
                    key_now = stepper.grid_key_for(build.spec, box_now)
                    if key_now != grid_key:
                        grid_key = key_now
                        grid_rebuilds += 1
                else:
                    box_now = box_np
                build = stepper.build_neighbors_escalating(
                    pot.layout_cfg(), build.spec, box_now, carry.pos, typ,
                    spec.escalation,
                    ref_box=ref_box_escal if baro is not None else None)
                host_syncs += 1
                overflow_checks += build.escalations + 1
                overflow_worst = max(overflow_worst, build.overflow)
                if build.escalations:
                    escalations += build.escalations
                    ref_box_escal = box_now
                pot, grown = stepper.fit_section(pot, build.nlist, carry.pos,
                                                 carry.box, policy)
                escalations += grown
                if build.escalations or grown:
                    pot_run = pot.with_layout(build.spec.sel)
                    eng = stepper.md_segment_engine(pot_run, ens_obj, baro)
            for attempt in range(policy.max_attempts + 1):
                snap = stepper.snapshot(carry) if sectioned else None
                with obs.span("driver.segment", steps=seg_len):
                    carry, th = eng.run(carry, seg_len, params, build.nlist,
                                        typ, masses, spec.dt_fs)
                # ONE device->host sync per segment fetches the stacked
                # thermo
                with obs.span("driver.fetch"):
                    th = stepper.fetch_thermo(th)
                excess = stepper.section_excess(th)
                if excess <= 0:
                    break
                if attempt == policy.max_attempts:
                    raise RuntimeError(
                        f"the model's section overflows after "
                        f"{policy.max_attempts} segment replays "
                        f"({pot.slots} slots)")
                host_syncs += 1
                pot = stepper.grow_section(pot, policy, excess, "segment")
                escalations += 1
                pot_run = pot.with_layout(build.spec.sel)
                eng = stepper.md_segment_engine(pot_run, ens_obj, baro)
                carry = stepper.restore(snap)
            thermo.extend(stepper.thermo_rows(
                th["pe"], th["ke"], step_base, spec.steps, spec.thermo_every,
                n, press=th["press"], vol=th["vol"]))
            stress_segs.append(th["stress"])
            host_syncs += 1
            step_base += seg_len
        _sync(dev)
    final_pos, final_vel, final_box = _to_host(carry.pos, carry.vel, carry.box)
    return MDResult(thermo=thermo, final_pos=final_pos,
                    final_vel=final_vel, wall_s=loop.seconds,
                    steps=spec.steps, n_atoms=n, engine="scan",
                    escalations=escalations, host_syncs=host_syncs,
                    overflow_checks=overflow_checks,
                    overflow_worst=overflow_worst,
                    final_box=final_box,
                    stress=(np.concatenate(stress_segs)
                            if stress_segs else None),
                    grid_rebuilds=grid_rebuilds, sel=tuple(build.spec.sel),
                    section_slots=getattr(pot, "slots", 0))


def _run_md_outer(pot: api.Potential, ens_obj: api.Ensemble, params,
                  carry: stepper.OuterCarry, typ, box_np, masses,
                  build: stepper.NeighborBuild, dev: torch.device, *, steps,
                  dt_fs, rebuild_every, thermo_every, chunk_segments,
                  escalation, barostat: Optional[api.Barostat] = None):
    """Chunks of segments with the rebuild on the device.

    The host touches the device once per chunk: the accumulated overflow
    flag and the carried box ride in the same fetch as the chunk's stacked
    thermo. On overflow the rebuilt list truncated inside the chunk, so the
    whole chunk is REPLAYED from its entry snapshot with escalated
    capacities (by the carried box's volume ratio too). A ``GRID_INVALID``
    flag instead means a barostat moved the box past its static cell grid:
    the replay re-derives the grid from the box. The snapshot holds the
    ensemble's and barostat's generator states, so a replayed chunk draws
    the same noise. A potential with a section of its own reports its excess
    in the chunk's thermo: the chunk is replayed with the section grown.
    """
    policy = escalation or stepper.EscalationPolicy()
    n = carry.pos.shape[0]
    box_np = np.asarray(box_np, float)
    grid_key = stepper.grid_key_for(build.spec, box_np)
    ref_box_escal = box_np      # box the last volume fold was taken against
    spec_n = build.spec
    engines: Dict[Tuple[Any, ...], stepper.OuterEngine] = {}

    thermo: List[Dict[str, float]] = []
    stress_chunks: List[np.ndarray] = []
    escalations = build.escalations
    grid_rebuilds = 0
    host_syncs = 1                      # initial build's overflow check
    overflow_checks = build.escalations + 1
    overflow_worst = build.overflow
    with obs.timed("driver.loop") as loop:
        step_base = 0
        for n_segs, seg_len in stepper.chunk_schedule(steps, rebuild_every,
                                                      chunk_segments):
            for attempt in range(policy.max_attempts + 1):
                with obs.span("outer.chunk", attempt=attempt, segments=n_segs):
                    key = (spec_n, grid_key, pot)
                    if key not in engines:
                        engines[key] = stepper.md_outer_engine(
                            pot.with_layout(spec_n.sel), ens_obj, spec_n,
                            grid_key, barostat)
                    snap = stepper.snapshot(carry)   # for a replay
                    out, th = engines[key].run(carry, n_segs, seg_len,
                                               params, typ, masses, dt_fs)
                    # THE host sync of this chunk: thermo, flag and box
                    th["overflow"] = out.overflow.reshape(1).expand(n_segs)
                    th["box"] = out.box.reshape(1, 3).expand(n_segs, 3)
                    with obs.span("outer.fetch"):
                        host = stepper.fetch_thermo(th)
                ovf = int(host["overflow"][0])
                box_out = host["box"][0].astype(float)
                host_syncs += 1
                overflow_checks += 1
                if ovf >= int(neighbors.GRID_INVALID):
                    # geometry, not capacity: the carried box outgrew the
                    # static cell grid mid-chunk. Re-derive from the
                    # post-chunk box (coarser counts from a smaller box keep
                    # every cell >= rcut for the chunk's larger early boxes
                    # too); a box that dipped and recovered reproduces the
                    # old key, so coarsen by one.
                    key_new = stepper.grid_key_for(spec_n, box_out)
                    if key_new == grid_key:
                        key_new = tuple(max(1, k - 1) for k in grid_key)
                    grid_key = key_new
                    grid_rebuilds += 1
                else:
                    overflow_worst = max(overflow_worst, ovf)
                    excess = stepper.section_excess(host)
                    if ovf <= 0 and excess <= 0:
                        carry = out
                        break
                    if ovf > 0:
                        # fold the carried-box volume ratio into the growth,
                        # then advance the reference box: a later retry
                        # folds only ADDITIONAL shrink. The in-graph
                        # rebuilds' flag is merged, so the cause is
                        # unknown and both capacities grow.
                        vol_scale = policy.volume_scale(ref_box_escal,
                                                        box_out)
                        ref_box_escal = box_out
                        spec_n, _ = policy.escalate(spec_n, None, vol_scale)
                        escalations += 1
                    if excess > 0:
                        pot = stepper.grow_section(pot, policy, excess,
                                                   "chunk")
                        escalations += 1
                with obs.span("outer.restore"):
                    carry = stepper.restore(snap)
            else:
                raise RuntimeError(
                    f"neighbor capacity overflow persists after "
                    f"{policy.max_attempts} chunk replays (last spec: "
                    f"sel={spec_n.sel}, cell_capacity={spec_n.cell_capacity})")
            # thermo for the whole chunk arrives stacked (n_segs, seg_len)
            thermo.extend(stepper.thermo_rows(
                host["pe"].reshape(-1), host["ke"].reshape(-1), step_base,
                steps, thermo_every, n, press=host["press"].reshape(-1),
                vol=host["vol"].reshape(-1)))
            stress_chunks.append(host["stress"].reshape(-1, 3, 3))
            step_base += n_segs * seg_len
        _sync(dev)
    final_pos, final_vel, final_box = _to_host(carry.pos, carry.vel, carry.box)
    return MDResult(thermo=thermo, final_pos=final_pos,
                    final_vel=final_vel, wall_s=loop.seconds,
                    steps=steps, n_atoms=n, engine="outer",
                    escalations=escalations, host_syncs=host_syncs,
                    overflow_checks=overflow_checks,
                    overflow_worst=overflow_worst,
                    final_box=final_box,
                    stress=(np.concatenate(stress_chunks)
                            if stress_chunks else None),
                    grid_rebuilds=grid_rebuilds, sel=tuple(spec_n.sel),
                    graph_captures=sum(e.captures for e in engines.values()),
                    graph_replays=sum(e.replays for e in engines.values()),
                    capture_s=sum(e.capture_ns
                                  for e in engines.values()) * 1e-9,
                    section_slots=getattr(pot, "slots", 0))


def _run_md_python(pot: api.Potential, ens_obj: api.Ensemble, params, pos,
                   vel, typ, boxt, box_np, masses, nspec, ens, baro,
                   dev: torch.device, *, steps, dt_fs, rebuild_every,
                   thermo_every, barostat: Optional[api.Barostat] = None):
    """The per-step loop (trajectory reference / baseline).

    The rebuild's overflow flags stay on the device and are checked once
    after the run; ``host_syncs`` counts the real round-trips (initial
    build + each thermo row's fetch + each barostat box fetch + the
    deferred check), as the reference counts them. Under a barostat the
    neighbor search takes the carried box, and the grid is re-derived from
    the host copy when the cell counts change.
    """
    grid_key = stepper.grid_key_for(nspec, box_np)
    nbr_fn = stepper._dyn_cell_list_fn(nspec, grid_key)

    with torch.no_grad():
        nlist, ovf = nbr_fn(pos, typ, boxt)
    host_syncs = 1
    overflow_worst = int(ovf)
    if overflow_worst > 0:
        raise RuntimeError(f"neighbor overflow {overflow_worst} at init")
    with obs.span("model.first_force"):
        e, f, stats = pot.energy_forces(params, pos, typ, nlist, box=boxt)
        _sync(dev)

    thermo: List[Dict[str, float]] = []
    stress_steps = []
    # a potential's own section is checked with the lists' flags, after
    # the run (this loop has no replay)
    ovf_flags = [stats[api.MODEL_EXCESS]] if api.MODEL_EXCESS in stats \
        else []
    grid_rebuilds = 0
    with obs.timed("driver.loop") as loop, torch.no_grad():
        for step in range(steps):
            vel = ens_obj.half_kick(vel, f, masses, dt_fs)
            pos = ens_obj.drift(pos, vel, dt_fs, boxt)
            if (step + 1) % rebuild_every == 0:
                if barostat is not None:
                    # the grid follows the barostat-moved box (a fixed box
                    # is never fetched)
                    box_host = boxt.cpu().numpy().astype(float)
                    host_syncs += 1
                    key_now = stepper.grid_key_for(nspec, box_host)
                    if key_now != grid_key:
                        grid_key = key_now
                        grid_rebuilds += 1
                        nbr_fn = stepper._dyn_cell_list_fn(nspec, key_now)
                nlist, ovf = nbr_fn(pos, typ, boxt)
                ovf_flags.append(ovf)       # device scalar; no sync here
            e, f_new, stats = pot.energy_forces(params, pos, typ, nlist,
                                                box=boxt)
            if api.MODEL_EXCESS in stats:
                ovf_flags.append(stats[api.MODEL_EXCESS])
            vel = ens_obj.half_kick(vel, f_new, masses, dt_fs)
            vel, ens = ens_obj.finalize(vel, masses, dt_fs, ens)
            f = f_new
            vol = integrator.volume_of(boxt)
            stress = integrator.stress_tensor(
                integrator.kinetic_tensor(vel, masses), stats["virial"], vol)
            stress_steps.append(stress)     # device value; no sync here
            # thermo snapshots PRE-barostat velocities/volume, the point in
            # the step the other engines record
            if (step + 1) % thermo_every == 0 or step == steps - 1:
                ke = integrator.kinetic_energy(vel, masses)
                row = torch.stack([
                    e, ke, integrator.temperature(vel, masses),
                    integrator.pressure_of(stress), vol]).cpu().tolist()
                host_syncs += 1             # the thermo fetch
                thermo.append({
                    "step": step + 1, "pe": row[0], "ke": row[1],
                    "etot": row[0] + row[1], "temp": row[2],
                    "press_gpa": row[3] * integrator.EV_A3_TO_GPA,
                    "vol": row[4]})
            if barostat is not None:
                boxt, pos, vel, baro = barostat.apply(boxt, pos, vel, stress,
                                                      baro, dt_fs)
        _sync(dev)
    if ovf_flags:
        # ONE deferred fetch inspects every rebuild's flag after the run
        worst = int(torch.stack(ovf_flags).max())
        host_syncs += 1
        overflow_worst = max(overflow_worst, worst)
        if worst > 0:
            raise RuntimeError(f"neighbor overflow {worst} during run")
    stress = [torch.stack(stress_steps)] if stress_steps else []
    final_pos, final_vel, final_box, *stress = _to_host(pos, vel, boxt,
                                                        *stress)
    return MDResult(thermo=thermo, final_pos=final_pos,
                    final_vel=final_vel, wall_s=loop.seconds, steps=steps,
                    n_atoms=pos.shape[0], engine="python",
                    host_syncs=host_syncs,
                    overflow_checks=len(ovf_flags) + 1,
                    overflow_worst=overflow_worst,
                    final_box=final_box,
                    stress=stress[0] if stress else None,
                    grid_rebuilds=grid_rebuilds, sel=tuple(nspec.sel))
