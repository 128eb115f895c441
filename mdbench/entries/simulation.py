"""The single-card entry: ``repro_torch.md.api.Simulation(spec).run``.

That is ``md/driver.run_simulation`` -> ``md/stepper`` (the scan or the
outer engine) -> ``md/neighbors`` -> ``core/dp_model`` ->
``kernels/dp_fused``. Set-up builds the potential and has the port derive
its Chebyshev table from the benchmark's raw weights; each call is one
user's run of the traffic's protocol, from the system's positions with
velocities from the call's seed. Thermo is kept for every step (a choice
on the host: the engines fetch every step's energies anyway).
"""

from __future__ import annotations

import numpy as np
import torch

from mdbench import manifest
from mdbench.record import CallRecord


class Entry:
    def __init__(self, run):
        from repro_torch.core.types import DPConfig
        from repro_torch.md import api

        self._api = api
        self.run = run
        cfg = manifest.config_for(DPConfig, run.cell.config)
        self.cfg = cfg
        self.potential = api.make_potential("dp", cfg, impl=cfg.impl)
        self.params = self.potential.prepare_params(run.weights)

    def spec(self, seed: int, steps: int):
        tr = self.run.cell.traffic
        return self._api.SimulationSpec(
            potential=self.potential, ensemble=tr["ensemble"], steps=steps,
            dt_fs=float(tr["dt_fs"]), temp_k=float(tr["temp_k"]),
            rebuild_every=int(tr["rebuild_every"]), thermo_every=1,
            skin=float(tr["skin"]), seed=int(seed), engine=tr["engine"],
            chunk_segments=int(tr["chunk_segments"]))

    def call(self, seed: int, steps: int):
        r = self.run
        res = self._api.Simulation(self.spec(seed, steps)).run(
            self.params, r.pos0, r.typ, r.box, device=r.device)
        return CallRecord(
            seed=seed,
            pe=np.asarray([row["pe"] for row in res.thermo], np.float64),
            ke=np.asarray([row["ke"] for row in res.thermo], np.float64),
            pos=res.final_pos, vel=res.final_vel, sel=tuple(res.sel),
            wall_s=res.wall_s, capture_s=res.capture_s,
            graph_captures=res.graph_captures,
            graph_replays=res.graph_replays, escalations=res.escalations,
            host_syncs=res.host_syncs)

    def force_eval(self, rec):
        """One eager energy-and-forces evaluation at ``rec``'s final
        positions, at its escalated slot layout, as a closure."""
        import dataclasses

        from repro_torch.core import dp_model
        from repro_torch.md import neighbors, stepper

        r = self.run
        pos = torch.as_tensor(rec.pos, dtype=torch.float32, device=r.device)
        typ = torch.as_tensor(r.typ, dtype=torch.int64, device=r.device)
        nspec = neighbors.NeighborSpec(
            rcut_nbr=self.cfg.rcut + float(r.cell.traffic["skin"]),
            sel=self.cfg.sel)
        build = stepper.build_neighbors_escalating(self.cfg, nspec, r.box,
                                                   pos, typ)
        if tuple(build.spec.sel) != tuple(rec.sel):
            nspec = dataclasses.replace(build.spec, sel=tuple(rec.sel))
            build = stepper.build_neighbors_escalating(self.cfg, nspec,
                                                       r.box, pos, typ)
        box_t = stepper.pack_box(r.box, r.device)
        cfg_run = build.cfg_run

        def evaluate():
            return dp_model.dp_energy_forces(
                self.params, cfg_run, pos, build.nlist, typ, box_t,
                impl=self.cfg.impl, nsel_norm=self.cfg.nsel)

        return evaluate

    def release(self) -> None:
        self.params = None
        self.potential = None
