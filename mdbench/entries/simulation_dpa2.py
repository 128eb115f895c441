"""The single-card entry with a DPA-2 model: ``md/api.Simulation(spec).run``
with ``md/api.make_potential("dpa2", cfg)``.

That is ``md/driver.run_simulation`` -> ``md/stepper`` -> ``md/neighbors``
(the pairs within rcut + skin in type sections) -> ``core/dpa2`` (both model
sections compacted from that list every step, repinit, the repformer layers
gathering their neighbours' g1) ->
``kernels/dp_fused/force.prod_force_virial``. The calls are the simulation
entry's; each keeps both model sections' slots at its end
(``CallRecord.section_slots``). :meth:`force_eval` and
:meth:`repformer_eval` give the per-layer readers one eager evaluation of
the whole model and of its repformer layers at a call's final layout.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mdbench import manifest
from mdbench.record import CallRecord

Simulation = manifest.entry_class("simulation",
                                  Path(__file__).resolve().parents[1])


class Entry(Simulation):
    def __init__(self, run):
        from repro_torch.core.types import DPA2Config
        from repro_torch.md import api

        self._api = api
        self.run = run
        self.cfg = manifest.config_for(DPA2Config, run.cell.config)
        self.potential = api.make_potential("dpa2", self.cfg)
        self.params = run.weights

    def call(self, seed: int, steps: int) -> CallRecord:
        r = self.run
        res = self._api.Simulation(self.spec(seed, steps)).run(
            self.params, r.pos0, r.typ, r.box, device=r.device)
        rec = CallRecord(
            seed=seed,
            pe=np.asarray([row["pe"] for row in res.thermo], np.float64),
            ke=np.asarray([row["ke"] for row in res.thermo], np.float64),
            pos=res.final_pos, vel=res.final_vel, sel=tuple(res.sel),
            wall_s=res.wall_s, capture_s=res.capture_s,
            graph_captures=res.graph_captures,
            graph_replays=res.graph_replays, escalations=res.escalations,
            host_syncs=res.host_syncs)
        rec.section_slots = tuple(res.section_slots)
        return rec

    def _layout(self, rec):
        """(potential, pos, typ, the list, box) at ``rec``'s final
        positions, at its escalated list and sections."""
        import dataclasses

        from repro_torch.md import neighbors, stepper

        r = self.run
        pos = torch.as_tensor(rec.pos, dtype=torch.float32, device=r.device)
        typ = torch.as_tensor(r.typ, dtype=torch.int64, device=r.device)
        nspec = neighbors.NeighborSpec(
            rcut_nbr=self.cfg.rcut + float(r.cell.traffic["skin"]),
            sel=tuple(rec.sel))
        pot = self.potential.with_layout(rec.sel).with_capacities(
            rec.section_slots)
        build = stepper.build_neighbors_escalating(pot.layout_cfg(), nspec,
                                                   r.box, pos, typ)
        if tuple(build.spec.sel) != tuple(rec.sel):
            nspec = dataclasses.replace(build.spec, sel=tuple(rec.sel))
            build = stepper.build_neighbors_escalating(
                pot.layout_cfg(), nspec, r.box, pos, typ)
        return pot, pos, typ, build.nlist, stepper.pack_box(r.box, r.device)

    def force_eval(self, rec):
        """One eager energy-and-forces evaluation (the port's ``dpa2.force``
        span: both compactions, the model and the reduction) at ``rec``'s
        final layout, as a closure."""
        pot, pos, typ, nlist, box = self._layout(rec)

        def evaluate():
            return pot.energy_forces(self.params, pos, typ, nlist, box=box)

        return evaluate

    def repformer_eval(self, rec):
        """The repformer layers alone (the port's ``dpa2.repformer`` span),
        forward and the backward that the forces take (to the first g1 and
        to the second section's pair vectors), on the g1 and the sections
        of ``rec``'s final layout, as a closure."""
        from repro_torch.core import dp_model, dpa2

        pot, pos, typ, nlist, box = self._layout(rec)
        cfg = self.cfg
        mixed, sub, _, _ = dpa2.compact(pos, nlist, box, cfg, pot.slots)
        with torch.no_grad():
            rij, nmask = dp_model.gather_rij(pos, mixed, box)
            g1 = dpa2.repinit(self.params, cfg, rij, nmask, typ,
                              typ[torch.clamp(mixed, min=0)],
                              dpa2.type_embedding(self.params))
            rij2, mask, nbr = dpa2.sub_section(rij, mixed, sub)
        seed = torch.Generator(device=pos.device).manual_seed(0)
        grad = torch.randn(g1.shape, generator=seed, device=pos.device)
        inputs = [x.detach().requires_grad_(True) for x in (g1, rij2)]

        def evaluate():
            with torch.enable_grad():
                out = dpa2.repformer(self.params, cfg, inputs[0], inputs[1],
                                     mask, nbr)
                return torch.autograd.grad(out, inputs, grad)

        return evaluate
