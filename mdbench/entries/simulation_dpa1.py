"""The single-card entry with a DPA-1 model: ``md/api.Simulation(spec).run``
with ``md/api.make_potential("dpa1", cfg)``.

That is ``md/driver.run_simulation`` -> ``md/stepper`` -> ``md/neighbors``
(the pairs within rcut + skin in type sections) -> ``core/dpa1`` (the pairs
within rcut compacted into the model's own section every step, the gated
attention) -> ``kernels/dp_fused/force.prod_force_virial``. The calls are
the simulation entry's; each keeps the model's section at its end
(``CallRecord.section_slots``). :meth:`force_eval` and
:meth:`attention_eval` give the per-layer readers one eager evaluation of
the whole model and of its attention layers at a call's final layout.
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
        from repro_torch.core.types import DPA1Config
        from repro_torch.md import api

        self._api = api
        self.run = run
        self.cfg = manifest.config_for(DPA1Config, run.cell.config)
        self.potential = api.make_potential("dpa1", self.cfg)
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
        rec.section_slots = res.section_slots
        return rec

    def _layout(self, rec):
        """(potential, pos, typ, the list, box) at ``rec``'s final
        positions, at its escalated list and section."""
        import dataclasses

        from repro_torch.md import neighbors, stepper

        r = self.run
        pos = torch.as_tensor(rec.pos, dtype=torch.float32, device=r.device)
        typ = torch.as_tensor(r.typ, dtype=torch.int64, device=r.device)
        nspec = neighbors.NeighborSpec(
            rcut_nbr=self.cfg.rcut + float(r.cell.traffic["skin"]),
            sel=tuple(rec.sel))
        pot = self.potential.with_layout(rec.sel).with_capacity(
            rec.section_slots)
        build = stepper.build_neighbors_escalating(pot.layout_cfg(), nspec,
                                                   r.box, pos, typ)
        if tuple(build.spec.sel) != tuple(rec.sel):
            nspec = dataclasses.replace(build.spec, sel=tuple(rec.sel))
            build = stepper.build_neighbors_escalating(
                pot.layout_cfg(), nspec, r.box, pos, typ)
        return pot, pos, typ, build.nlist, stepper.pack_box(r.box, r.device)

    def force_eval(self, rec):
        """One eager energy-and-forces evaluation (the port's ``dpa1.force``
        span: the compaction, the model and the reduction) at ``rec``'s
        final layout, as a closure."""
        pot, pos, typ, nlist, box = self._layout(rec)

        def evaluate():
            return pot.energy_forces(self.params, pos, typ, nlist, box=box)

        return evaluate

    def attention_eval(self, rec):
        """The attention layers alone (the port's ``dpa1.attention`` span),
        forward and the backward that the forces take (to G0, w_j w_k and
        the gate), on the G0 and the section of ``rec``'s final layout, as
        a closure."""
        from repro_torch.core import dp_model, dpa1

        pot, pos, typ, nlist, box = self._layout(rec)
        cfg = self.cfg
        mixed, _, _ = dpa1.compact(pos, nlist, box, cfg.rcut, pot.slots)
        with torch.no_grad():
            rij, nmask = dp_model.gather_rij(pos, mixed, box)
            g0, _, w, unit = dpa1.embedding(
                self.params, cfg, rij, nmask, typ,
                typ[torch.clamp(mixed, min=0)])
            ww, gate, pad = dpa1.attention_gates(w, unit, nmask)
        seed = torch.Generator(device=pos.device).manual_seed(0)
        grad = torch.randn(g0.shape, generator=seed, device=pos.device)
        inputs = [x.detach().requires_grad_(True) for x in (g0, ww, gate)]

        def evaluate():
            with torch.enable_grad():
                out = dpa1.attention(self.params, cfg, inputs[0], inputs[1],
                                     inputs[2], pad)
                return torch.autograd.grad(out, inputs, grad)

        return evaluate
