"""The multi-card entry: the paper's deployment, one process and one card a
rank, ``md/domain.OuterMDProgram.run`` under ``md/comm.DistComm`` on NCCL.

Each call builds the program the way ``launch/md_run.py`` does (bricks of
the traffic's ``topology`` in the ``atoms`` decomposition, the brick cell
list, capacities of 1.5 x a brick's share), partitions the system with the
call's starting velocities, primes the forces and runs the protocol in
chunks of segments, each segment captured once a call as a CUDA graph on
every process and replayed; a capacity overflow replays the chunk with
escalated capacities, as ``md_run`` does. The thermo is global (summed over
the bricks). Each call's final bricks stay on the host of their process
until the window has closed; :meth:`gather` then brings them to rank 0.
"""

from __future__ import annotations

import numpy as np
import torch

from mdbench import manifest
from mdbench.record import CallRecord


class Entry:
    def __init__(self, run):
        from repro_torch.core.types import DPConfig
        from repro_torch.md import api, comm as comm_mod, domain, lattice
        from repro_torch.md.topology import Topology

        self._domain = domain
        self.run = run
        tr = run.cell.traffic
        cfg = manifest.config_for(DPConfig, run.cell.config)
        self.cfg = cfg
        self.masses = tuple(lattice.MASS[t] for t in cfg.type_map)
        self.topo = Topology.parse(tr["topology"])
        self.comm = comm_mod.DistComm(self.topo.n_ranks, 1)
        self.potential = api.make_potential("dp", cfg, impl=cfg.impl)
        self.params = self.potential.prepare_params(run.weights)
        self.ensemble, self.barostat = api.resolve_ensemble(
            tr["ensemble"], temp_k=float(tr["temp_k"]))
        n = len(run.pos0)
        cap = int(n / self.topo.n_ranks * 1.5) + 8
        self.spec = domain.DomainSpec(
            box=tuple(float(b) for b in run.box), n_slabs=self.topo.n_ranks,
            atom_capacity=cap, halo_capacity=cap * 2 ** (self.topo.ndim - 1),
            rcut_halo=cfg.rcut + float(tr["skin"]),
            topology=self.topo.shape)
        self.spec.validate()
        #: rows of each brick's dp_fused launches: the atom capacity
        self.kernel_rows = cap
        self.finals = []            # each call's final bricks, on the host
        self.owned = 0              # atoms this card held at the last start

    def _program(self, spec):
        tr = self.run.cell.traffic
        return self._domain.make_outer_md_program(
            self.cfg, spec, self.comm, self.masses, float(tr["dt_fs"]),
            impl=self.cfg.impl, decomp="atoms", neighbor="cells",
            potential=self.potential, ensemble=self.ensemble,
            barostat=self.barostat)

    def call(self, seed: int, steps: int) -> CallRecord:
        import time

        from repro_torch.md import integrator, lattice, stepper

        domain, r = self._domain, self.run
        tr = r.cell.traffic
        dev = r.device
        masses = torch.as_tensor(
            lattice.masses_for(self.cfg.type_map, np.asarray(r.typ)),
            dtype=torch.float32)
        vel = integrator.init_velocities(torch.Generator().manual_seed(seed),
                                         masses, float(tr["temp_k"]))
        host, ovf = domain.partition_atoms(r.pos0, vel.numpy(), r.typ,
                                           self.spec)
        if ovf > 0:
            raise RuntimeError(f"brick capacity overflow {ovf}")
        policy = stepper.EscalationPolicy()
        spec_run = self.spec
        program = self._program(spec_run)
        programs = []
        boxd = stepper.pack_box(r.box, dev)
        params = self.params
        state = program.prime(params, domain.shard_state(host, self.comm, dev),
                              boxd)
        self.owned = int(state.mask.sum())
        ens = program.init_ensemble_state(dev)
        baro = program.init_barostat_state(dev)
        pe, ke = [], []
        escalations = host_syncs = 0
        t0 = time.perf_counter()
        for n_segs, seg_len in stepper.chunk_schedule(
                steps, int(tr["rebuild_every"]), int(tr["chunk_segments"])):
            for attempt in range(policy.max_attempts + 1):
                snap = stepper.snapshot((state, ens, boxd, baro))
                state, ens, boxd, baro, th = program.run(
                    state, params, n_segs, seg_len, ens, boxd, baro)
                thermo = stepper.fetch_thermo(th)
                host_syncs += 1
                try:
                    domain.check_segment_thermo(thermo)
                    break
                except RuntimeError as e:
                    if "geom_overflow" in str(e) \
                            or attempt == policy.max_attempts:
                        raise
                    state, ens, boxd, baro = stepper.restore(snap)
                    box_now = boxd.cpu().numpy().astype(float)
                    spec_run = domain.escalate_capacities(
                        spec_run, policy, box_now=box_now)
                    whole, r_ovf = domain.repartition_state(
                        domain.gather_state(state, self.comm), spec_run,
                        box_now=box_now)
                    if r_ovf > 0:
                        raise RuntimeError(f"repartition overflow {r_ovf}")
                    programs.append(program)
                    program = self._program(spec_run)
                    state = program.prime(
                        params, domain.shard_state(whole, self.comm, dev),
                        boxd)
                    escalations += 1
            pe.append(thermo["pe"].reshape(-1))
            ke.append(thermo["ke"].reshape(-1))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        programs.append(program)
        self.finals.append(domain.SlabState(
            *(None if x is None else x.detach().cpu() for x in state)))
        return CallRecord(
            seed=seed, pe=np.concatenate(pe).astype(np.float64),
            ke=np.concatenate(ke).astype(np.float64), pos=None, vel=None,
            sel=tuple(self.cfg.sel), wall_s=wall,
            capture_s=sum(p.capture_s for p in programs),
            graph_captures=sum(p.captures for p in programs),
            graph_replays=sum(p.replays for p in programs),
            escalations=escalations, host_syncs=host_syncs)

    def gather(self, calls) -> None:
        """After the window: every call's final atoms to rank 0 (positions
        and velocities in brick order), and each call's capture seconds as
        the slowest process's."""
        import torch.distributed as dist

        domain = self._domain
        for rec, final in zip(calls, self.finals[-len(calls):]):
            whole = domain.gather_state(final, self.comm)
            pos, vel, typ = domain.gather_atoms(whole)
            if self.comm.rank == 0:
                rec.pos, rec.vel, rec.typ = pos, vel, typ
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, rec.capture_s)
            rec.capture_s = max(every)
        self.finals = []

    def release(self) -> None:
        self.params = None
        self.potential = None
        self._domain.release_graphs()
