"""Distributed MD driver: the paper's protocol over bricks of the box — the
counterpart of ``repro.launch.md_run``, with its flags.

  # all ranks in this process (one thread each), here 4 bricks on the CPU
  PYTHONPATH=src python -m repro_torch.launch.md_run --device cpu \\
      --local-ranks 4 --nx 8 --steps 40 --rebuild-every 20
  # one process per rank (NCCL, one card each)
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.md_run \\
      --topology 2 --nx 8

The brick step (``md/domain.py``): staged per-axis halo sweeps, reverse force
sweeps and the model-axis split. ``--topology`` picks the brick shape
(``2x2x2`` = 8 bricks); ``--slabs k`` is the 1-D spelling ``(k,)``; by
default the ranks over ``--model-axis`` give a ``(k,)`` shape. Per
decomposed axis ``box[a]/shape[a] >= rcut_halo`` must hold. Ranks come from
``torchrun`` (one process each, ``DistComm``) or from ``--local-ranks R``
in this process (``LocalComm``). Two engines:

  --engine outer  (default) one pass over the ranks per chunk of segments:
                  migration at each segment's start, then the steps; one
                  host fetch (thermo + overflow flags) per chunk, and a
                  chunk replayed with escalated capacities on overflow. With
                  --local-ranks on the card a segment is captured once per
                  length as a CUDA graph and replayed (an escalation builds
                  a new program and captures again); the last line counts
                  the captures, replays and capture seconds.
  --engine scan   one pass per rebuild segment, migration between segments.

Fewer than 2 bricks degenerate to the single-process driver
(``md/driver.run_simulation``). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.core.types import DPConfig
from repro_torch.device import resolve_device
from repro_torch.md import api, comm as comm_mod, domain, integrator, lattice
from repro_torch.md import stepper
from repro_torch.md.topology import Topology


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=8, help="FCC cells along x")
    ap.add_argument("--nyz", type=int, default=3,
                    help="FCC cells along y/z (>=3: min-image needs box >= "
                         "2*rcut_halo)")
    ap.add_argument("--slabs", type=int, default=None,
                    help="spatial slabs (default: ranks / model_axis); 1-D "
                         "spelling of --topology k")
    ap.add_argument("--topology", default=None,
                    help="N-D brick shape, e.g. 2x2x2 or 2x4 (overrides "
                         "--slabs); per axis box[a]/shape[a] >= rcut_halo")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--steps", type=int, default=99)
    ap.add_argument("--dt", type=float, default=1.0)
    ap.add_argument("--temp", type=float, default=330.0)
    ap.add_argument("--rebuild-every", type=int, default=20)
    ap.add_argument("--engine", default="outer", choices=("outer", "scan"))
    ap.add_argument("--chunk-segments", type=int, default=8,
                    help="outer engine: rebuild segments per pass")
    ap.add_argument("--impl", default="mlp",
                    choices=("mlp", "quintic", "cheb", "cheb_pallas"))
    ap.add_argument("--potential", default="dp",
                    choices=api.POTENTIAL_CHOICES,
                    help="force model (lj needs no DP params at all)")
    ap.add_argument("--ensemble", default="nve",
                    choices=api.ENSEMBLE_CHOICES,
                    help="npt_* names pair a thermostat with a barostat")
    ap.add_argument("--friction", type=float, default=0.1,
                    help="nvt_langevin friction (1/fs)")
    ap.add_argument("--tau", type=float, default=100.0,
                    help="berendsen time constant (fs)")
    ap.add_argument("--pressure", type=float, default=None,
                    help="target pressure (GPa); with a non-NPT ensemble "
                         "this attaches a Berendsen barostat")
    ap.add_argument("--ptau", type=float, default=500.0,
                    help="barostat time constant (fs)")
    ap.add_argument("--local-ranks", type=int, default=1,
                    help="ranks run in this process, one thread each "
                         "(ignored under torchrun)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def _communicator(args, n_ranks: int, under_torchrun: bool, device):
    """(topology or None, comm or None) for ``n_ranks`` ranks."""
    if args.topology:
        topo = Topology.parse(args.topology)
    elif args.slabs:
        topo = Topology((args.slabs,)) if args.slabs >= 2 else None
    else:
        k = max(n_ranks // args.model_axis, 1)
        topo = Topology((k,)) if k >= 2 else None
    if topo is None:
        return None, None
    if topo.n_ranks * args.model_axis != n_ranks:
        raise SystemExit(f"topology {topo.label()} x model axis "
                         f"{args.model_axis} needs {topo.n_ranks * args.model_axis}"
                         f" ranks, have {n_ranks}")
    if under_torchrun:
        return topo, comm_mod.DistComm(topo.n_ranks, args.model_axis)
    return topo, comm_mod.LocalComm(topo.n_ranks, args.model_axis, device)


def main(argv=None):
    args = _parser().parse_args(argv)
    under_torchrun = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if under_torchrun:
        import torch.distributed as dist
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(
            backend="nccl" if args.device == "cuda" else "gloo",
            init_method="env://")
        n_ranks = dist.get_world_size()
    else:
        n_ranks = args.local_ranks
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    try:
        run(args, n_ranks, under_torchrun, dev)
    finally:
        if under_torchrun:
            import torch.distributed as dist
            dist.destroy_process_group()


def run(args, n_ranks: int, under_torchrun: bool, dev: torch.device) -> None:
    topo, comm = _communicator(args, n_ranks, under_torchrun, dev)
    lead = comm is None or not under_torchrun or comm.rank == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(96,),
                   type_map=("Cu",), embed_widths=(8, 16, 32), axis_neuron=4,
                   fit_widths=(32, 32, 32))
    ensemble, barostat = api.resolve_ensemble(
        args.ensemble, temp_k=args.temp, friction=args.friction,
        tau_fs=args.tau, pressure_gpa=args.pressure, ptau_fs=args.ptau)
    if args.potential == "lj":
        potential = api.LJPotential(sel=cfg.sel, rcut_lj=cfg.rcut)
        params = {}
    else:
        potential = api.make_potential(args.potential, cfg, impl=args.impl)
        params = potential.init_params(torch.Generator().manual_seed(0),
                                       device=dev)

    if comm is None:
        # no decomposition to exercise: the single-process driver (the brick
        # machinery assumes >= 2 bricks so ghost images never alias owners)
        from repro_torch.md import driver
        pos, typ, box = lattice.fcc_copper(args.nx, args.nyz, args.nyz)
        sim = api.SimulationSpec(
            potential=potential, ensemble=ensemble, steps=args.steps,
            dt_fs=args.dt, temp_k=args.temp, skin=0.5,
            rebuild_every=args.rebuild_every, thermo_every=33,
            barostat=barostat)
        res = driver.run_simulation(sim, params, pos, typ, box, device=dev)
        for row in res.thermo:
            print(f"step {row['step']:4d}  E_pot {row['pe']:+.4f}  "
                  f"E_tot {row['etot']:+.4f}  T {row['temp']:.0f} K")
        print(f"{res.us_per_step_atom:.2f} us/step/atom wall "
              f"(single process, {res.n_atoms} atoms)")
        return

    pos, typ, box = lattice.fcc_copper(args.nx, args.nyz, args.nyz)
    rng = np.random.default_rng(0)
    pos = np.mod(pos + rng.normal(0, 0.02, pos.shape), box)
    n = len(pos)
    cap = int(n / topo.n_ranks * 1.5) + 8
    # later sweeps pack owned atoms PLUS earlier sweeps' ghosts, so the
    # per-side send capacity grows with the decomposed rank
    spec = domain.DomainSpec(box=tuple(box), n_slabs=topo.n_ranks,
                             atom_capacity=cap - cap % args.model_axis,
                             halo_capacity=cap * (2 ** (topo.ndim - 1)),
                             rcut_halo=cfg.rcut + 0.5, topology=topo.shape)
    spec.validate()
    masses = torch.full((n,), lattice.MASS["Cu"], dtype=torch.float32)
    vel = integrator.init_velocities(torch.Generator().manual_seed(1), masses,
                                     args.temp)
    host, ovf = domain.partition_atoms(pos.astype(np.float32),
                                       vel.numpy().astype(np.float32), typ,
                                       spec)
    if ovf > 0:
        raise SystemExit(f"brick capacity overflow {ovf}")
    say(f"{n} atoms, topology {topo.label()} ({topo.n_ranks} bricks) x "
        f"{args.model_axis} model shards, "
        f"{'torchrun' if under_torchrun else 'one process'} on {dev}, "
        f"engine={args.engine}, potential={args.potential}, "
        f"ensemble={args.ensemble}"
        + (f", P0={args.pressure or 0.0} GPa" if barostat is not None else ""))

    def show(thermo, base, count):
        pe, ke = thermo["pe"].reshape(-1), thermo["ke"].reshape(-1)
        natoms = thermo["n_atoms"].reshape(-1)
        press, vol = thermo["press"].reshape(-1), thermo["vol"].reshape(-1)
        for i in range(count):
            gstep = base + i + 1
            if gstep % 33 == 0 or gstep == 1:
                say(f"step {gstep:4d}  E_pot {pe[i]:+.6f}  "
                    f"E_tot {pe[i] + ke[i]:+.6f}  "
                    f"P {press[i] * integrator.EV_A3_TO_GPA:+.2f} GPa  "
                    f"V {vol[i]:.0f} A^3  atoms {int(natoms[i])}", flush=True)

    masses_t = (lattice.MASS["Cu"],)
    boxd = stepper.pack_box(box, dev)
    if args.engine == "outer":
        policy = stepper.EscalationPolicy()

        def build(spec_run):
            return domain.make_outer_md_program(
                cfg, spec_run, comm, masses_t, args.dt, impl=args.impl,
                decomp="atoms", neighbor="cells", potential=potential,
                ensemble=ensemble, barostat=barostat)

        spec_run = spec
        program = build(spec_run)
        programs = []              # every one, escalations included
        state = program.prime(params, domain.shard_state(host, comm, dev),
                              boxd)
        ens = program.init_ensemble_state(dev)
        baro = program.init_barostat_state(dev)
        t0 = time.perf_counter()
        base = 0
        for n_segs, seg_len in stepper.chunk_schedule(
                args.steps, args.rebuild_every, args.chunk_segments):
            # one pass over the ranks per chunk; one host fetch checks its
            # flags and prints its thermo. A capacity overflow replays the
            # chunk from its entry snapshot with escalated capacities (the
            # carried-box volume folded in) and the atoms re-partitioned.
            for attempt in range(policy.max_attempts + 1):
                snap = stepper.snapshot((state, ens, boxd, baro))
                state, ens, boxd, baro, th = program.run(
                    state, params, n_segs, seg_len, ens, boxd, baro)
                thermo = stepper.fetch_thermo(th)
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
                        spec_run, policy, box_now=box_now,
                        n_model=args.model_axis)
                    say(f"  capacity overflow ({e}); replaying chunk with "
                        f"atom_capacity={spec_run.atom_capacity}, "
                        f"halo_capacity={spec_run.halo_capacity}", flush=True)
                    whole, r_ovf = domain.repartition_state(
                        domain.gather_state(state, comm), spec_run,
                        box_now=box_now)
                    if r_ovf > 0:
                        raise RuntimeError(f"repartition overflow {r_ovf}")
                    programs.append(program)
                    program = build(spec_run)
                    state = program.prime(
                        params, domain.shard_state(whole, comm, dev), boxd)
            show(thermo, base, n_segs * seg_len)
            base += n_segs * seg_len
        programs.append(program)
        captures = (f"; graph captures {sum(p.captures for p in programs)}, "
                    f"replays {sum(p.replays for p in programs)}, capture "
                    f"{sum(p.capture_s for p in programs):.3f} s")
    else:
        captures = ""
        step = domain.make_distributed_md_step(
            cfg, spec, comm, masses_t, args.dt, impl=args.impl,
            decomp="atoms", neighbor="cells", potential=potential,
            ensemble=ensemble, barostat=barostat)
        run_segment = domain.make_segment_runner(step)
        migrate = domain.make_migration_step(spec, comm)
        state = step.prime(params, domain.shard_state(host, comm, dev), boxd)
        ens = domain.init_ensemble_state(ensemble, comm, dev)
        baro = barostat.init_state(dev) if barostat is not None else ()
        t0 = time.perf_counter()
        base = 0
        for seg_len in stepper.segment_schedule(args.steps,
                                                args.rebuild_every):
            (state, ens, boxd, baro), th = run_segment(
                state, params, seg_len, ens, boxd, baro)
            thermo = stepper.fetch_thermo(th)
            domain.check_segment_thermo(thermo)
            show(thermo, base, seg_len)
            base += seg_len
            if seg_len == args.rebuild_every:      # full segment: migrate
                state, movf = migrate(state, boxd)
                if int(movf) > 0:
                    raise RuntimeError("migration overflow")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt_wall = time.perf_counter() - t0
    if barostat is not None:
        say(f"final box {np.round(boxd.cpu().numpy(), 3)} A")
    say(f"{dt_wall / args.steps * 1e6 / n:.2f} us/step/atom wall (this "
        f"host){captures}")


if __name__ == "__main__":
    main()
