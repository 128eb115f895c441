"""The spawned side of the port's DistComm tests (gloo on the CPU for
``test_torch_domain.py`` and ``test_torch_domain_capture.py``, NCCL on the
cards for ``test_torch_cuda.py``), in a module of its own: each spawned
process imports it, and it imports only torch, numpy and the port (no JAX),
so the processes start quickly."""

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import dp_model
from repro_torch.core.types import DPConfig
from repro_torch.md import api, comm, domain, integrator, lattice, stepper

CFG = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(64,), type_map=("Cu",),
               embed_widths=(8, 16, 32), axis_neuron=4, fit_widths=(32, 32, 32))
MASS = (63.546,)
#: segments x steps of the captured-segment cases
N_SEGS, SEG_LEN = 3, 3


def _system(halo=150):
    """fcc_copper(6,3,3) = 216 atoms jittered, in a (2,) topology."""
    pos, typ, box = lattice.fcc_copper(6, 3, 3)
    rng = np.random.default_rng(4)
    pos = np.mod(pos + rng.normal(0, 0.02, pos.shape), box).astype(np.float32)
    vel = integrator.init_velocities(torch.Generator().manual_seed(4),
                                     torch.full((len(pos),), MASS[0]),
                                     330.0).numpy()
    spec = domain.DomainSpec.for_topology(tuple(box), (2,), 200, halo, 4.5)
    whole, _ = domain.partition_atoms(pos, vel, typ, spec)
    return spec, whole, torch.tensor(np.asarray(box, np.float32))


def _params():
    return dp_model.init_dp_params(torch.Generator().manual_seed(0), CFG,
                                   device="cpu")


def _program(c, spec, decomp, kind="nve", **kw):
    ens = (api.NVTLangevin(friction=0.05, seed=3) if kind == "langevin"
           else None)
    return domain.make_outer_md_program(CFG, spec, c, MASS, 1.0,
                                        decomp=decomp, neighbor="cells",
                                        ensemble=ens, **kw)


def dist_case(c, decomp):
    """The outer program (2 segments x 3 steps, migration included) on a
    (2,) topology x ``c.n_model`` model shards under the communicator ``c``,
    in the decomposition ``decomp``; returns (state, thermo)."""
    params = _params()
    spec, whole, boxt = _system()
    prog = _program(c, spec, decomp)
    st = prog.prime(params, domain.shard_state(whole, c, "cpu"), boxt)
    st, _, _, _, th = prog.run(st, params, 2, 3, (), boxt)
    domain.check_segment_thermo(th)
    return st, th


def _gen_states(ens):
    return [g.get_state() for g in stepper.generators_of(ens)]


def static_case(c, decomp, kind):
    """The per-process segment (``StaticSegment``, run eagerly on its
    static buffers) against the eager outer program under ``c``: N_SEGS
    calls against N_SEGS segments of SEG_LEN steps from the same primed
    carry, bit for bit (states, box, thermo, the callers' generators).
    Then, for Langevin, a replay from a restored state draws the same noise
    and one from moved-on generators does not. Returns the whole state and
    thermo of the segment's run, the generator states of every held brick
    and the checks that failed here."""
    params = _params()
    spec, whole, boxt = _system()
    prog = _program(c, spec, decomp, kind)
    ens = prog.init_ensemble_state("cpu")
    start = stepper.snapshot((prog.prime(
        params, domain.shard_state(whole, c, "cpu"), boxt), ens))
    st, ens = stepper.restore(start)
    want, _, box_w, _, th_w = prog.run(st, params, N_SEGS, SEG_LEN, ens, boxt)
    gens_w = _gen_states(ens)

    st, ens = stepper.restore(start)
    seg = domain.StaticSegment(prog, params, (st, ens, boxt, ()), SEG_LEN)
    seg.load(st, ens, boxt, ())
    ths = [seg.replay() for _ in range(N_SEGS)]
    seg.store_gens(ens, ())
    th = {k: torch.cat([t[k] for t in ths]) for k in ths[0]}
    bad = [k for k, v in th_w.items() if not torch.equal(th[k], v)]
    bad += [f"state.{f}" for f, a, b in zip(domain.SlabState._fields,
                                            seg.state, want)
            if not torch.equal(a, b)]
    if not torch.equal(seg.box, box_w):
        bad.append("box")
    gens = _gen_states(ens)
    if not all(torch.equal(a, b) for a, b in zip(gens, gens_w)):
        bad.append("generators")
    if sorted(seg.trees) != list(c.ranks):
        bad.append(f"trees {sorted(seg.trees)}")
    out = dict(state=domain.gather_state(seg.state, c), pe=th["pe"],
               ke=th["ke"], gens=gens)
    if kind == "langevin":
        vel = seg.state.vel.clone()
        seg.load(start.carry[0], ens, boxt, ())     # the noise moves on
        seg.replay()
        fresh = seg.state.vel.clone()
        st, ens = stepper.restore(start)             # and comes back
        seg.load(st, ens, boxt, ())
        for _ in range(N_SEGS):
            seg.replay()
        if not torch.equal(seg.state.vel, vel):
            bad.append("restored replay")
        if torch.equal(fresh[..., :1], vel[..., :1]):
            bad.append("fresh noise")
    return out, bad


# ops that read a device value on the host or size their output by data
_aten = torch.ops.aten
_SYNCS = {_aten._local_scalar_dense, _aten.item, _aten.nonzero,
          _aten.masked_select, _aten._unique2, _aten.unique_consecutive,
          _aten.unique_dim}
_COPIES = {_aten._to_copy, _aten.copy_, _aten._copy_from}


class NoHostSync(TorchDispatchMode):
    """Raises on an op that would make the host wait for the device: a
    scalar read, an output sized by the data, a copy to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in _SYNCS:
            raise AssertionError(f"host sync: {func}")
        if packet in _COPIES:
            src = args[0] if packet is _aten._to_copy else args[1]
            dst = (kwargs.get("device") if packet is _aten._to_copy
                   else args[0].device)
            if (dst is not None and torch.device(dst).type == "cpu"
                    and src.device.type != "cpu"):
                raise AssertionError(f"copy to the host: {func}")
        return func(*args, **kwargs)


def guard_case(c):
    """One segment (migration, then two steps) of this process's rank under
    :class:`NoHostSync`: no op of it, the gloo calls included, would wait
    for the device. Returns the failed checks."""
    params = _params()
    spec, whole, boxt = _system()
    prog = _program(c, spec, "atoms")
    st = prog.prime(params, domain.shard_state(whole, c, "cpu"), boxt)
    ens = prog.init_ensemble_state("cpu")
    seg = domain.StaticSegment(prog, params, (st, ens, boxt, ()), 2)
    seg.load(st, ens, boxt, ())
    with NoHostSync():
        th = seg.replay()
    domain.check_segment_thermo(th)
    return [] if th["pe"].shape == (1, 2) else [f"thermo {th['pe'].shape}"]


def cpu_capture_graph(fail_rank=None):
    """A stand-in for ``stepper.capture_graph`` on the CPU with its control
    flow: the warm-up runs (with its agreement), the generators go back to
    their states, and no graph is made (``StaticSegment.replay`` then runs
    the segment eagerly). ``fail_rank``'s recording raises."""
    import torch.distributed as dist

    def capture_graph(fn, warm, gens, pool=None, error_mode="global"):
        states = [g.get_state() for g in gens]
        warm()
        for g, s in zip(gens, states):
            g.set_state(s)
        if fail_rank is not None and dist.get_rank() == fail_rank:
            raise RuntimeError("recording refused on this process")
        return None, None, (0, 0)

    return capture_graph


def escalation_case(c):
    """md_run's chunk loop with the captured path's control flow (the gate
    open, ``cpu_capture_graph`` for the graph) from a halo capacity too small
    for the bricks: the flags, maxed over the grid, fail the check on every
    process alike, each escalates, re-partitions and builds a new program,
    until a run passes. Returns the halo capacities tried, the captures
    and replays a program, the final whole state and its thermo."""
    params = _params()
    spec, whole, boxt = _system(halo=12)
    st0 = domain.shard_state(whole, c, "cpu")
    policy, tried, counts = stepper.EscalationPolicy(), [], []
    for _ in range(policy.max_attempts):
        tried.append(spec.halo_capacity)
        prog = _program(c, spec, "atoms")
        st = prog.prime(params, st0, boxt)
        st, _, _, _, th = prog.run(st, params, 1, SEG_LEN, (), boxt)
        counts.append((prog.captures, prog.replays))
        try:
            domain.check_segment_thermo(stepper.fetch_thermo(th))
            break
        except RuntimeError as e:
            if "halo_overflow" not in str(e):
                raise
        # as md_run: escalate, gather, re-partition, a new program
        spec = domain.escalate_capacities(spec, policy, n_model=c.n_model)
        whole, _ = domain.repartition_state(domain.gather_state(st0, c), spec)
        st0 = domain.shard_state(whole, c, "cpu")
    return dict(tried=tried, counts=counts, pe=th["pe"],
                state=domain.gather_state(st, c))


def open_gate(capture_graph):
    """Runs the captured path of ``OuterMDProgram.run`` on the CPU, with
    ``capture_graph`` for ``stepper.capture_graph`` (this process only)."""
    domain.OuterMDProgram.captures_on = lambda self, state: self.capture
    stepper.capture_graph = capture_graph


def failure_case(c, where):
    """A capture that fails on rank 1 alone, after its warm-up's
    collectives or in its recording: every process must raise. Returns this
    process's error. (On gloo a rank that stopped before a collective
    would leave its peer waiting in it; on NCCL the host does not wait.)"""
    orig_segment = domain.StaticSegment._segment

    def broken(self, state, box, seg_len):
        out = orig_segment(self, state, box, seg_len)
        if seg_len == 1 and c.rank == 1:    # the capture's warm-up step
            raise RuntimeError("warm-up refused on this process")
        return out

    open_gate(cpu_capture_graph(1 if where == "capture" else None))
    if where == "warm-up":
        domain.StaticSegment._segment = broken
    params = _params()
    spec, whole, boxt = _system()
    prog = _program(c, spec, "atoms")
    st = prog.prime(params, domain.shard_state(whole, c, "cpu"), boxt)
    try:
        prog.run(st, params, 1, SEG_LEN, (), boxt)
    except RuntimeError as e:
        return str(e)
    finally:
        domain.StaticSegment._segment = orig_segment
    return None


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, args, nprocs, deadline_s):
    """``fn(rank, *args)`` in ``nprocs`` spawned processes, waited for
    at most ``deadline_s`` (an AssertionError past it); a process that
    raised re-raises here, and none is left running."""
    import time

    ctx = torch.multiprocessing.start_processes(
        fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=2):
            assert time.monotonic() < deadline, "ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def _init(rank, port, world):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    return dist


def worker(rank, port, out_dir, n_model, decomp):
    """One gloo process of 2 x ``n_model``: its brick through ``dist_case``;
    rank 0 saves the whole state and the thermo for the parent."""
    dist = _init(rank, port, 2 * n_model)
    try:
        c = comm.DistComm(2, n_model)
        st, th = dist_case(c, decomp)
        whole = domain.gather_state(st, c)
        if rank == 0:
            np.savez(f"{out_dir}/dist.npz", pe=th["pe"].numpy(),
                     **{k: v.numpy() for k, v in whole._asdict().items()})
    finally:
        dist.destroy_process_group()


def capture_worker(rank, port, out_dir, n_model, decomp, extra):
    """One gloo process of 2 x ``n_model`` through the captured path's
    cases: ``static_case`` for NVE and Langevin, then, with ``extra``, the
    no-host-read guard, the escalation and a capture failing in its warm-up
    and in its recording. Each process saves what it found."""
    dist = _init(rank, port, 2 * n_model)
    out = {}
    try:
        c = comm.DistComm(2, n_model)
        for kind in ("nve", "langevin"):
            out[kind] = static_case(c, decomp, kind)
        if extra:
            out["guard"] = guard_case(c)
            open_gate(cpu_capture_graph())
            out["escalation"] = escalation_case(c)
            for where in ("warm-up", "capture"):
                out[f"fail_{where}"] = failure_case(c, where)
    finally:
        torch.save(out, f"{out_dir}/rank{rank}.pt")
        dist.destroy_process_group()


# ------------------------------------------------------ NCCL, one card each

def card_case(c, dev, decomp, capture):
    """fcc_copper(6,3,3) on a (2,) topology x ``c.n_model`` shards on the
    card in the decomposition ``decomp``, the fused kernels through
    cheb_pallas: the outer program primed, then 2 x 5 steps and 1 x 3, one
    thermo fetch a chunk. Returns the whole final state, the thermo rows,
    the kernels' launches after the prime and the program."""
    from repro_torch.kernels.dp_fused import ops

    params = dp_model.tabulate_model(dp_model.init_dp_params(
        torch.Generator().manual_seed(0), CFG, device=dev), CFG, "cheb")
    spec, whole, boxt = _system()
    boxt = boxt.to(dev)
    prog = domain.make_outer_md_program(
        CFG, spec, c, MASS, 1.0, impl="cheb_pallas", decomp=decomp,
        neighbor="cells", capture=capture)
    st = prog.prime(params, domain.shard_state(whole, c, dev), boxt)
    fw0, bw0 = ops.fwd_launches, ops.bwd_launches
    rows = []
    for n_segs, seg_len in ((2, 5), (1, 3)):
        st, _, _, _, th = prog.run(st, params, n_segs, seg_len, (), boxt)
        th = stepper.fetch_thermo(th)
        domain.check_segment_thermo(th)
        rows.append({k: th[k] for k in ("pe", "ke", "n_atoms")})
    torch.cuda.synchronize()
    launches = (ops.fwd_launches - fw0, ops.bwd_launches - bw0)
    thermo = {k: np.concatenate([r[k].reshape(-1) for r in rows])
              for k in rows[0]}
    return domain.gather_state(st, c), thermo, launches, prog


def card_failure(c, dev):
    """Rank 1's recording reads a device value on the host (which a capture
    refuses); returns this process's error, None if it did not raise."""
    orig = domain.StaticSegment._segment

    def reads(self, state, box, seg_len):
        if c.rank == 1 and torch.cuda.is_current_stream_capturing():
            float(state.pos.sum())
        return orig(self, state, box, seg_len)

    domain.StaticSegment._segment = reads
    try:
        card_case(c, dev, "atoms", True)
    except RuntimeError as e:
        return str(e)
    finally:
        domain.StaticSegment._segment = orig
    return None


def nccl_worker(rank, port, out_dir, n_model, decomp):
    """One NCCL process on card ``rank`` of 2 x ``n_model``: ``card_case``
    eager and captured, then (2 processes) a capture that fails on rank 1.
    Each process saves what it found."""
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=2 * n_model, rank=rank)
    out = {}
    try:
        c = comm.DistComm(2, n_model)
        for capture in (False, True):
            whole, thermo, launches, prog = card_case(c, c.device, decomp,
                                                      capture)
            out[capture] = dict(state=whole, thermo=thermo,
                                launches=launches, captures=prog.captures,
                                replays=prog.replays)
            del prog
        if n_model == 1:
            out["failure"] = card_failure(c, c.device)
    finally:
        torch.save(out, f"{out_dir}/rank{rank}.pt")
        domain.release_graphs()
        dist.destroy_process_group()
