"""The gloo side of ``test_torch_domain.py``'s DistComm test, in a module of
its own: each spawned process imports it, and it imports only torch, numpy
and the port (no JAX), so the processes start quickly."""

import numpy as np
import torch

from repro_torch.core import dp_model
from repro_torch.core.types import DPConfig
from repro_torch.md import comm, domain, integrator, lattice

CFG = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(64,), type_map=("Cu",),
               embed_widths=(8, 16, 32), axis_neuron=4, fit_widths=(32, 32, 32))
MASS = (63.546,)


def dist_case(c, decomp):
    """The outer program (2 segments x 3 steps, migration included) on a
    (2,) topology x ``c.n_model`` model shards under the communicator ``c``,
    in the decomposition ``decomp``; returns (state, thermo)."""
    params = dp_model.init_dp_params(torch.Generator().manual_seed(0), CFG,
                                     device="cpu")
    pos, typ, box = lattice.fcc_copper(6, 3, 3)
    rng = np.random.default_rng(4)
    pos = np.mod(pos + rng.normal(0, 0.02, pos.shape), box).astype(np.float32)
    vel = integrator.init_velocities(torch.Generator().manual_seed(4),
                                     torch.full((len(pos),), MASS[0]),
                                     330.0).numpy()
    spec = domain.DomainSpec.for_topology(tuple(box), (2,), 200, 150, 4.5)
    whole, _ = domain.partition_atoms(pos, vel, typ, spec)
    prog = domain.make_outer_md_program(CFG, spec, c, MASS, 1.0,
                                        decomp=decomp, neighbor="cells")
    boxt = torch.tensor(np.asarray(box, np.float32))
    st = prog.prime(params, domain.shard_state(whole, c, "cpu"), boxt)
    st, _, _, _, th = prog.run(st, params, 2, 3, (), boxt)
    domain.check_segment_thermo(th)
    return st, th


def worker(rank, port, out_dir, n_model, decomp):
    """One gloo process of 2 x ``n_model``: its brick through ``dist_case``;
    rank 0 saves the whole state and the thermo for the parent."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2 * n_model, rank=rank)
    try:
        c = comm.DistComm(2, n_model)
        st, th = dist_case(c, decomp)
        whole = domain.gather_state(st, c)
        if rank == 0:
            np.savez(f"{out_dir}/dist.npz", pe=th["pe"].numpy(),
                     **{k: v.numpy() for k, v in whole._asdict().items()})
    finally:
        dist.destroy_process_group()
