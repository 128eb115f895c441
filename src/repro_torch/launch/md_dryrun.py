"""Multi-pod MD dry run: what one rank of the production grid needs, without
the grid — the counterpart of ``repro.launch.md_dryrun``.

    python -m repro_torch.launch.md_dryrun --system cu --impl cheb_pallas
    python -m repro_torch.launch.md_dryrun --device cpu --system cu_strong

Cells (the reference's, per its DESIGN.md Sec. 5):
  cu        — 122,779 atoms a card (the paper's Summit per-GPU load): 31.4M
              atoms on the 16x16 grid, 62.9M on 2x16x16.
  cu_strong — the 13.5M-atom copper system of the paper's strong-scaling
              headline, on 256 cards.
  h2o       — water at 162,000 atoms a card.

For each cell and rung (mlp, quintic, cheb, cheb_pallas), one rank of the
grid (spatial 0, model 0) runs its share of the distributed MD program
(``md/domain.py``, ``decomp="atoms"``, ``neighbor="cells"``) under
``FakeTensorMode``: ``--segment-len`` steps, or with ``--outer-segments N``
N rounds of the migration sweeps then the segment (``OuterMDProgram.run``'s
loop). Its communicator is a ``DryRunComm``: each exchange has its real
shapes and is counted. ``analysis/op_cost.analyze_fn`` counts the trace's
FLOPs, bytes and peak memory; nothing is allocated on the card and no
kernel runs. The row gives memory, FLOPs, bytes and collective bytes a
card, and the roofline terms against the H100 (``analysis/roofline.py``),
under the reference's row keys and cell names (``dpmd_cu/cheb_pallas/
16x16``, ...). It adds the brick cell list's own peak above its inputs
(``cell_list_GiB``): every centre holds 27 cells' candidates while it is
built, which the reference cannot show apart.

Where the port's rule differs from the reference's:
  * peak memory is the trace's largest sum of live storages (arguments and
    autograd's saved tensors included), not XLA's buffer assignment;
  * bytes are every eager op's inputs and outputs (``op_cost``'s docstring),
    so the memory term is an eager run's; the reference's interpret-mode
    correction of the fused rung's memory term is not needed, since the
    counter sees each dp_fused kernel as one op with its real inputs and
    outputs;
  * the fused rung's compute term: the kernels skip slots past each atom's
    live count, and a fake trace has no counts, so the kernels' FLOP formula
    counts the expected share of live slots (``ops.live_fraction``), and
    nothing else is scaled (the reference scales the whole step's FLOPs by
    a live-tile share). The share is (density 4/3 pi rcut_halo^3) / N, not
    the reference's rcut: the count runs to a row's last slot within rcut,
    and the list holds the neighbours out to rcut_halo (:func:`live_share`);
  * the kernels' FLOPs are those of the port's factored kernels
    (``ops.kernel_cost``), not of a materialised G;
  * host reads (the per-segment overflow check) are not traced: a fake
    tensor has no data.

:func:`run_rank` runs the same rank for real on one card: a periodic brick
of the cell's lattice (edges rounded to whole lattice cells) whose halo is
its own far faces (``DryRunComm(self_image=True)``), at the traced shapes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis import op_cost, roofline as rl
from repro_torch.core import dp_model
from repro_torch.core.types import COPPER_DP, WATER_DP, DPConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dp_fused import ops as dp_fused_ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.md import api, comm as comm_mod, domain, integrator, lattice
from repro_torch.md import stepper
from repro_torch.md.topology import Topology


@dataclasses.dataclass(frozen=True)
class MDCell:
    name: str
    cfg: DPConfig
    atoms_per_chip: int
    dt_fs: float
    masses: Tuple[float, ...]
    density: float               # atoms / A^3


CU = MDCell("cu", COPPER_DP, 122_779, 1.0, (63.546,), 4 / 3.634**3)
CU_STRONG = MDCell("cu_strong", COPPER_DP, 52_734, 1.0, (63.546,),
                   4 / 3.634**3)
H2O = MDCell("h2o", WATER_DP, 162_000, 0.5, (15.999, 1.008),
             192 / 12.42**3)
CELLS = {"cu": CU, "cu_strong": CU_STRONG, "h2o": H2O}

IMPLS = ("mlp", "quintic", "cheb", "cheb_pallas")


def geometry(cell: MDCell, n_slabs: int, n_model: int,
             topology: Optional[Tuple[int, ...]] = None
             ) -> Tuple[domain.DomainSpec, int]:
    """Brick box sized so each card owns ``atoms_per_chip`` centers.

    ``topology`` picks the N-D brick shape over the spatial ranks (default:
    the 1-D ``(n_slabs,)`` slab column). Decomposed axes get a brick edge
    of at least ``2.2 * rc_halo``; the remaining volume spreads over the
    undecomposed axes (or inflates the brick for a full 3-D topology).
    """
    topo = Topology.parse(topology if topology is not None else (n_slabs,))
    assert topo.n_ranks == n_slabs, (topo.shape, n_slabs)
    cap = cell.atoms_per_chip * n_model
    cap = -(-cap // n_model) * n_model
    brick_volume = cap / cell.density
    rc_halo = cell.cfg.rcut + 2.0
    w_min = max(2.2 * rc_halo, 25.0)
    ndim = topo.ndim
    if ndim == 3:
        w = max(brick_volume ** (1.0 / 3.0), w_min)
        edges = (w, w, w)
    elif ndim == 2:
        rest = brick_volume / (w_min * w_min)
        edges = (w_min, w_min, max(rest, 1.0))
    else:
        yz = float(np.sqrt(brick_volume / w_min))
        edges = (w_min, yz, yz)
    box = tuple(edges[a] * (topo.shape[a] if a < ndim else 1)
                for a in range(3))
    # per-axis halo fraction; later sweeps pack earlier sweeps' ghosts too,
    # so the send capacity grows with the decomposed rank
    halo_frac = max(rc_halo / edges[a] for a in range(ndim))
    halo_cap = int(cap * halo_frac * 1.4 * 1.6 ** (ndim - 1)) + 1024
    spec = domain.DomainSpec(
        box=box, n_slabs=n_slabs,
        atom_capacity=int(cap * 1.08) // n_model * n_model,
        halo_capacity=halo_cap, rcut_halo=rc_halo, topology=topo.shape)
    return spec, cap


def dp_model_flops(cfg: DPConfig, n_atoms: int, impl: str) -> float:
    """Useful FLOPs per MD step (fwd + force backward ~ 3x fwd).

    Embedding (paper Sec. 3.2): mlp = Nm*d1 + 10*Nm*d1^2 per atom;
    tabulated = 56*Nm*d1. Descriptor contraction + fitting added for all.
    """
    nm = cfg.nsel
    d1 = cfg.embed_widths[0]
    m = cfg.m_embed
    if impl == "mlp":
        embed = nm * d1 + 10 * nm * d1 * d1
    else:
        embed = 56 * nm * d1
    contract = 2 * nm * 4 * m + 2 * 4 * m * cfg.axis_neuron
    fit_in = cfg.descriptor_dim
    fit = 2 * (fit_in * cfg.fit_widths[0]
               + cfg.fit_widths[0] * cfg.fit_widths[1]
               + cfg.fit_widths[1] * cfg.fit_widths[2] + cfg.fit_widths[2])
    return 3.0 * n_atoms * (embed + contract + fit)


class Rank(NamedTuple):
    """One rank's configuration on a grid: what the trace and the real run
    share."""
    name: str
    cell: MDCell
    impl: str
    cfg: DPConfig                 # the cell's model at this rung (and sel)
    spec: domain.DomainSpec
    cap: int                      # atoms of a brick (all model shards)
    n_spatial: int
    n_model: int
    pods: int
    n_chips: int
    potential: Optional[api.Potential]
    ensemble: api.Ensemble
    barostat: Optional[api.Barostat]


def rank_config(cell: MDCell, impl: str, mesh, multi_pod: bool,
                potential_name: str = "dp",
                ensemble: Optional[api.Ensemble] = None,
                barostat: Optional[api.Barostat] = None,
                topology: Optional[str] = None,
                sel: Optional[Tuple[int, ...]] = None,
                outer_segments: int = 0) -> Rank:
    """Rank (spatial 0, model 0) of ``mesh`` for ``cell`` at rung ``impl``.
    ``sel`` replaces the model's neighbor capacities (the name says so)."""
    pods = mesh.shape.get("pod", 1)
    n_slabs = mesh.shape["data"] * pods
    n_model = mesh.shape["model"]
    ensemble = ensemble or api.NVE()
    mesh_name = "x".join(str(s) for s in mesh.sizes)
    name = f"dpmd_{cell.name}/{impl}/{mesh_name}"
    if potential_name != "dp":
        name = f"{potential_name}_{cell.name}/{mesh_name}"
    if topology:
        name += f"/topo{Topology.parse(topology).label()}"
    if sel is not None:
        name += "/sel" + "-".join(str(s) for s in sel)
    if type(ensemble) is not api.NVE:
        name += f"/{type(ensemble).__name__}"
    if barostat is not None:
        name += f"/{type(barostat).__name__}"
    if outer_segments:
        name += f"/outer{outer_segments}"
    topo = (Topology.parse(topology).shape if topology else None)
    spec, cap = geometry(cell, n_slabs, n_model, topology=topo)
    cfg = dataclasses.replace(cell.cfg, impl=impl)
    if sel is not None:
        cfg = dataclasses.replace(cfg, sel=tuple(int(s) for s in sel))
    potential = None                 # make_local_md_step wraps cfg/impl
    if potential_name == "lj":
        potential = api.LJPotential(sel=tuple(cfg.sel), rcut_lj=cfg.rcut)
    return Rank(name, cell, impl, cfg, spec, cap, n_slabs, n_model, pods,
                mesh.size, potential, ensemble, barostat)


def live_share(rank: Rank) -> float:
    """Expected share of a padded neighbour row that the kernels read: the
    neighbours within the search radius rcut_halo at the cell's density
    over the padded row width N. A row's live count runs to its last slot
    within rcut, and the list holds the neighbours out to rcut_halo in cell
    order, so the count ends near the last of those, not after the
    neighbours within rcut alone."""
    nsel = sum(domain.pad_sel_for(rank.cfg, rank.n_model).sel)
    found = (rank.cell.density * 4.0 / 3.0 * math.pi
             * rank.spec.rcut_halo ** 3)
    return min(1.0, found / nsel)


def _params(rank: Rank, dev: torch.device, seed: int):
    if rank.potential is not None:
        return {}
    p = dp_model.init_dp_params(torch.Generator().manual_seed(seed),
                                rank.cfg, device=dev)
    if rank.impl in ("quintic", "cheb", "cheb_pallas"):
        p = dp_model.tabulate_model(
            p, rank.cfg, "quintic" if rank.impl == "quintic" else "cheb")
    return p


def _local(rank: Rank, spec: domain.DomainSpec):
    return domain.make_local_md_step(
        rank.cfg, spec, rank.n_model, rank.cell.masses, rank.cell.dt_fs,
        impl=rank.impl, decomp="atoms", neighbor="cells",
        potential=rank.potential, ensemble=rank.ensemble,
        barostat=rank.barostat)


def _segment(comm, local, spec, segment_len: int, outer_segments: int):
    """The rank's program on ``(params, carry)``: ``segment_len`` steps, or
    ``outer_segments`` rounds of migration + ``segment_len`` steps."""

    def run(params, carry):
        with torch.no_grad():
            if outer_segments:
                return domain.run_outer_brick(comm, local.step, spec, params,
                                              carry, outer_segments,
                                              segment_len)
            return domain.run_brick_steps(comm, local.step, params, carry,
                                          segment_len)
    return run


def _carry(rank: Rank, spec, brick: domain.SlabState, dev):
    ens = rank.ensemble.init_state(dev)
    baro = (rank.barostat.init_state(dev) if rank.barostat is not None
            else ())
    return (brick, ens, stepper.pack_box(spec.box, dev), baro)


def _empty_brick(spec: domain.DomainSpec, dev) -> domain.SlabState:
    cap = spec.atom_capacity
    return domain.SlabState(
        torch.zeros((cap, 3), device=dev), torch.zeros((cap, 3), device=dev),
        torch.zeros((cap,), dtype=torch.int64, device=dev),
        torch.zeros((cap,), dtype=torch.bool, device=dev),
        torch.zeros((cap, 3), device=dev))


class Trace(NamedTuple):
    totals: op_cost.CostTotals
    cell_list: op_cost.CostTotals
    stats: rl.CollectiveStats
    seconds: float


def trace_rank(rank: Rank, segment_len: int = 4, outer_segments: int = 0,
               device: DeviceLike = "cuda", seed: int = 0) -> Trace:
    """Count the rank's program under ``FakeTensorMode`` on ``device`` (no
    memory is allocated there), and apart from it the brick cell list's
    search at the same shapes."""
    dev = torch.device(device)
    spec = rank.spec
    comm = comm_mod.DryRunComm(rank.n_spatial, rank.n_model, pods=rank.pods)
    local = _local(rank, spec)
    share = live_share(rank) if rank.impl == "cheb_pallas" else 1.0
    t0 = time.perf_counter()
    with FakeTensorMode():
        params = _params(rank, dev, seed)
        carry = _carry(rank, spec, _empty_brick(spec, dev), dev)
        with dp_fused_ops.live_fraction(share):
            totals = op_cost.analyze_fn(
                _segment(comm, local, spec, segment_len, outer_segments),
                params, carry, comm=comm)
        # the cell list alone, on the owned atoms and every sweep's ghosts
        n_all = spec.atom_capacity + 2 * spec.halo_capacity * spec.topo.ndim
        box = carry[2]
        widths = [box[a] / float(spec.topology[a]) for a in spec.topo.axes]
        cells = op_cost.analyze_fn(
            lambda *a: local.neighbors(*a, box=box, widths=widths),
            torch.zeros((n_all, 3), device=dev),
            torch.zeros((n_all,), dtype=torch.int64, device=dev),
            torch.zeros((n_all,), dtype=torch.bool, device=dev),
            torch.zeros((3,), device=dev), 0)
    return Trace(totals, cells, comm.stats, time.perf_counter() - t0)


def lower_md_cell(cell: MDCell, impl: str, mesh, multi_pod: bool,
                  verbose: bool = True, segment_len: int = 4,
                  outer_segments: int = 0, potential_name: str = "dp",
                  ensemble: Optional[Any] = None,
                  barostat: Optional[Any] = None,
                  topology: Optional[str] = None,
                  device: DeviceLike = "cuda",
                  sel: Optional[Tuple[int, ...]] = None) -> Dict[str, Any]:
    """The JSON row of one cell x rung x grid (``status`` "ok" or
    "failed"); the reference's keys, then the port's own."""
    name = f"dpmd_{cell.name}/{impl}"
    try:
        rank = rank_config(cell, impl, mesh, multi_pod, potential_name,
                           ensemble, barostat, topology, sel, outer_segments)
        name = rank.name
        tr = trace_rank(rank, segment_len, outer_segments, device)
        hw = (rl.h100() if torch.device(device).type == "cuda"
              else rl.HW_H100)
        n_atoms_global = rank.cap * rank.n_spatial
        steps = segment_len * max(outer_segments, 1)
        if potential_name == "lj":
            # ~30 flops per neighbor slot, fwd + force backward ~ 3x
            model_flops = 3.0 * n_atoms_global * rank.cfg.nsel * 30.0
        else:
            model_flops = dp_model_flops(rank.cfg, n_atoms_global, impl)
        t = tr.totals
        report = rl.make_report(name, rank.n_chips, t.flops,
                                t.bytes_accessed, tr.stats,
                                steps * model_flops, t.peak_bytes, hw)
        kernel_flops = sum(v for k, v in t.flops_by_op.items()
                           if "dp_fused" in k)
        row = report.row()
        row.update({
            "cell": name, "status": "ok", "impl": impl,
            "atoms_global": n_atoms_global,
            "atoms_per_chip": n_atoms_global // rank.n_chips,
            "t_compile_s": round(tr.seconds, 1),     # the trace's time
            "arg_bytes": int(t.arg_bytes),
            "temp_bytes": int(t.temp_bytes),
            "steps": steps,
            "centers": rank.spec.atom_capacity // rank.n_model,
            "sel": list(rank.cfg.sel),
            "cell_capacity": rank.spec.cell_capacity,
            "cell_list_GiB": tr.cell_list.temp_bytes / 2**30,
            "kernel_flops/chip": kernel_flops,
            "live_share": (live_share(rank) if impl == "cheb_pallas"
                           else None),
            "coll_by_kind": dict(tr.stats.bytes_by_kind),
            "bound_time": report.bound_time,
            "hw": hw.name, "hbm_bytes": hw.hbm_bytes,
        })
        if verbose:
            print(f"[ok] {name}: atoms/chip {row['atoms_per_chip']}, trace "
                  f"{tr.seconds:.1f}s, mem/chip {row['mem_GiB']:.2f} GiB (cell "
                  f"list {row['cell_list_GiB']:.2f}), dominant="
                  f"{row['dominant']}, t=(c {report.t_compute*1e3:.1f} | m "
                  f"{report.t_memory*1e3:.1f} | coll "
                  f"{report.t_collective*1e3:.2f}) ms useful="
                  f"{row['useful_ratio']:.2f}", flush=True)
        return row
    except Exception as e:
        traceback.print_exc()
        print(f"[FAIL] {name}: {type(e).__name__}: {e}", flush=True)
        return {"cell": name, "status": "failed",
                "error": f"{type(e).__name__}: {e}"}


# ------------------------------------------------------------ real runs

def rank_brick(rank: Rank, seed: int = 0
               ) -> Tuple[domain.SlabState, domain.DomainSpec, int]:
    """Rank 0's brick as a periodic block of the cell's lattice (fcc copper
    or ``water_box``), each edge rounded to whole lattice cells, padded to
    the traced atom capacity; host tensors. Returns the brick, the spec at
    the rounded box (the traced capacities kept) and the atom count."""
    spec = rank.spec
    topo = spec.topo
    water = tuple(rank.cfg.type_map) == ("O", "H")
    a = lattice.WATER_CELL_A if water else lattice.FCC_CU_A
    edges = [spec.box[d] / (topo.shape[d] if d < topo.ndim else 1)
             for d in range(3)]
    counts = [max(1, round(e / a)) for e in edges]
    if water:
        pos, typ, _ = lattice.water_box(*counts, seed=seed)
    else:
        pos, typ, _ = lattice.fcc_copper(*counts)
    box = tuple(counts[d] * a * (topo.shape[d] if d < topo.ndim else 1)
                for d in range(3))
    spec_real = dataclasses.replace(spec, box=box)
    n, cap = len(pos), spec.atom_capacity
    if n > cap:
        raise ValueError(f"{rank.name}: the rounded brick holds {n} atoms, "
                         f"more than its capacity {cap}")
    masses = torch.as_tensor(lattice.masses_for(rank.cfg.type_map, typ),
                             dtype=torch.float32)
    vel = integrator.init_velocities(torch.Generator().manual_seed(seed),
                                     masses, 330.0)

    def padded(x, dtype):
        out = torch.zeros((cap,) + x.shape[1:], dtype=dtype)
        out[:n] = x
        return out

    brick = domain.SlabState(
        padded(torch.as_tensor(pos, dtype=torch.float32), torch.float32),
        padded(vel.to(torch.float32), torch.float32),
        padded(torch.as_tensor(typ, dtype=torch.int64), torch.int64),
        padded(torch.ones(n, dtype=torch.bool), torch.bool),
        torch.zeros((cap, 3), dtype=torch.float32))
    return brick, spec_real, n


def run_rank(rank: Rank, segment_len: int = 2, outer_segments: int = 0,
             device: DeviceLike = "cuda", seed: int = 0) -> Dict[str, Any]:
    """The rank's program for real: its brick (:func:`rank_brick`) on
    ``device``, the halo from its own far faces, ``outer_segments`` and
    ``segment_len`` as traced. On the card, ``peak_bytes`` is the most
    allocated above what was allocated before the params and the brick
    (comparable with the trace's ``peak_bytes``); the program runs twice,
    the second time for ``ms_per_step``. Raises on an overflow flag."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    brick, spec, n = rank_brick(rank, seed)
    comm = comm_mod.DryRunComm(rank.n_spatial, rank.n_model, pods=rank.pods,
                               self_image=True)
    local = _local(rank, spec)
    seg = _segment(comm, local, spec, segment_len, outer_segments)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    params = _params(rank, dev, seed)
    carry = _carry(rank, spec, domain.SlabState(*(x.to(dev) for x in brick)),
                   dev)
    t0 = time.perf_counter()
    out, th = seg(params, carry)
    if cuda:
        torch.cuda.synchronize(dev)
    first = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - base) if cuda else None
    thermo = stepper.fetch_thermo(th)
    domain.check_segment_thermo(thermo)
    del out, th
    t0 = time.perf_counter()
    seg(params, carry)
    if cuda:
        torch.cuda.synchronize(dev)
    again = time.perf_counter() - t0
    steps = segment_len * max(outer_segments, 1)
    return {"peak_bytes": peak, "base_bytes": base if cuda else None,
            "atoms": n, "steps": steps,
            "ms_per_step_first": first / steps * 1e3,
            "ms_per_step": again / steps * 1e3,
            "pe": thermo["pe"].reshape(-1).tolist(),
            "n_atoms": thermo["n_atoms"].reshape(-1).tolist(),
            "box": spec.box}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--system", action="append",
                    choices=("cu", "cu_strong", "h2o"), default=None)
    ap.add_argument("--impl", action="append", choices=IMPLS, default=None)
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--segment-len", type=int, default=4,
                    help="MD steps of the traced segment")
    ap.add_argument("--outer-segments", type=int, default=0,
                    help="if > 0, trace this many rounds of migration + "
                         "segment-len steps instead of a single segment")
    ap.add_argument("--potential", default="dp", choices=("dp", "lj"),
                    help="force model in the traced program")
    ap.add_argument("--ensemble", default="nve",
                    choices=api.ENSEMBLE_CHOICES,
                    help="integrator/thermostat in the traced program")
    ap.add_argument("--topology", default=None,
                    help="N-D brick shape over the spatial ranks, e.g. 4x4 "
                         "on the 16x16 grid (default: the 1-D slab column)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the fake tensors (cpu traces without a "
                         "card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    ensemble, barostat = api.resolve_ensemble(args.ensemble)

    systems = args.system or ["cu", "cu_strong", "h2o"]
    impls = args.impl or list(IMPLS)
    if args.potential == "lj":
        impls = impls[:1]           # impl ladder is DP-only; one LJ row
    meshes = []
    if args.mesh in ("pod", "both"):
        meshes.append((mesh_mod.make_production_mesh(multi_pod=False), False))
    if args.mesh in ("multipod", "both"):
        meshes.append((mesh_mod.make_production_mesh(multi_pod=True), True))

    rows = []
    fails = 0
    for mesh, multi in meshes:
        for s in systems:
            for impl in impls:
                row = lower_md_cell(CELLS[s], impl, mesh, multi,
                                    segment_len=args.segment_len,
                                    outer_segments=args.outer_segments,
                                    potential_name=args.potential,
                                    ensemble=ensemble, barostat=barostat,
                                    topology=args.topology,
                                    device=args.device)
                rows.append(row)
                fails += row["status"] == "failed"
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=str)
    print(f"{len(rows) - fails} ok, {fails} failed")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
