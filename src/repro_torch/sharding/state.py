"""Trees of DTensors: the plan's layouts made real on a ``DeviceMesh``.

The reference jits its functions with ``in_shardings``/``out_shardings``
and lets GSPMD place every array; the port places them itself:

  * :func:`device_mesh` — the ``DeviceMesh`` of a rank grid (the ranks
    present: :func:`local_grid`), and :func:`grid` a mesh's shapes for the
    plan and the activation rules;
  * :func:`distribute` — a tree to DTensors by its plan, one leaf at a
    time: each rank cuts its shard out of the full leaf (every rank holds
    the same full leaf, drawn from the same seed), so placing moves no
    data; :func:`layer_placer` does the same to a model's stacked layers
    while its init draws them (``common.stack_layers``), one layer at a
    time;
  * :func:`gather` — a tree back to full tensors (checkpoints, checks);
  * :func:`distribute_batch` — a batch that every rank holds whole, cut to
    ``plans.batch_spec``: ``Shard(0)`` over the batch axes (with the
    spec's fallbacks), ``Replicate()`` over ``model``;
  * :func:`like_params` — gradients to their parameters' placements (FSDP's
    reduce-scatter of a partial sum).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.launch.mesh import RankGrid, make_local_mesh
from repro_torch.sharding import plans
from repro_torch.sharding.ctx import is_dtensor
from repro_torch.train import tree


def device_mesh(grid: RankGrid, device: torch.device):
    """The ``DeviceMesh`` of ``grid`` (its axis names the mesh's dim names)
    over the initialised process group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, tuple(grid.sizes),
                            mesh_dim_names=tuple(grid.axis_names))


def local_grid(model_axis: int) -> RankGrid:
    """The ``(data, model)`` grid of the ranks present, ``model_axis`` of
    them on ``model`` (``launch/mesh.make_local_mesh``)."""
    return RankGrid(("data", "model"), make_local_mesh(model_axis))


def grid(mesh) -> RankGrid:
    """The axis names and sizes of a ``DeviceMesh``, as the plan reads them."""
    return RankGrid(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def shard_of(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements`` (a view): the
    mesh dims split in order, as ``torch.chunk`` splits (the plan only
    shards dims the axes divide)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    local = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return local


def place(full: torch.Tensor, mesh, spec: plans.Spec) -> torch.Tensor:
    """``full`` (the same on every rank) as a DTensor laid out by ``spec``;
    its shard is copied, so ``full`` may be freed."""
    from torch.distributed.tensor import DTensor

    pl = plans.placements(spec, mesh)
    local = shard_of(full, mesh, pl).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, pl, run_check=False)


def distribute(full_tree: Any, mesh, specs: Dict[str, plans.Spec],
               prefix: str = "") -> Any:
    """Every leaf of ``full_tree`` placed by ``specs[prefix + path]``;
    0-d leaves, DTensors and leaves the specs do not name stay as they
    are."""
    leaves, paths = tree.flatten_with_paths(full_tree)
    out = []
    for x, p in zip(leaves, paths):
        spec = specs.get(prefix + p)
        keep = (spec is None or not isinstance(x, torch.Tensor)
                or x.dim() == 0 or is_dtensor(x))
        out.append(x if keep else place(x, mesh, spec))
    return tree.unflatten(full_tree, out)


def layer_placer(mesh, specs: Dict[str, plans.Spec]
                 ) -> Callable[[str, torch.Tensor], torch.Tensor]:
    """``(path of a stacked leaf, one layer's leaf) -> that layer's shard``
    laid out by the stacked spec without its layer dim (which the plan
    never splits): the ``place`` a sharded init hands the model's
    ``init`` (``common.stack_layers``), so each layer is cut to this
    rank's shards as it is drawn."""
    def fn(path: str, x: torch.Tensor) -> torch.Tensor:
        return place(x, mesh, specs[path][1:])
    return fn


def gather(dtree: Any) -> Any:
    """Every DTensor leaf as its full tensor (a collective: every rank
    calls it); other leaves as they are."""
    return tree.tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x,
                         dtree)


def local(x: Any) -> Any:
    """A DTensor's local shard (the same storage); anything else as is."""
    return x.to_local() if is_dtensor(x) else x


def distribute_batch(batch: Dict[str, torch.Tensor], mesh,
                     plan: plans.Plan) -> Dict[str, torch.Tensor]:
    """Each entry (the same on every rank) cut over the batch axes by
    ``plans.batch_spec``; replicated over ``model``."""
    return {k: place(v, mesh, plans.batch_spec(plan, v.shape[0],
                                               v.dim() - 1))
            for k, v in batch.items()}


def like_params(grads: Any, params: Any) -> Any:
    """Each DTensor gradient redistributed to its parameter's placements:
    a partial sum over the data axis becomes its reduce-scatter."""
    def one(g, p):
        if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
            return g.redistribute(p.device_mesh, p.placements)
        return g
    return tree.tree_map(one, grads, params)


def param_specs(params: Any, mesh, mode: str = "train",
                ) -> Dict[str, plans.Spec]:
    """The plan's spec of every leaf of ``params`` on ``mesh``."""
    return plans.param_shardings(plans.make_plan(grid(mesh), mode), params)


def state_specs(specs: Dict[str, plans.Spec]) -> Dict[str, plans.Spec]:
    """A train state's specs from its params' (``TrainState`` paths): the
    moments are laid out as the params; count and step are 0-d."""
    out = {}
    for p, s in specs.items():
        for prefix in (".params/", ".opt/.mu/", ".opt/.nu/"):
            out[prefix + p] = s
    return out


def placer(mesh, specs: Dict[str, plans.Spec]
           ) -> Callable[[str, torch.Tensor], torch.Tensor]:
    """``(path, full leaf) -> placed leaf`` by ``specs``: what
    ``checkpoint.restore`` applies to each leaf it reads."""
    def fn(path: str, x: torch.Tensor) -> torch.Tensor:
        spec: Optional[plans.Spec] = specs.get(path)
        if spec is None or x.dim() == 0:
            return x
        return place(x, mesh, spec)
    return fn
