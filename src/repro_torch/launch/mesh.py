"""The production rank grid as shapes only: the counterpart of
``repro.launch.mesh``.

The reference builds a ``jax`` device mesh. The port's ranks are the
``(spatial, model)`` grid of ``md/comm.py``, so a mesh here is a set of
named axis sizes with no devices behind it: the dry run
(``launch/md_dryrun.py``) traces one rank of it.

Axis semantics, as in the reference:
  pod   — crosses the boundary between pods (nodes joined by the network,
          not NVLink); only spatial reductions travel on it.
  data  — the spatial (brick) axis.
  model — the model axis: shards that split one brick's work.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """Named axis sizes of a rank grid (no devices)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> RankGrid:
    """16 x 16 ``(data, model)``, or 2 x 16 x 16 with ``pod`` in front."""
    if multi_pod:
        return RankGrid(("pod", "data", "model"), (2, 16, 16))
    return RankGrid(("data", "model"), (16, 16))


def make_local_mesh(model_axis: int = 1) -> Tuple[int, int]:
    """``(n_spatial, n_model)`` for the ranks present: the
    ``torch.distributed`` world size if a group is initialised, else 1."""
    import torch.distributed as dist

    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into model axis "
                         f"{model_axis}")
    return n // model_axis, model_axis


def batch_axes(mesh: RankGrid) -> tuple:
    """Axes that shard the batch / spatial dimension (pod first if any)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
