"""Sharding over ``torch.distributed``: the plan's per-leaf specs and
activation rules (the counterparts of ``repro.sharding``), and the trees of
DTensors they lay out (``state``)."""

from repro_torch.sharding.plans import (
    Plan,
    make_plan,
    param_shardings,
    placements,
    spec_for_param,
)

__all__ = ["Plan", "make_plan", "param_shardings", "placements",
           "spec_for_param"]
