"""Roofline analysis of one rank's traced work: FLOPs, bytes and peak
memory from ``op_cost.analyze_fn``, collective bytes from the counting
communicator, three terms against the hardware.

The reference exports ``parse_collective_bytes`` (collectives parsed out of
HLO text) and ``analyze_compiled`` (an XLA artifact to a report). Their
counterparts here are ``md/comm.DryRunComm``, which counts each
``ppermute``/``psum``/``pmax`` as the step calls it, and
``roofline.make_report``.
"""

from repro_torch.analysis.op_cost import CostTotals, analyze_fn
from repro_torch.analysis.roofline import (
    HW_H100,
    HW_V5E,
    CollectiveStats,
    Hardware,
    RooflineReport,
    make_report,
)

__all__ = ["HW_H100", "HW_V5E", "CollectiveStats", "CostTotals", "Hardware",
           "RooflineReport", "analyze_fn", "make_report"]
