"""Roofline terms of one rank's step: the counterpart of
``repro.analysis.roofline``.

    compute term    = FLOPs / peak FLOP/s                 [s, per card]
                      (with FLOPs split by the products' input type, each
                      type's at its own peak: :func:`peak_for`)
    memory term     = bytes / HBM bandwidth               [s, per card]
    collective term = collective wire bytes / link rate   [s, per card]

The reference reads FLOPs and bytes from compiled XLA artifacts and parses
the collectives out of HLO text (``parse_collective_bytes``,
``collectives_from_cost``). The port has neither: its FLOPs, bytes and peak
memory come from a trace of the rank's step (``analysis/op_cost.py``), and
its collective bytes from the counting communicator
(``md/comm.DryRunComm``), which fills a :class:`CollectiveStats` as the
step calls ``ppermute``/``psum``/``pmax``. What is shared is plain
arithmetic and is copied here as it is: :class:`Hardware`,
:class:`CollectiveStats`, :class:`RooflineReport` and :func:`_wire_factor`.

Wire factors per collective kind: all-reduce 2(N-1)/N of its buffer, ring
all-gather / reduce-scatter / all-to-all (N-1)/N, collective-permute 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # per card: FP32 products on the H100 (the
                               # MD port's type), bf16 on the TPU entry
    hbm_bw: float              # bytes/s per card
    ici_bw: float              # bytes/s per link inside a node / pod
    dcn_bw: float              # bytes/s per card across nodes / pods
    hbm_bytes: float           # device memory per card


# The reference's TPU entry, kept only to hold the port's arithmetic against
# the reference's in the parity tests; no port number is taken against it.
HW_V5E = Hardware(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                  ici_bw=50e9, dcn_bw=25e9, hbm_bytes=16 * 2**30)

# NVIDIA H100 SXM5 80GB data sheet: FP32 (the port runs with TF32 off, so
# every f32 product is FP32) 67 TFLOP/s; bf16 and fp16 989 TFLOP/s dense;
# HBM3 3.35 TB/s and 80 GB; NVLink 4 900 GB/s both directions, 450e9 per
# direction; one NDR InfiniBand NIC a card, 400 Gb/s = 50e9 B/s. On a card,
# :func:`h100` replaces the data sheet's 80 GB with what the card reports
# (``torch.cuda.get_device_properties(0).total_memory``).
HW_H100 = Hardware(name="nvidia-h100-sxm", peak_flops=67e12, hbm_bw=3.35e12,
                   ici_bw=450e9, dcn_bw=50e9, hbm_bytes=80e9)

# bf16 / fp16 dense peaks by hardware name where they differ from
# ``peak_flops`` (the H100's tensor cores; the TPU entry's peak is bf16's)
PEAK_FLOPS_16 = {HW_H100.name: 989e12}


def peak_for(hw: Hardware, dtype: str) -> float:
    """``hw``'s peak for products whose inputs are of ``dtype`` (a name:
    "float32", "bfloat16", ...)."""
    if dtype in ("bfloat16", "float16"):
        return PEAK_FLOPS_16.get(hw.name, hw.peak_flops)
    return hw.peak_flops


def h100(device=None) -> Hardware:
    """``HW_H100`` with ``hbm_bytes`` read from the card when one is present
    (the figure a roofline row's ``fits`` keys are held against)."""
    import torch

    if not torch.cuda.is_available():
        return HW_H100
    total = torch.cuda.get_device_properties(
        0 if device is None else device).total_memory
    return dataclasses.replace(HW_H100, hbm_bytes=float(total))


COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    wire_bytes_ici: float        # per-card wire bytes inside a pod
    wire_bytes_dcn: float        # per-card wire bytes crossing the pod axis
    count: int

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))


def empty_stats() -> CollectiveStats:
    return CollectiveStats({k: 0.0 for k in COLL_KINDS}, 0.0, 0.0, 0)


@dataclasses.dataclass
class RooflineReport:
    name: str
    n_chips: int
    hlo_flops: float             # per card (the name is the reference's)
    hlo_bytes: float             # per card
    collectives: CollectiveStats
    model_flops: float           # useful FLOPs of the whole step, global
    t_compute: float
    t_memory: float
    t_ici: float
    t_dcn: float
    peak_mem_bytes: float
    hw: Hardware

    @property
    def t_collective(self) -> float:
        return self.t_ici + self.t_dcn

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs x cards): redundancy waste catch."""
        total = self.hlo_flops * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Compute-term share of the step's critical path (1.0 = compute
        bound at peak)."""
        bt = self.bound_time
        return self.t_compute / bt if bt > 0 else 0.0

    def fits_hbm(self) -> bool:
        return self.peak_mem_bytes <= self.hw.hbm_bytes

    def row(self) -> Dict[str, object]:
        """The reference's row keys. ``fits_16GiB`` keeps its name, which
        ``benchmarks/table1_tts.py`` reads, but is held against the
        hardware's own ``hbm_bytes``: on the H100 it means "fits the card",
        as ``fits_hbm`` beside it says."""
        return {
            "name": self.name, "chips": self.n_chips,
            "flops/chip": self.hlo_flops, "bytes/chip": self.hlo_bytes,
            "coll_bytes/chip": self.collectives.total_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_ici": self.t_ici, "t_dcn": self.t_dcn,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "mem_GiB": self.peak_mem_bytes / 2**30,
            "fits_16GiB": self.fits_hbm(),
            "fits_hbm": self.fits_hbm(),
        }


def _wire_factor(op: str, n: int) -> float:
    n = max(n, 2)
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op in ("all-gather", "reduce-scatter", "all-to-all"):
        return (n - 1) / n
    return 1.0   # collective-permute


def make_report(name: str, n_chips: int, flops: float, byts: float,
                stats: CollectiveStats, model_flops: float,
                peak_bytes: float, hw: Hardware = HW_H100,
                flops_by_dtype: Optional[Dict[str, float]] = None,
                ) -> RooflineReport:
    """The report of one rank's traced work against ``hw`` (the port's
    counterpart of the reference's ``analyze_compiled``). The compute term
    is ``flops`` at ``hw.peak_flops``, or, given ``flops_by_dtype`` (which
    sums to ``flops``), each type's FLOPs at its own peak."""
    t_compute = (flops / hw.peak_flops if flops_by_dtype is None else
                 sum(f / peak_for(hw, d) for d, f in flops_by_dtype.items()))
    return RooflineReport(
        name=name, n_chips=n_chips, hlo_flops=flops, hlo_bytes=byts,
        collectives=stats, model_flops=model_flops,
        t_compute=t_compute, t_memory=byts / hw.hbm_bw,
        t_ici=stats.wire_bytes_ici / hw.ici_bw,
        t_dcn=stats.wire_bytes_dcn / hw.dcn_bw,
        peak_mem_bytes=peak_bytes, hw=hw)
