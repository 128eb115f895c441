"""FLOPs, bytes and peak memory of a function, traced op by op: the
counterpart of ``repro.analysis.hlo_cost``.

The reference walks optimised XLA HLO text. The port runs eagerly and has
no HLO, so :func:`analyze_fn` runs the function itself, under
``torch.utils.flop_counter.FlopCounterMode`` and a dispatch mode of its own
that sees every aten op. Run it inside ``FakeTensorMode`` with fake
arguments and nothing is allocated or computed: the numbers are those of a
run at the same shapes (``launch/md_dryrun.py`` traces a paper-size rank
that way). Real tensors give the same numbers.

  flops          matmul-family FLOPs only (mm, bmm, addmm, einsum's
                 products, ...), the reference's dot-only convention, plus
                 the dp_fused kernels' own formula
                 (``kernels/dp_fused/ops.kernel_cost``), registered for the
                 custom ops; elementwise work is not counted.
  bytes_accessed every aten op's tensor inputs and outputs, since each one
                 is a pass over device memory when the port runs eagerly;
                 views (outputs that alias an input), bare allocations
                 (``empty``) and metadata queries count zero. This is NOT
                 the reference's count, whose "TPU-fusion proxy" gives
                 standalone elementwise ops zero bytes
                 (``hlo_cost.py:21-26``): the two byte counts have no
                 parity, and a byte term here is an eager run's.
  peak_bytes     the largest sum of live storage bytes over the trace, the
                 arguments included, autograd's saved tensors included (a
                 storage is live until its last tensor dies). It counts
                 what the dispatcher sees, plus the one scratch known to
                 matter: PyTorch's CUDA sort along a dimension longer than
                 4,096 (shorter ones sort in place) holds two int64 arrays
                 (index, segment) and a copy of the keys while it runs,
                 (16 + key size) bytes an element. Other allocations inside
                 a kernel call (a library's workspace) are not in it.
  coll_bytes     the collective buffer bytes by kind, from the counting
                 communicator (``md/comm.DryRunComm``) when one is passed.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.roofline import COLL_KINDS

_aten = torch.ops.aten
_SORTS = frozenset((_aten.sort.default, _aten.sort.stable))
# allocations that read nothing and write nothing yet
_NO_TRAFFIC = frozenset((_aten.empty.memory_format, _aten.empty_strided.default,
                         _aten.new_empty.default,
                         _aten.new_empty_strided.default))


@dataclasses.dataclass
class CostTotals:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLL_KINDS})
    peak_bytes: float = 0.0
    arg_bytes: float = 0.0          # the arguments' storages, live at entry
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll_bytes.values()))

    @property
    def temp_bytes(self) -> float:
        """Peak above the arguments."""
        return self.peak_bytes - self.arg_bytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sort_scratch(func, args, kwargs) -> int:
    """Bytes PyTorch's CUDA sort allocates inside the call: none for rows
    of at most 4,096 (an in-place sort); otherwise the segmented radix
    sort's int64 (index, segment) pairs and its key buffer."""
    x = args[0]
    dim = kwargs.get("dim", args[1] if func is _aten.sort.default
                     and len(args) > 1 else -1)
    if x.dim() == 0 or x.shape[dim] <= 4096:
        return 0
    return x.numel() * (16 + x.element_size())


class _LiveBytes(TorchDispatchMode):
    """Traffic and live storage bytes of every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.traffic = 0.0
        self._sizes: Dict[int, int] = {}

    def track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live until it dies; its bytes if new."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return 0
        n = int(st.nbytes())
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if func is not _aten.lift_fresh.default:
            # tensors made outside the dispatcher (from numpy, say) show up
            # first as inputs; lift_fresh's input is such a tensor's host
            # copy, which a fake run replaces by its output
            for t in ins:
                self.track(t)
        for t in outs:
            self.track(t)
        if func in _SORTS and ins[0].device.type == "cuda":
            self.peak = max(self.peak, self.live + _sort_scratch(
                func, args, kwargs))
        # metadata queries (``prim.device``, which a fake run dispatches)
        # return no tensor and move nothing
        if outs and not (func.is_view or func in _NO_TRAFFIC):
            self.traffic += sum(_nbytes(t) for t in ins + outs)
        return out


def analyze_fn(fn: Callable, *args: Any, comm: Optional[Any] = None
               ) -> CostTotals:
    """Run ``fn(*args)`` once and count its FLOPs, bytes and peak memory.

    Every tensor in ``args`` (any nesting of tuples, lists, dicts and named
    tuples) is live from the start. ``comm``: a communicator with a
    ``stats`` :class:`~repro_torch.analysis.roofline.CollectiveStats`, whose
    bytes by kind become ``coll_bytes``.
    """
    tracker = _LiveBytes()
    arg_bytes = sum(tracker.track(t) for t in pytree.tree_leaves(args)
                    if isinstance(t, torch.Tensor))
    counter = FlopCounterMode(display=False)
    with counter, tracker:
        fn(*args)
    by_op = {str(op): float(n)
             for op, n in counter.get_flop_counts().get("Global", {}).items()}
    totals = CostTotals(flops=float(counter.get_total_flops()),
                        bytes_accessed=tracker.traffic,
                        peak_bytes=float(tracker.peak),
                        arg_bytes=float(arg_bytes), flops_by_op=by_op)
    if comm is not None:
        totals.coll_bytes = dict(comm.stats.bytes_by_kind)
    return totals
