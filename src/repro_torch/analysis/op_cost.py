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
                 custom ops; elementwise work is not counted. Also split
                 by the type of the product's inputs (``flops_by_dtype``).
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
                 communicator (``md/comm.DryRunComm``) when one is passed,
                 and from the functional collectives the trace issues (a
                 DTensor program's): all-gather counts its gathered
                 output, reduce-scatter its unscattered input, all-reduce
                 and all-to-all their buffer, so that the ring's wire
                 factor (``roofline._wire_factor``) of the count is what a
                 rank sends. (The reference counts an HLO collective's
                 result, which for a reduce-scatter is the scattered part.)

A DTensor program: a dispatch mode sees each DTensor op first, at global
shapes, and then, when it declines the op (returns ``NotImplemented``),
the local ops and the collectives that DTensor runs for it, at the rank's
shapes. The counter declines every op with a DTensor argument and counts
only what runs beneath, so every number is the rank's. Before the local
ops, DTensor may infer the output's global shape by running the op on fake
tensors it makes for the purpose (in the active fake mode, or its own);
those ops are not counted either: after a DTensor op, ops whose tensors
all come from such fresh allocations (no tensor inputs) are skipped until
the first op that reads a tensor of the program.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import flop_counter

from repro_torch.analysis.roofline import COLL_KINDS, _wire_factor

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
    # by the product's input type ("float32", "bfloat16", ...): the
    # roofline's compute term takes each at its own peak
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    coll_wire_ici: float = 0.0      # the functional collectives' wire bytes
    coll_wire_dcn: float = 0.0      # ... of groups that cross pods
    coll_count: int = 0

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


# functional collectives (``torch.ops._c10d_functional``), by op name: the
# roofline kind and whether the buffer is the output (else the input)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", True),
    "all_gather_into_tensor_coalesced": ("all-gather", True),
    "reduce_scatter_tensor": ("reduce-scatter", False),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", False),
    "all_reduce": ("all-reduce", False),
    "all_reduce_": ("all-reduce", False),
    "all_reduce_coalesced": ("all-reduce", False),
    "all_reduce_coalesced_": ("all-reduce", False),
    "all_to_all_single": ("all-to-all", False),
}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor as it is."""
    return getattr(t, "_local_tensor", t)


def _is_dtensor(t: Any) -> bool:
    return hasattr(t, "_local_tensor") and hasattr(t, "device_mesh")


class _Counter(TorchDispatchMode):
    """FLOPs, traffic, live storage bytes and collectives of every op
    dispatched under it, at the rank's shapes (module docstring)."""

    def __init__(self, ranks_per_pod: int = 0):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.traffic = 0.0
        self.flops: Dict[str, float] = {}
        self.flops_by_dtype: Dict[str, float] = {}
        self.coll = {k: 0.0 for k in COLL_KINDS}
        self.wire_ici = self.wire_dcn = 0.0
        self.coll_count = 0
        self.ranks_per_pod = ranks_per_pod
        self._sizes: Dict[int, int] = {}
        # after a DTensor op: the storages of its shape inference
        self._after_dtensor = False
        self._inferred: set = set()

    def _shape_inference(self, ins, outs) -> bool:
        """Whether an op belongs to DTensor's shape inference of the last
        DTensor op (module docstring); closes that window otherwise."""
        if not self._after_dtensor:
            return False
        if all(id(_local(t).untyped_storage()) in self._inferred
               for t in ins):
            self._inferred.update(id(t.untyped_storage()) for t in outs)
            return True
        self._after_dtensor = False
        self._inferred.clear()
        return False

    def track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live until it dies; its bytes if new."""
        st = _local(t).untyped_storage()
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

    def _collective(self, func, args, kwargs, ins, outs) -> None:
        kind, by_out = _COLLECTIVES[func._opname]
        nbytes = sum(_nbytes(t) for t in (outs if by_out else ins))
        group = _group_ranks(func, args, kwargs)
        wire = nbytes * _wire_factor(kind, len(group))
        pods = {r // self.ranks_per_pod for r in group} \
            if self.ranks_per_pod else {0}
        if len(pods) > 1:
            self.wire_dcn += wire
        else:
            self.wire_ici += wire
        self.coll[kind] += nbytes
        self.coll_count += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = pytree.tree_leaves((args, kwargs))
        if any(_is_dtensor(t) for t in flat):
            self._after_dtensor = True
            self._inferred.clear()
            return NotImplemented        # counted below, on the shards
        out = func(*args, **kwargs)
        ins = [t for t in flat if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if self._shape_inference(ins, outs):
            return out
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
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            if func._opname in _COLLECTIVES:
                self._collective(func, args, kwargs, ins, outs)
            return out
        if packet in flop_counter.flop_registry:
            n = flop_counter.flop_registry[packet](*args, **kwargs,
                                                   out_val=out)
            key = str(packet)
            self.flops[key] = self.flops.get(key, 0.0) + float(n)
            dt = next((str(t.dtype).removeprefix("torch.") for t in ins
                       if t.is_floating_point()), "float32")
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0.0) \
                + float(n)
        # metadata queries (``prim.device``, which a fake run dispatches)
        # return no tensor and move nothing
        if outs and not (func.is_view or func in _NO_TRAFFIC):
            self.traffic += sum(_nbytes(t) for t in ins + outs)
        return out


def _group_ranks(func, args, kwargs) -> list:
    """The global ranks of a functional collective's group (its
    ``group_name`` argument)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a.name for a in func._schema.arguments]
    name = kwargs.get("group_name", args[names.index("group_name")]
                      if "group_name" in names[:len(args)] else None)
    return dist.get_process_group_ranks(_resolve_process_group(name))


def analyze_fn(fn: Callable, *args: Any, comm: Optional[Any] = None,
               ranks_per_pod: int = 0) -> CostTotals:
    """Run ``fn(*args)`` once and count its FLOPs, bytes and peak memory.

    Every tensor in ``args`` (any nesting of tuples, lists, dicts and named
    tuples; a DTensor counts its local shard) is live from the start.
    ``comm``: a communicator with a ``stats``
    :class:`~repro_torch.analysis.roofline.CollectiveStats`, whose bytes by
    kind become ``coll_bytes``. Otherwise the functional collectives the
    trace issues are counted; ``ranks_per_pod``: the ranks of one pod (a
    collective whose group spans pods goes on the DCN term), 0 for one pod.
    """
    tensors = [t for t in pytree.tree_leaves(args)
               if isinstance(t, torch.Tensor)]
    counter = _Counter(ranks_per_pod)
    arg_bytes = sum(counter.track(t) for t in tensors)
    with counter:
        fn(*args)
    totals = CostTotals(flops=float(sum(counter.flops.values())),
                        bytes_accessed=counter.traffic,
                        peak_bytes=float(counter.peak),
                        arg_bytes=float(arg_bytes),
                        flops_by_op=dict(counter.flops),
                        flops_by_dtype=dict(counter.flops_by_dtype),
                        coll_bytes=dict(counter.coll),
                        coll_wire_ici=counter.wire_ici,
                        coll_wire_dcn=counter.wire_dcn,
                        coll_count=counter.coll_count)
    if comm is not None:
        totals.coll_bytes = dict(comm.stats.bytes_by_kind)
    return totals
