"""Collectives over a (spatial, model) grid of ranks: the port's counterpart of
what ``shard_map`` gives the reference's distributed MD.

The reference runs its per-brick step inside ``shard_map`` over a mesh with a
spatial axis (one brick per index) and a model axis (shards that split the
neighbor slots or the atoms of one brick), and talks through
``jax.lax.axis_index``/``ppermute``/``psum``/``pmax``. Here a rank is one
(spatial, model) pair, flattened in C order (``rank = s * n_model + m``, the
order of the reference's ``("data", "model")`` mesh), and every rank handle
offers the same operations with ``jax.lax``'s semantics:

  axis_index(axis)     the rank's index along ``SPATIAL`` or ``MODEL``
  ppermute(xs, pairs)  over the spatial axis, within one model index:
                       ``(i, j)`` delivers spatial rank i's tensors ``xs`` to
                       spatial rank j; a rank that receives nothing gets zeros
  psum(x, axis)        the sum over one axis; every rank of the axis gets the
                       same tensor. ``pmax`` likewise.

Two implementations run the same per-rank code:

  LocalComm  all ranks in one process on one device, one thread per rank,
             each with its own CUDA stream on the card. Tensors change hands
             through a barrier mailbox: the sender records an event on its
             stream, the receiver waits on it and marks the tensor as used on
             its own stream (``record_stream``), so the allocator keeps it
             until the receiver is done. A rank that raises breaks the
             barrier, the others stop at their next collective, and ``run``
             raises the first rank's exception.
  DistComm   one process per rank over ``torch.distributed``: NCCL with one
             card per rank, gloo on the CPU. ``ppermute`` is one
             ``batch_isend_irecv`` per call, waited on before it returns, with
             the call's tensors tagged by position; two calls that name the
             same peer (the plus and minus rings of a 2-brick axis) never mix.
             ``psum``/``pmax`` are ``all_reduce`` over the axis's subgroup.

``run(fn)`` calls ``fn(rank)`` on every rank this process holds and returns
``{global rank: result}``; ``bricks`` lists the spatial indices held here.

No collective may run inside a backward pass: the autograd engine runs a
card's backward on one worker thread, where threads that share the card would
wait on each other's barrier forever. :meth:`RankComm.psum_same_grad` is the
reduction for forward passes that autograd differentiates: its backward is
the identity (every shard's loss after the sum is the same function of the
sum, so each shard's cotangent is the sum's).
"""

from __future__ import annotations

import abc
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

SPATIAL = "spatial"
MODEL = "model"
Pairs = Sequence[Tuple[int, int]]


class _PsumSameGrad(torch.autograd.Function):
    """``psum`` forward, identity backward (no collective in the backward)."""

    @staticmethod
    def forward(ctx, x, comm, axis):
        return comm.psum(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class RankComm(abc.ABC):
    """What one rank sees: its indices along both axes and the collectives.

    Subclasses set ``n_spatial``, ``n_model``, ``spatial_index`` and
    ``model_index``.
    """

    SPATIAL = SPATIAL
    MODEL = MODEL
    n_spatial: int
    n_model: int
    spatial_index: int
    model_index: int

    @property
    def rank(self) -> int:
        return self.spatial_index * self.n_model + self.model_index

    def axis_index(self, axis: str) -> int:
        return self.spatial_index if _check_axis(axis) == SPATIAL \
            else self.model_index

    def axis_size(self, axis: str) -> int:
        return self.n_spatial if _check_axis(axis) == SPATIAL \
            else self.n_model

    def psum_same_grad(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``psum`` whose backward passes the cotangent through unchanged."""
        if self.axis_size(axis) == 1:
            return x
        return _PsumSameGrad.apply(x, self, axis)

    @abc.abstractmethod
    def ppermute(self, xs: Sequence[torch.Tensor],
                 pairs: Pairs) -> Tuple[torch.Tensor, ...]:
        """Deliver ``xs`` along ``pairs`` (spatial ranks); zeros if none."""

    @abc.abstractmethod
    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``x`` over ``axis``, the same on every rank of it."""

    @abc.abstractmethod
    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The elementwise maximum of ``x`` over ``axis``."""


def _check_axis(axis: str) -> str:
    if axis not in (SPATIAL, MODEL):
        raise ValueError(f"axis must be {SPATIAL!r} or {MODEL!r}, got {axis!r}")
    return axis


def _peers(pairs: Pairs, me: int) -> Tuple[Optional[int], Optional[int]]:
    """(destination, source) of spatial rank ``me`` in a permutation."""
    dst = [d for s, d in pairs if s == me]
    src = [s for s, d in pairs if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute pairs are not a permutation: {pairs}")
    return (dst[0] if dst else None), (src[0] if src else None)


# ------------------------------------------------------------ one process

class _Mailbox:
    """Slots for one tensor bundle per rank, behind a two-phase barrier."""

    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots: List[Any] = [None] * n

    def exchange(self, rank: int, item: Any) -> List[Any]:
        self.slots[rank] = item
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()      # nobody refills a slot before all have read
        return got


class _LocalRank(RankComm):
    def __init__(self, group: "LocalComm", box: _Mailbox, rank: int):
        self.n_spatial, self.n_model = group.n_spatial, group.n_model
        self.spatial_index, self.model_index = divmod(rank, group.n_model)
        self._box = box
        self._cuda = group.device.type == "cuda"

    def _exchange(self, tensors: Tuple[torch.Tensor, ...]) -> List[Any]:
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream())
        return self._box.exchange(self.rank, (tensors, event))

    def _take(self, item) -> Tuple[torch.Tensor, ...]:
        tensors, event = item
        if self._cuda:
            stream = torch.cuda.current_stream()
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
        return tensors

    def ppermute(self, xs, pairs):
        xs = tuple(xs)
        got = self._exchange(xs)
        _, src = _peers(pairs, self.spatial_index)
        if src is None:
            return tuple(torch.zeros_like(x) for x in xs)
        return self._take(got[src * self.n_model + self.model_index])

    def _reduce(self, x, axis, op):
        if self.axis_size(axis) == 1:
            return x
        got = self._exchange((x,))
        if axis == SPATIAL:
            ranks = [s * self.n_model + self.model_index
                     for s in range(self.n_spatial)]
        else:
            ranks = [self.spatial_index * self.n_model + m
                     for m in range(self.n_model)]
        out = None
        for r in ranks:                  # the same order on every rank
            (t,) = self._take(got[r])
            out = t if out is None else op(out, t)
        return out

    def psum(self, x, axis):
        return self._reduce(x, _check_axis(axis), torch.add)

    def pmax(self, x, axis):
        return self._reduce(x, _check_axis(axis), torch.maximum)


def _tensors_of(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors_of(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors_of(v)


class LocalComm:
    """``n_spatial * n_model`` ranks in this process, one thread each, all on
    ``device`` (one CUDA stream per rank on the card)."""

    def __init__(self, n_spatial: int, n_model: int = 1,
                 device: DeviceLike = "cuda", timeout: float = 900.0):
        self.n_spatial, self.n_model = int(n_spatial), int(n_model)
        if self.n_spatial < 1 or self.n_model < 1:
            raise ValueError(f"bad rank grid {n_spatial} x {n_model}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.timeout = float(timeout)
        self._streams = ([torch.cuda.Stream(self.device)
                          for _ in range(self.n_ranks)]
                         if self.device.type == "cuda" else None)

    @property
    def n_ranks(self) -> int:
        return self.n_spatial * self.n_model

    @property
    def bricks(self) -> Tuple[int, ...]:
        return tuple(range(self.n_spatial))

    def run(self, fn: Callable[[RankComm], Any]) -> Dict[int, Any]:
        """``fn(rank)`` on every rank, each on its own thread; results by
        rank. Raises the first failing rank's exception."""
        n = self.n_ranks
        box = _Mailbox(n, self.timeout)
        results: List[Any] = [None] * n
        errors: List[Optional[BaseException]] = [None] * n
        main = (torch.cuda.current_stream(self.device)
                if self._streams is not None else None)

        def body(r: int) -> None:
            rank = _LocalRank(self, box, r)
            try:
                if main is None:
                    results[r] = fn(rank)
                    return
                stream = self._streams[r]
                with torch.cuda.device(self.device), torch.cuda.stream(stream):
                    stream.wait_stream(main)
                    out = fn(rank)
                    for t in _tensors_of(out):   # the caller reads on `main`
                        if t.is_cuda:
                            t.record_stream(main)
                results[r] = out
            except BaseException as e:          # re-raised by run() below
                errors[r] = e
                box.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,), name=f"rank{r}",
                                    daemon=True) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2 * self.timeout)
        if main is not None:
            for s in self._streams:
                main.wait_stream(s)
        hung = [t.name for t in threads if t.is_alive()]
        if hung:
            raise RuntimeError(f"ranks {hung} did not finish")
        first = next((e for e in errors if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return dict(enumerate(results))


# --------------------------------------------------- one process per rank

class DistComm(RankComm):
    """This process's rank of an initialised ``torch.distributed`` group of
    ``n_spatial * n_model`` processes (NCCL: one card each; gloo: CPU)."""

    def __init__(self, n_spatial: int, n_model: int = 1):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistComm needs torch.distributed."
                               "init_process_group first")
        self.n_spatial, self.n_model = int(n_spatial), int(n_model)
        world = dist.get_world_size()
        if world != self.n_spatial * self.n_model:
            raise ValueError(f"world size {world} != {n_spatial} x {n_model}")
        self.spatial_index, self.model_index = divmod(dist.get_rank(),
                                                      self.n_model)
        self._dist = dist
        nccl = dist.get_backend() == "nccl"
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if nccl else torch.device("cpu"))
        # every process creates every subgroup, in the same order; an axis
        # of one rank needs none, an axis spanning the world is the world
        self._groups: Dict[str, Any] = {SPATIAL: None, MODEL: None}
        if self.n_model > 1 and self.n_spatial > 1:
            for s in range(self.n_spatial):
                g = dist.new_group([s * self.n_model + m
                                    for m in range(self.n_model)])
                if s == self.spatial_index:
                    self._groups[MODEL] = g
            for m in range(self.n_model):
                g = dist.new_group([s * self.n_model + m
                                    for s in range(self.n_spatial)])
                if m == self.model_index:
                    self._groups[SPATIAL] = g

    @property
    def bricks(self) -> Tuple[int, ...]:
        return (self.spatial_index,)

    def run(self, fn: Callable[[RankComm], Any]) -> Dict[int, Any]:
        return {self.rank: fn(self)}

    def ppermute(self, xs, pairs):
        dist = self._dist
        xs = tuple(xs)
        dst, src = _peers(pairs, self.spatial_index)
        ops, bufs = [], []
        for tag, x in enumerate(xs):
            wire = x.to(torch.uint8) if x.dtype == torch.bool else x
            wire = wire.contiguous()
            buf = torch.zeros_like(wire)
            bufs.append(buf)
            if dst is not None:
                ops.append(dist.P2POp(dist.isend, wire,
                                      dst * self.n_model + self.model_index,
                                      tag=tag))
            if src is not None:
                ops.append(dist.P2POp(dist.irecv, buf,
                                      src * self.n_model + self.model_index,
                                      tag=tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return tuple(b.to(torch.bool) if x.dtype == torch.bool else b
                     for b, x in zip(bufs, xs))

    def _reduce(self, x, axis, op):
        if self.axis_size(axis) == 1:
            return x
        out = x.clone()
        self._dist.all_reduce(out, op=op, group=self._groups[axis])
        return out

    def psum(self, x, axis):
        return self._reduce(x, _check_axis(axis), self._dist.ReduceOp.SUM)

    def pmax(self, x, axis):
        return self._reduce(x, _check_axis(axis), self._dist.ReduceOp.MAX)
