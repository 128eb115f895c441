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

Three implementations run the same per-rank code:

  LocalComm  all ranks in one process on one device, one thread per rank,
             each with its own CUDA stream on the card. Tensors change hands
             through a barrier mailbox: the sender records an event on its
             stream, the receiver waits on it and marks the tensor as used on
             its own stream (``record_stream``), so the allocator keeps it
             until the receiver is done. A rank that raises breaks the
             barrier, the others stop at their next collective, and ``run``
             raises the first rank's exception. ``run`` may be called while
             the caller's stream is being captured as a CUDA graph: every
             rank stream forks from that stream and joins it again, so the
             ranks' work, and the mailbox's events as edges between their
             streams, land in the one graph; the barrier then runs at
             capture time only (``md/domain.StaticSegment``).
  DistComm   one process per rank over ``torch.distributed``: NCCL with one
             card per rank, gloo on the CPU. ``ppermute`` is one
             ``batch_isend_irecv`` per call, waited on before it returns, with
             the call's tensors tagged by position; two calls that name the
             same peer (the plus and minus rings of a 2-brick axis) never mix.
             ``psum``/``pmax`` are ``all_reduce`` over the axis's subgroup.
             On NCCL every call may be recorded into a CUDA graph on the
             caller's stream (``md/domain.StaticSegment``): ProcessGroupNCCL
             runs it on its own stream forked from the caller's and joined
             back by the wait, and keeps recorded work from its watchdog.
             NCCL creates communicators and connects peers lazily, which a
             capture refuses, so a warm-up must issue every call of the
             captured code first. :meth:`DistComm.agree` runs over a gloo
             group of its own, so processes agree on a failed capture
             without touching NCCL state.

  DryRunComm one rank of a grid of any size, alone: ``ppermute`` gives the
             rank its own send buffers back (copies, as DistComm's receive
             buffers are new tensors), so every exchange has its real
             shapes; ``psum``/``pmax`` return (a copy of) their input. It
             counts every collective's bytes into a ``CollectiveStats``
             (``analysis/roofline.py``). ``launch/md_dryrun.py`` traces a
             production rank with it; with ``self_image=True`` it stands a
             single brick in for a periodic ring (its halo is its own far
             faces) for real runs of that rank on one card.

``run(fn)`` calls ``fn(rank)`` on every rank this process holds and returns
``{global rank: result}``; ``bricks`` lists the spatial indices held here.
``LocalComm`` and ``DistComm``, which can record graphs, also list those
ranks (``ranks``) and tell whether every process passed True to
``agree(ok)``.

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

from repro_torch.analysis import roofline
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
    #: True when ``ppermute`` hands a rank its own buffers back in place of
    #: its neighbours' (a single periodic brick): the halo and migration
    #: sweeps then shift what arrives by one brick width, as a ring of one
    #: brick would (``md/domain.py``)
    self_image = False
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

    @property
    def ranks(self) -> Tuple[int, ...]:
        return tuple(range(self.n_ranks))

    def agree(self, ok: bool) -> bool:
        return bool(ok)            # one process: nobody else to ask

    def run(self, fn: Callable[[RankComm], Any]) -> Dict[int, Any]:
        """``fn(rank)`` on every rank, each on its own thread; results by
        rank. Raises the first failing rank's exception."""
        n = self.n_ranks
        box = _Mailbox(n, self.timeout)
        results: List[Any] = [None] * n
        errors: List[Optional[BaseException]] = [None] * n
        main = fork = None
        if self._streams is not None:
            # every rank stream waits on this one event of the caller's
            # stream: under capture, that pulls the rank streams into it
            main = torch.cuda.current_stream(self.device)
            fork = main.record_event()

        def body(r: int) -> None:
            rank = _LocalRank(self, box, r)
            try:
                if main is None:
                    results[r] = fn(rank)
                    return
                stream = self._streams[r]
                with torch.cuda.device(self.device), torch.cuda.stream(stream):
                    stream.wait_event(fork)
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
        if main is not None:             # the join: every stream back
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
        self._agree_group = dist.new_group(backend="gloo") if nccl else None

    @property
    def bricks(self) -> Tuple[int, ...]:
        return (self.spatial_index,)

    @property
    def ranks(self) -> Tuple[int, ...]:
        return (self.rank,)

    def agree(self, ok: bool) -> bool:
        """Whether every process passed ``ok``: one all-reduce of a CPU
        flag over gloo, outside any NCCL communicator and any graph."""
        flag = torch.tensor([int(bool(ok))], dtype=torch.int32)
        self._dist.all_reduce(flag, op=self._dist.ReduceOp.MIN,
                              group=self._agree_group)
        return bool(flag.item())

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


# ----------------------------------------------------- one rank, counted

class DryRunComm(RankComm):
    """Rank ``(spatial_index, model_index)`` of an ``n_spatial x n_model``
    grid, run alone, counting its collectives.

    ``ppermute`` returns copies of the rank's own send buffers and
    ``psum``/``pmax`` a copy of their input: the shapes (and allocations)
    of a real exchange, not its values. ``stats`` sums each call's buffer
    bytes by kind (``collective-permute`` for ``ppermute``, ``all-reduce``
    for ``psum``/``pmax``) and its wire bytes, the buffer times
    ``roofline._wire_factor`` with the axis size as the group size. Wire
    bytes cross the pod axis (DCN) for a reduction over the spatial axis
    when that axis spans ``pods > 1`` pods, as the reference's HLO
    accounting finds; a ``ppermute`` counts inside the pod, since the
    reference's ``_group_crosses_pod`` never sees a collective-permute
    cross. A reduction over an axis of one rank moves nothing.
    """

    def __init__(self, n_spatial: int, n_model: int = 1,
                 spatial_index: int = 0, model_index: int = 0,
                 pods: int = 1, self_image: bool = False):
        self.n_spatial, self.n_model = int(n_spatial), int(n_model)
        if not (0 <= spatial_index < self.n_spatial
                and 0 <= model_index < self.n_model):
            raise ValueError(f"rank ({spatial_index}, {model_index}) is not "
                             f"on the {n_spatial} x {n_model} grid")
        if self.n_spatial % int(pods):
            raise ValueError(f"{pods} pods do not split {n_spatial} spatial "
                             f"ranks")
        self.spatial_index, self.model_index = spatial_index, model_index
        self.pods = int(pods)
        self.self_image = bool(self_image)
        self.stats = roofline.empty_stats()

    @property
    def bricks(self) -> Tuple[int, ...]:
        return (self.spatial_index,)

    def run(self, fn: Callable[[RankComm], Any]) -> Dict[int, Any]:
        return {self.rank: fn(self)}

    def _count(self, kind: str, nbytes: float, group: int,
               dcn: bool) -> None:
        st = self.stats
        st.bytes_by_kind[kind] += nbytes
        wire = nbytes * roofline._wire_factor(kind, group)
        if dcn:
            st.wire_bytes_dcn += wire
        else:
            st.wire_bytes_ici += wire
        st.count += 1

    def ppermute(self, xs, pairs):
        xs = tuple(xs)
        self._count("collective-permute",
                    sum(x.numel() * x.element_size() for x in xs),
                    self.n_spatial, False)
        return tuple(x.clone() for x in xs)

    def _reduce(self, x, axis):
        n = self.axis_size(_check_axis(axis))
        if n == 1:
            return x
        self._count("all-reduce", x.numel() * x.element_size(), n,
                    axis == SPATIAL and self.pods > 1)
        return x.clone()

    def psum(self, x, axis):
        return self._reduce(x, axis)

    def pmax(self, x, axis):
        return self._reduce(x, axis)
