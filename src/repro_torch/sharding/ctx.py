"""Activation-sharding annotations for the zoo: the counterpart of
``repro.sharding.ctx``.

Models annotate activations with *logical roles*; a context installed by
the launcher maps roles to mesh axes:

    batch -> ("pod","data")   heads/vocab/ff/expert -> "model"
    seq   -> "model" only when sequence-sharding is enabled (decode cache)

The reference's ``with_sharding_constraint`` becomes a DTensor
``redistribute`` to the role's placements, of the value and of its
gradient. ``constrain`` is the identity outside any context and on a
tensor that is not a DTensor, so single-device runs (and every model call
on plain tensors) do not change. ``local``, ``local_weight``, ``wrap`` and
``sum_grad`` carry a computation that each rank runs on its own shards
(attention, the expert dispatch, the recurrences) out of DTensor and back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.sharding.plans import placements

Role = Union[str, None]

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class ActivationRules:
    mesh: Any                        # .shape {axis: size} (a RankGrid)
    batch_axes: Tuple[str, ...]
    model_axis: str = "model"
    shard_seq: bool = False          # sequence-sharded activations (SP)

    def axis_for(self, role: Role, dim: int):
        if role is None:
            return None
        if role == "batch":
            n = 1
            for a in self.batch_axes:
                n *= self.mesh.shape[a]
            if dim % n == 0:
                return self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]
            if "data" in self.batch_axes and dim % self.mesh.shape["data"] == 0:
                return "data"
            return None
        if role in ("heads", "vocab", "ff", "expert", "model"):
            return self.model_axis if dim % self.mesh.shape[self.model_axis] == 0 else None
        if role == "batch_full":
            # batch over ALL axes (data + model): attention when the head
            # count does not divide the model axis (llava: 56 % 16)
            axes = self.batch_axes + (self.model_axis,)
            n = 1
            for a in axes:
                n *= self.mesh.shape[a]
            if dim % n == 0:
                return axes
            return self.axis_for("batch", dim)
        if role == "seq":
            if not self.shard_seq:
                return None
            return self.model_axis if dim % self.mesh.shape[self.model_axis] == 0 else None
        raise ValueError(f"unknown activation role {role!r}")

    def spec(self, shape, roles) -> tuple:
        """The spec of a value of ``shape`` whose dims play ``roles``; an
        axis is used once, by the first dim that asks for it."""
        if len(roles) != len(shape):
            raise ValueError(f"{len(roles)} roles for rank-{len(shape)} value")
        axes = []
        used = set()
        for role, dim in zip(roles, shape):
            a = self.axis_for(role, dim)
            names = (a,) if isinstance(a, str) else (a or ())
            if any(n in used for n in names):
                a = None
            else:
                used.update(names)
            axes.append(a)
        return tuple(axes)


def current() -> Optional[ActivationRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def activation_rules(rules: Optional[ActivationRules]):
    prev = current()
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *roles: Role, grad: bool = True
              ) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the placements of its dims'
    logical roles, and its gradient too as it arrives in the backward pass
    (as ``with_sharding_constraint`` constrains the cotangent: left to
    DTensor, a gradient is laid out as its ops choose, and a residual's
    split over the sequence makes a later product fail to place; with
    ``grad=False`` it is left so); identity when no rules are installed or
    ``x`` is a plain tensor."""
    rules = current()
    if rules is None or not is_dtensor(x):
        return x
    want = placements(rules.spec(x.shape, roles), x.device_mesh)
    src = tuple(x.placements)
    if src != want:
        x = x.redistribute(x.device_mesh, want)
    if grad and x.requires_grad and torch.is_grad_enabled():
        x = _GradTo.apply(x, want, src)
    return x


class _GradTo(torch.autograd.Function):
    """The identity, whose backward redistributes the gradient to ``want``
    (the cotangent half of ``constrain``), except where it is a partial sum
    on a mesh dim that split the forward's input ``src``: that goes
    straight back to the input's split, a reduce-scatter (summed whole and
    then sliced by the forward redistribute's backward, it would move twice
    the bytes: XLA fuses that all-reduce and slice into a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, want, src):
        ctx.want, ctx.src = want, src
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        want = tuple(s if p.is_partial() and s.is_shard() else w
                     for p, w, s in zip(g.placements, ctx.want, ctx.src))
        if tuple(g.placements) != want:
            g = g.redistribute(g.device_mesh, want)
        return g, None, None


def like(ref: torch.Tensor, t: torch.Tensor, *roles: Role) -> torch.Tensor:
    """``t``, a plain tensor that holds the same values on every rank (a
    mask, positions), as a DTensor on ``ref``'s mesh when ``ref`` is one:
    replicated, then cut to ``roles`` (a local slice, no communication).
    Plain ``t`` otherwise, so single-device code does not change."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    out = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return constrain(out, *roles) if roles else out


def along(ref: torch.Tensor, dim: int, t: torch.Tensor) -> torch.Tensor:
    """The 1-D plain ``t`` (the same on every rank, of ``ref.shape[dim]``)
    as a DTensor split as ``ref``'s dim ``dim`` is (a local slice)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dim = dim % ref.dim()
    mesh = ref.device_mesh
    want = [Shard(0) if isinstance(p, Shard) and p.dim == dim else Replicate()
            for p in ref.placements]
    out = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return out.redistribute(mesh, want)


def zeros(ref: torch.Tensor, shape, dtype, *roles: Role) -> torch.Tensor:
    """Zeros of ``shape``: a plain tensor on ``ref``'s device, or, when
    ``ref`` is a DTensor, a DTensor laid out by ``roles`` of which only the
    local shard is allocated."""
    if not is_dtensor(ref):
        return torch.zeros(shape, dtype=dtype, device=ref.device)
    return zeros_placed(shape, dtype, ref.device_mesh,
                        placements(current().spec(shape, roles),
                                   ref.device_mesh))


def zeros_placed(shape, dtype, mesh, pl) -> torch.Tensor:
    """A DTensor of zeros of global ``shape`` with placements ``pl`` on
    ``mesh``: only the local shard is allocated (the split as
    ``torch.chunk`` makes it)."""
    from torch.distributed.tensor import DTensor, Shard

    coord = mesh.get_coordinate()
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            chunk = -(-local[p.dim] // mesh.size(i))
            local[p.dim] = max(0, min(chunk, local[p.dim] - coord[i] * chunk))
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=mesh.device_type), mesh, pl,
        run_check=False)


def split_dims(x: torch.Tensor) -> Tuple[int, ...]:
    """The mesh dims that split the DTensor ``x`` (over any tensor dim)."""
    from torch.distributed.tensor import Shard

    return tuple(i for i, p in enumerate(x.placements)
                 if isinstance(p, Shard))


def local(x: torch.Tensor, partial: Tuple[int, ...] = ()) -> torch.Tensor:
    """The DTensor ``x``'s local shard, for a computation each rank runs on
    its own shards. Its gradient is laid out as ``x``, except on the mesh
    dims ``partial`` (on which ``x`` is replicated): there each rank's
    gradient is its part of a sum, because the ranks along such a dim use
    ``x`` for different work (other batch rows, other experts); the
    partial sum travels on (a weight's is reduce-scattered into its layout
    at the end; :func:`sum_grad` completes one at once)."""
    from torch.distributed.tensor import Partial, Replicate

    grad = []
    for i, p in enumerate(x.placements):
        if i in partial:
            if not isinstance(p, Replicate):
                raise ValueError(f"a partial-sum gradient over mesh dim {i} "
                                 f"of a value split there: {x.placements}")
            p = Partial()
        grad.append(p)
    return _ContiguousGrad.apply(x.to_local(grad_placements=grad))


def sum_grad(t: torch.Tensor, ref: torch.Tensor,
             dims: Tuple[int, ...]) -> torch.Tensor:
    """The plain ``t`` (laid out as a local shard of the DTensor ``ref``),
    whose gradient is completed as it leaves: each rank's gradient is its
    part of a sum over the mesh dims ``dims``, which the backward sums (an
    all-reduce) to the gradient of a value laid out as ``ref``."""
    from torch.distributed.tensor import Partial

    if not dims:
        return t
    partial = tuple(Partial() if i in dims else p
                    for i, p in enumerate(ref.placements))
    return _SumGrad.apply(t, ref.device_mesh, partial, tuple(ref.placements))


class _SumGrad(torch.autograd.Function):
    """The identity, whose backward completes the local gradient's partial
    sums: laid out as ``partial``, redistributed to ``whole``."""

    @staticmethod
    def forward(ctx, x, mesh, partial, whole):
        ctx.mesh, ctx.partial, ctx.whole = mesh, partial, whole
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        g = DTensor.from_local(g.contiguous(), ctx.mesh, ctx.partial,
                               run_check=False)
        return g.redistribute(ctx.mesh, ctx.whole).to_local(), None, None, \
            None


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: DTensor
    runs the backward of a reshape before the local computation as a view
    of the local gradient, which a transposed one cannot take."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_weight(w: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """The DTensor weight ``w``'s local shard for a computation on the
    DTensor ``act``'s local shard: its gradient a partial sum over the mesh
    dims that split ``act`` but not ``w`` (other rows, the same weights)."""
    mine = split_dims(w)
    return local(w, tuple(i for i in split_dims(act) if i not in mine))


def wrap(t: torch.Tensor, ref: torch.Tensor, partial: Tuple[int, ...] = (),
         dims: Optional[dict] = None) -> torch.Tensor:
    """The local ``t`` as a DTensor laid out as the DTensor ``ref`` (the
    shard each rank computed from its shards of ``ref``'s layout), a
    partial sum over the mesh dims ``partial``; ``dims`` maps a split dim
    of ``ref`` to the dim of ``t`` that holds it (the same dim if absent).
    Its backward hands each rank the gradient of its shard, laid out so."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    pl = []
    for i, p in enumerate(ref.placements):
        if i in partial:
            p = Partial()
        elif isinstance(p, Shard) and dims and p.dim in dims:
            p = Shard(dims[p.dim])
        pl.append(p)
    return DTensor.from_local(t, ref.device_mesh, pl, run_check=False)


def local_range(x: torch.Tensor, dim: int):
    """(offset, size) of this rank's part of the DTensor ``x`` along
    ``dim``: the mesh dims that split it, in order, as ``torch.chunk``
    splits."""
    from torch.distributed.tensor import Shard

    coord = x.device_mesh.get_coordinate()
    off, size = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-size // x.device_mesh.size(i))
            off += coord[i] * chunk
            size = max(0, min(chunk, size - coord[i] * chunk))
    return off, size
