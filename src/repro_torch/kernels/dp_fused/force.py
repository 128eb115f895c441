"""The force-and-virial reduction: per-slot gradients dE/dr_ij of a
neighbour list to per-atom forces and the 3x3 virial.

``prod_force_virial`` runs the CUDA kernel of ``csrc/prod_force_virial.cu``
on CUDA tensors and :func:`prod_force_virial_ref`, the plain version, on
CPU tensors. There is no fallback: on a CUDA tensor the wrapper launches the
kernel or raises. For centre ``a`` (row ``offset + a`` of the forces) and
each slot with ``j = nlist[a, n] >= 0``, -de acts on j, +de on the centre,
and the virial is W = -sum r_ij (x) de. Padded slots (-1) add nothing.

``force_launches`` counts kernel launches (not plain-path calls); a call
made while the current stream is being captured into a CUDA graph counts in
``force_captured`` instead, and the graph's owner adds what one replay
launches with :func:`count_replay` each time it replays the graph
(``md/stepper.py``, ``md/domain.py``), as ``ops.fwd_launches`` is kept.

The kernel is the ``torch.library`` custom op
``repro_torch::prod_force_virial``: a fake implementation (empty outputs of
the right shapes) lets a ``FakeTensorMode`` trace through it without
reaching ``nvcc`` or ``ctypes``, and its FLOP formula counts the virial's
products as the plain version's einsum did.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.dp_fused import build

# scratch rows of per-block virial partials; the kernel's grid is at most
# this many blocks (it walks the centres in a grid-stride loop)
MAX_BLOCKS = 4096

force_launches = 0
force_captured = 0
# launched from one thread per rank (md/comm.LocalComm): a count is a
# read-modify-write
_count_lock = threading.Lock()


def count_replay(n: int) -> None:
    """A replay of a graph that recorded ``n`` launches ran them."""
    global force_launches
    with _count_lock:
        force_launches += n


def _count() -> None:
    global force_launches, force_captured
    captured = torch.cuda.is_current_stream_capturing()
    with _count_lock:
        if captured:
            force_captured += 1
        else:
            force_launches += 1


def prod_force_virial_ref(de: torch.Tensor, rij: torch.Tensor,
                          nlist: torch.Tensor, rows: int, offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: mask, ``index_add_``, row sum, einsum. Padded
    slots add their zero into row 0."""
    de = de * (nlist >= 0)[..., None].to(de.dtype)
    j = torch.clamp(nlist, min=0).reshape(-1)
    f = torch.zeros((rows, 3), dtype=de.dtype, device=de.device)
    f.index_add_(0, j, -de.reshape(-1, 3))
    f[offset:offset + nlist.shape[0]] += de.sum(dim=1)
    virial = -torch.einsum("ijk,ijl->kl", rij, de)
    return f, virial


def _launch(de, rij, nlist, rows, offset):
    a, s = nlist.shape
    kl = build.load()
    # the kernel sums forces as float4 rows (one vector red a slot)
    f4 = torch.zeros((rows, 4), dtype=torch.float32, device=de.device)
    f = torch.empty((rows, 3), dtype=torch.float32, device=de.device)
    virial = torch.empty((3, 3), dtype=torch.float32, device=de.device)
    partial = torch.empty((MAX_BLOCKS, 9), dtype=torch.float32,
                          device=de.device)
    with torch.cuda.device(de.device):
        stream = torch.cuda.current_stream(de.device).cuda_stream
        code = kl.lib.prod_force_virial(
            de.data_ptr(), rij.data_ptr(), nlist.data_ptr(), f4.data_ptr(),
            f.data_ptr(), virial.data_ptr(), partial.data_ptr(), MAX_BLOCKS,
            a, s, rows, offset, stream)
    kl.check(code, "prod_force_virial launch")
    _count()
    return f, virial


@torch.library.custom_op(
    "repro_torch::prod_force_virial", mutates_args=(),
    schema="(Tensor de, Tensor rij, Tensor nlist, int rows, int offset) "
           "-> (Tensor, Tensor)")
def _op(de, rij, nlist, rows, offset):
    if de.device.type == "cpu":
        return prod_force_virial_ref(de, rij, nlist, rows, offset)
    return _launch(de, rij, nlist, rows, offset)


@_op.register_fake
def _(de, rij, nlist, rows, offset):
    return de.new_empty((rows, 3)), de.new_empty((3, 3))


@register_flop_formula(torch.ops.repro_torch.prod_force_virial)
def _flops(de_shape, rij_shape, nlist_shape, rows, offset, *args,
           out_shape=None, **kwargs) -> int:
    a, s = nlist_shape
    return 2 * 9 * a * s      # the einsum's 3 x 3 products over every slot


def _check(de, rij, nlist, rows, offset) -> None:
    if nlist.dim() != 2:
        raise ValueError(f"nlist must be (A, S); got {tuple(nlist.shape)}")
    a, s = nlist.shape
    dev = de.device
    for name, t, shape in (("de", de, (a, s, 3)), ("rij", rij, (a, s, 3)),
                           ("nlist", nlist, (a, s))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if not 0 <= offset <= rows - a:
        raise ValueError(f"centre rows [{offset}, {offset + a}) do not fit "
                         f"in {rows} rows")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"prod_force_virial runs on cuda or cpu tensors, "
                         f"not {dev}")
    for name, t, dtype in (("de", de, torch.float32),
                           ("rij", rij, torch.float32),
                           ("nlist", nlist, torch.int64)):
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def prod_force_virial(de: torch.Tensor, rij: torch.Tensor,
                      nlist: torch.Tensor, rows: int, offset: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forces (rows, 3) and virial (3, 3) from de = dE/dr_ij (A, S, 3),
    rij (A, S, 3) and nlist (A, S), -1 for padding; the centres are rows
    ``offset .. offset + A - 1``."""
    _check(de, rij, nlist, rows, offset)
    return torch.ops.repro_torch.prod_force_virial(de, rij, nlist, int(rows),
                                                   int(offset))
