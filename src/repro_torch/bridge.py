"""Parameters from the reference package to the port, through numpy.

The reference's parameter pytree (nested dicts and lists of arrays, plus
float table bounds) converts leaf by leaf: every array becomes a tensor on
``device`` with its dtype kept, every Python number stays a number. The
keys stay as they are (``embed``, ``fit``, ``dstd``, ``ebias``,
``table.nets``; the LM zoo's ``blocks``, ``periods``, ``enc``, ``dec``), so
the port's model functions read the same paths. ``train_state_from_numpy``
converts a whole training state, ``cache_from_numpy`` an LM decode cache,
and ``to_numpy`` any tree of the port's back.

A bfloat16 leaf (numpy dtype ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses) crosses bit for bit: its bits are viewed as
``uint16`` and read back as ``torch.bfloat16``; ``to_numpy`` returns it as
float32, which holds every bfloat16 value exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.encdec import EncDecCache
from repro_torch.models.griffin import GriffinCache
from repro_torch.models.xlstm import MLSTMState, SLSTMState, XLSTMCache
from repro_torch.train.optim import AdamWState
from repro_torch.train.steps import TrainState

# the reference's cache NamedTuples, by class name, to the port's
_CACHE_TYPES = {cls.__name__: cls for cls in (
    KVCache, EncDecCache, GriffinCache, XLSTMCache, MLSTMState, SLSTMState)}


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tensor(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``dev``; bfloat16 bit for bit."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def params_from_numpy(tree: Any, device: DeviceLike = "cuda") -> Any:
    """Convert a parameter tree of numpy arrays to the port's dict of tensors.

    Anything numpy can read as an array counts as a leaf. A leaf with no
    dimensions (the table bounds ``lower``/``upper``, as numbers or as 0-d
    arrays) becomes a Python number; the models have no 0-d weights.
    """
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        arr = np.array(x)
        if arr.ndim == 0:           # table bounds: plain numbers
            return arr.item()
        return _tensor(arr, dev)

    return conv(tree)


def cache_from_numpy(cache: Any, device: DeviceLike = "cuda") -> Any:
    """The reference's LM decode cache (``KVCache``, ``GriffinCache``,
    ``XLSTMCache`` with its cell states, ``EncDecCache``), leaves as numpy,
    as the port's cache of the same name. Every leaf becomes a tensor, the
    0-d ``length`` too (decode reads it on the device)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if _is_namedtuple(x):
            return _CACHE_TYPES[type(x).__name__](*[conv(v) for v in x])
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _tensor(np.array(x), dev)

    return conv(cache)


def to_numpy(tree: Any) -> Any:
    """A tree of the port's tensors as numpy arrays, the same containers
    around them (a NamedTuple stays its class); bfloat16 leaves become
    float32 (exact)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[to_numpy(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def train_state_from_numpy(state: Any, device: DeviceLike = "cuda") -> Any:
    """The reference's ``TrainState(params, AdamWState(mu, nu, count),
    step)``, leaves as numpy, to the port's ``TrainState``.

    The parameters and both moments convert as ``params_from_numpy`` does;
    ``count`` and ``step`` stay 0-d ``int32`` tensors (the optimizer and
    the schedules compute with them on the device), where
    ``params_from_numpy`` would make Python numbers of them.
    """
    dev = resolve_device(device)

    def scalar(x):
        return torch.as_tensor(np.array(x, dtype=np.int32), device=dev)

    return TrainState(
        params=params_from_numpy(state.params, dev),
        opt=AdamWState(mu=params_from_numpy(state.opt.mu, dev),
                       nu=params_from_numpy(state.opt.nu, dev),
                       count=scalar(state.opt.count)),
        step=scalar(state.step))
