"""Parameters from the reference package to the port, through numpy.

The reference's parameter pytree (nested dicts and lists of arrays, plus
float table bounds) converts leaf by leaf: every array becomes a tensor on
``device`` with its dtype kept, every Python number stays a number. The
keys stay as they are (``embed``, ``fit``, ``dstd``, ``ebias``,
``table.nets``), so the port's model functions read the same paths.
``train_state_from_numpy`` converts a whole training state.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train.optim import AdamWState
from repro_torch.train.steps import TrainState


def params_from_numpy(tree: Any, device: DeviceLike = "cuda") -> Any:
    """Convert a parameter tree of numpy arrays to the port's dict of tensors.

    Anything numpy can read as an array counts as a leaf. A leaf with no
    dimensions (the table bounds ``lower``/``upper``, as numbers or as 0-d
    arrays) becomes a Python number; the model has no 0-d weights.
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
        return torch.from_numpy(arr).to(dev)

    return conv(tree)


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
