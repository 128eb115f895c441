"""Parameters from the reference package to the port, through numpy.

The reference's parameter pytree (nested dicts and lists of arrays, plus
float table bounds) converts leaf by leaf: every array becomes a tensor on
``device`` with its dtype kept, every Python number stays a number. The
keys stay as they are (``embed``, ``fit``, ``dstd``, ``ebias``,
``table.nets``), so the port's model functions read the same paths.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


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
