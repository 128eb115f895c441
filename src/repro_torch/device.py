"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    The default is the card. Without CUDA this raises unless the caller asked
    for the CPU explicitly, so a missing card never turns into a silent CPU
    run. On the card, TF32 is switched off for matmuls and cuDNN: the fitting
    net's products (descriptor width 2048 -> 240) stay full FP32, as the
    reference computes them.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu; "
                         "meta for shapes only)")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
