"""The training state (``repro.train.steps.TrainState``; the rest of that
module is the LM train step, which the port does not have)."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.train.optim import AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor       # 0-d int32
