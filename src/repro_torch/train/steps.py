"""Step builders (``repro.train.steps``): the training state, and the
serving step of the LM zoo. The LM train step comes with the LM training
port."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.zoo import ModelAPI
from repro_torch.train.optim import AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor       # 0-d int32


def make_serve_step(api: ModelAPI) -> Callable:
    """One-token decode step: (params, tokens (B,1), cache) -> (logits,
    cache), under ``torch.inference_mode``."""

    @torch.inference_mode()
    def serve_step(params, tokens, cache):
        return api.decode_step(params, tokens, cache)

    return serve_step
