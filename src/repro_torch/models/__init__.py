"""LM model zoo: dense GQA, MoE, xLSTM, Griffin hybrid, encoder-decoder."""

from repro_torch.models.lm_types import (LMConfig, MoEConfig, ShapeSpec,
                                         ASSIGNED_SHAPES)
from repro_torch.models.zoo import ModelAPI, build

__all__ = ["LMConfig", "MoEConfig", "ShapeSpec", "ASSIGNED_SHAPES",
           "ModelAPI", "build"]
