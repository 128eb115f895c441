"""Config registry: 10 assigned architectures + the paper's two DP systems.

Each ``<arch>.py`` exports ``CONFIG`` (the exact published size) and
``REDUCED`` (same family, small — for CPU tests). Copies of the
reference's ``repro.configs``; the two DP modules alias the port's
``core.types``. Full configs are served on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.lm_types import LMConfig

ARCH_IDS: List[str] = [
    "glm4_9b",
    "qwen2_72b",
    "qwen3_1p7b",
    "granite_3_8b",
    "xlstm_125m",
    "granite_moe_1b_a400m",
    "qwen2_moe_a2p7b",
    "llava_next_34b",
    "recurrentgemma_9b",
    "whisper_base",
]

# CLI-facing ids (assignment spelling) -> module names
ALIASES: Dict[str, str] = {
    "glm4-9b": "glm4_9b",
    "qwen2-72b": "qwen2_72b",
    "qwen3-1.7b": "qwen3_1p7b",
    "granite-3-8b": "granite_3_8b",
    "xlstm-125m": "xlstm_125m",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "llava-next-34b": "llava_next_34b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-base": "whisper_base",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(arch: str) -> LMConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> LMConfig:
    return _module(arch).REDUCED


def all_archs() -> List[str]:
    return list(ARCH_IDS)
