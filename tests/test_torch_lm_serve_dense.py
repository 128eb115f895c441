"""The dense GQA family (glm4, qwen2, qwen3, granite-3, llava's backbone)
in the port against the reference, on the CPU at the REDUCED configs:
teacher-forced logits in f32 and bf16, prefill and decode steps with their
caches, and the serving step (``tests/_torch_lm.py`` holds the bodies and
tolerances)."""

import pytest
import torch

from _torch_lm import (BF16, F32, check_forward, check_prefill_decode,
                       check_serve_step)

torch.set_num_threads(1)

ARCHS = ["glm4_9b", "qwen2_72b", "qwen3_1p7b", "granite_3_8b",
         "llava_next_34b"]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward(arch, dtype):
    check_forward(arch, dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode(arch, dtype):
    check_prefill_decode(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_is_the_decode_step(arch):
    check_serve_step(arch)
