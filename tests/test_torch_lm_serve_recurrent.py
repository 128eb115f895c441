"""The recurrent families (xLSTM, the Griffin hybrid, the whisper-style
encoder-decoder) in the port against the reference, on the CPU at the
REDUCED configs: teacher-forced logits in f32 and bf16, stateful decode
from scratch with its final state, and the serving step
(``tests/_torch_lm.py`` holds the bodies and tolerances)."""

import pytest
import torch

from _torch_lm import (BF16, F32, check_forward, check_recurrent_decode,
                       check_serve_step)

torch.set_num_threads(1)

ARCHS = ["xlstm_125m", "recurrentgemma_9b", "whisper_base"]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward(arch, dtype):
    check_forward(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_decode(arch):
    check_recurrent_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_is_the_decode_step(arch):
    check_serve_step(arch)
