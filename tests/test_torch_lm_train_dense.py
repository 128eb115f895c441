"""One LM train step of the port against the reference's: the dense
family (qwen3-1.7b) and llava-next-34b's stub embeddings, REDUCED configs,
f32 and bf16; remat on against off. The checks are
``_torch_lm_train.check_train_step``'s."""

import pytest
import torch

from _torch_lm import BF16, F32
from _torch_lm_train import check_remat, check_train_step

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llava-next-34b"])
def test_train_step_matches_reference(arch, dtype):
    check_train_step(arch, dtype)


def test_remat_changes_nothing():
    check_remat("qwen3-1.7b")
