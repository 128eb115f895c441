"""One LM train step of the port against the reference's: xlstm-125m
(ssm: mLSTM chunks and the sLSTM loop), REDUCED, f32 and bf16; remat on
against off. The checks are ``_torch_lm_train.check_train_step``'s."""

import pytest
torch = pytest.importorskip("torch")

from _torch_lm import BF16, F32  # noqa: E402
from _torch_lm_train import check_remat, check_train_step  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_train_step_matches_reference(dtype):
    check_train_step("xlstm-125m", dtype)


def test_remat_changes_nothing():
    check_remat("xlstm-125m")
