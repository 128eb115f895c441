"""One LM train step of the port against the reference's: the MoE family
(granite-moe-1b-a400m, REDUCED), drop-free at its capacity factor 4.0 on
2 x 16 tokens and with capacity drops at 0.5 on 2 x 64, f32 and bf16;
remat on against off. The checks are ``_torch_lm_train.check_train_step``'s;
the gradients of the gates, the expert weights and the tokens flow through
the sort-based dispatch (a scatter whose dropped assignments all write one
spare slot) and the ``index_add_`` combine."""

import pytest
torch = pytest.importorskip("torch")

from repro_torch.models import moe  # noqa: E402

from _torch_lm import BF16, F32, apis  # noqa: E402
from _torch_lm_train import batch, check_remat, check_train_step, port_step  # noqa: E402

torch.set_num_threads(1)

ARCH = "granite-moe-1b-a400m"
CASES = {"drop_free": dict(seq=16), "drops": dict(seq=64, capacity_factor=0.5)}


@pytest.mark.parametrize("case", CASES)
def test_the_cases_drop_as_named(case, monkeypatch):
    """The port's step drops assignments past an expert's capacity in the
    "drops" case and none in "drop_free"."""
    kw = dict(CASES[case])
    seq = kw.pop("seq")
    kept, orig = [], moe.dispatch

    def dispatch(ids, e_pad, cap):
        out = orig(ids, e_pad, cap)
        kept.append(out[2])
        return out

    monkeypatch.setattr(moe, "dispatch", dispatch)
    _, papi = apis(ARCH, F32, **kw)
    port_step(papi, ARCH, batch(papi.cfg, s=seq)[1])
    dropped = sum(int((~k).sum()) for k in kept)
    assert (dropped > 0) == (case == "drops"), dropped


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("case", CASES)
def test_train_step_matches_reference(case, dtype):
    check_train_step(ARCH, dtype, **CASES[case])


@pytest.mark.parametrize("case", CASES)
def test_remat_changes_nothing(case):
    check_remat(ARCH, **CASES[case])
