"""DPA-1's gated attention core (``kernels/dp_fused/attention.py``) on the
CPU: the wrapper's plain version, which is the kernels' algorithm (key tiles
with an online softmax, the softmax recomputed from the saved statistics,
dL = P (gate dW - D_j) with D_j = dO_j . O_j, tiles without a live key
skipped), held against autograd through the torch ops the model ran before
the kernels; a float64 ``gradcheck``; and the whole model's energy, forces
and virial unchanged. The file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_dpa1_attention.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dpa1  # noqa: E402
from repro_torch.core.types import DPA1Config  # noqa: E402
from repro_torch.kernels.dp_fused import attention  # noqa: E402
from repro_torch.md import neighbors  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mdbench.systems import water  # noqa: E402

torch.set_num_threads(1)


def torch_ops(q, k, v, ww, gate, pad):
    """The attention core as the model computed it before the kernels."""
    logits = (torch.matmul(q, k.transpose(-1, -2)) + dpa1.SHIFT) * ww + pad
    return torch.matmul(torch.softmax(logits, dim=-1) * gate, v)


def _mask(rng, a, s, kind):
    """(A, S) live slots: each row's live slots first, scattered at random,
    or first with one row all padded."""
    if kind == "scattered":
        live = rng.random((a, s)) < 0.7
    else:
        n = rng.integers(0, s + 1, a)
        n[0] = s                          # a full row
        if kind == "all_padded_row":
            n[1] = 0
        live = np.arange(s)[None, :] < n[:, None]
    return live


def _inputs(seed, a, s, d, kind, dtype=torch.float64):
    """q, k, v, ww, gate, pad as ``attention_layer`` gets them: q, k, v
    L2-normalised (q scaled by d^-0.5), w in (0, 1] and unit vectors on live
    slots and 0 on padded ones, ww = w_j w_k, gate = ww (r^_j . r^_k), pad
    -SHIFT or MASKED - SHIFT; and a cotangent of O."""
    rng = np.random.default_rng(seed)
    live = _mask(rng, a, s, kind)
    x = [rng.normal(size=(a, s, d)) for _ in range(3)]
    q, k, v = (t / np.linalg.norm(t, axis=-1, keepdims=True) for t in x)
    q = q * d ** -0.5
    w = np.where(live, rng.uniform(0.05, 1.0, (a, s)), 0.0)
    unit = rng.normal(size=(a, s, 3))
    unit = np.where(live[..., None],
                    unit / np.linalg.norm(unit, axis=-1, keepdims=True), 0.0)
    ww = w[:, :, None] * w[:, None, :]
    gate = ww * np.einsum("ajx,akx->ajk", unit, unit)
    pad = np.where(live, -dpa1.SHIFT, dpa1.MASKED - dpa1.SHIFT)[:, None, :]
    dout = rng.normal(size=(a, s, d))
    out = [torch.tensor(t, dtype=dtype) for t in (q, k, v, ww, gate, pad,
                                                  dout)]
    return out, torch.from_numpy(live)


def _grads(fn, inputs, dout):
    leaves = [t.clone().requires_grad_(True) for t in inputs[:5]]
    out = fn(*leaves, inputs[5])
    return (out.detach(), *torch.autograd.grad(out, leaves, dout))


@pytest.mark.parametrize("s", [7, 120, 130])
@pytest.mark.parametrize("kind", ["live_first", "scattered",
                                  "all_padded_row"])
def test_plain_version_matches_autograd_through_the_torch_ops(kind, s):
    """O and the gradients to q, k, v, ww and gate, in float64; dgate on
    live x live pairs, and zero elsewhere (a padded row's gate gradient is
    multiplied downstream by ww = 0 and r^.r^ = 0)."""
    inputs, live = _inputs(s + len(kind), 5, s, 32, kind)
    dout = inputs[6]
    got = _grads(lambda *x: attention.gated_attention(*x, dpa1.SHIFT),
                 inputs, dout)
    want = _grads(torch_ops, inputs, dout)
    pairs = live[:, :, None] & live[:, None, :]
    for name, g, w in zip(("O", "dq", "dk", "dv", "dww"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-12, msg=name)
    torch.testing.assert_close(got[5][pairs], want[5][pairs], rtol=1e-9,
                               atol=1e-12)
    assert not got[5][~pairs].any()
    assert float(want[0].abs().max()) > 1e-3
    assert float(want[4][pairs].abs().max()) > 1e-3


def test_float32_plain_version_matches_the_torch_ops():
    """The same in the model's float32, at dpa1.h2o's slot count: the
    online softmax sums in another order, so a float32 tolerance."""
    inputs, _ = _inputs(3, 8, 120, 128, "live_first", torch.float32)
    got = _grads(lambda *x: attention.gated_attention(*x, dpa1.SHIFT),
                 inputs, inputs[6])
    want = _grads(torch_ops, inputs, inputs[6])
    for g, w in zip(got[:5], want[:5]):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("kind", ["scattered", "all_padded_row"])
def test_gradcheck_in_float64(kind):
    """The backward (recomputed softmax, the D_j form) is the derivative of
    the forward, padded rows and tiles included; S = 34 crosses a key
    tile."""
    inputs, _ = _inputs(11, 2, 34, 4, kind)
    leaves = [t.clone().requires_grad_(True) for t in inputs[:5]]
    assert torch.autograd.gradcheck(
        lambda *x: attention.gated_attention(*x, inputs[5], dpa1.SHIFT),
        leaves, eps=1e-6, atol=1e-8, rtol=1e-6)


def test_tiles_without_a_live_key_are_skipped():
    """Only key tiles in which some row has a live key are visited; the
    statistics of a padded row are 0."""
    inputs, live = _inputs(5, 4, 130, 32, "live_first")
    live[:] = False
    live[:, :40] = True
    live[2, 100] = True
    pad = torch.where(live, -dpa1.SHIFT, dpa1.MASKED - dpa1.SHIFT)[:, None]
    tiles = [(t.start, t.stop) for t in attention._key_tiles(
        attention.live_slots(pad.double()))]
    assert tiles == [(0, 32), (32, 64), (96, 128)]
    _, lse = attention.gated_attention_fwd_ref(*inputs[:5], pad.double(),
                                               dpa1.SHIFT)
    assert not lse[~live].any() and bool(lse[live].ne(0).all())


def test_the_wrapper_refuses_what_it_cannot_take():
    inputs, _ = _inputs(1, 2, 9, 8, "live_first")
    q, k, v, ww, gate, pad = inputs[:6]
    for bad, err in [((q[0], k, v, ww, gate, pad), ValueError),
                     ((q, k[:, :-1], v, ww, gate, pad), ValueError),
                     ((q, k, v, ww.float(), gate, pad), TypeError),
                     ((q, k, v, ww, gate, pad[:, 0]), ValueError)]:
        with pytest.raises(err):
            attention.gated_attention(*bad, dpa1.SHIFT)


# ----------------------------------------------------- the whole model

CFG = DPA1Config(ntypes=2, rcut=4.0, rcut_smth=0.5, sel=40,
                 type_map=("O", "H"), embed_widths=(4, 8, 16), axis_neuron=4,
                 tebd_dim=8, attn=16, attn_layer=2, fit_widths=(16, 16, 16))


@pytest.mark.parametrize("cap", [40, 130])
def test_the_models_energy_forces_and_virial_are_unchanged(monkeypatch, cap):
    """``dpa1.energy_forces`` on water(1, 1, 1) through the plain version
    and through the torch ops it replaced, at the default section and at one
    that spans five key tiles: float32 sums in another order only."""
    pos, typ, box = water.water((1, 1, 1), 0)
    x = torch.as_tensor(np.mod(pos, box), dtype=torch.float32)
    t = torch.as_tensor(typ, dtype=torch.int64)
    b = torch.as_tensor(box, dtype=torch.float32)
    nlist, ovf = neighbors.brute_force_neighbors(
        x, t, neighbors.NeighborSpec(CFG.rcut + 2.0, (64, 128)), b)
    assert int(ovf) <= 0
    params = dpa1.init_params(torch.Generator().manual_seed(0), CFG,
                              device="cpu")
    e, f, w, excess = dpa1.energy_forces(params, CFG, x, nlist, t, b, cap)
    monkeypatch.setattr(dpa1, "gated_attention",
                        lambda q, k, v, ww, gate, pad, shift:
                        torch_ops(q, k, v, ww, gate, pad))
    e0, f0, w0, _ = dpa1.energy_forces(params, CFG, x, nlist, t, b, cap)
    assert int(excess) <= 0
    assert float(e) == pytest.approx(float(e0), rel=1e-6)
    torch.testing.assert_close(f, f0, rtol=0,
                               atol=1e-5 * float(f0.abs().max()))
    torch.testing.assert_close(w, w0, rtol=0,
                               atol=1e-5 * float(w0.abs().max()))
    assert float(f0.abs().max()) > 1e-3
