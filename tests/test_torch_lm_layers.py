"""The LM zoo's layers in the port against the reference's, on the CPU.

Same numpy inputs (from a seed) through ``repro.models`` and
``repro_torch.models``, in float32. Tolerances: the elementwise layers
rtol 1e-5 with atol 1e-5 x max(1, max|ref|); attention, MoE and the
recurrences rtol 1e-4 with atol 1e-4 x max(1, max|ref|) (f32 sums in
another order; the RG-LRU scan at 1e-5). MoE routing (expert ids, sort
order, ranks, kept masks) is compared exactly. Also: the configs and
parameter counts, the parameter tree of every architecture's init, and the
bridge's bf16 leaves and caches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import build as ref_build
from repro.models import common as ref_common
from repro.models import encdec as ref_encdec
from repro.models import griffin as ref_griffin
from repro.models import moe as ref_moe
from repro.models import xlstm as ref_xlstm
from repro_torch import bridge, configs
from repro_torch.core import types as port_types
from repro_torch.models import attention, common, encdec, griffin, moe, xlstm

from _torch_lm import (ARCHS, apis, cfgs, close, close_trees, inputs,
                       port_params, ref_params)

# One torch thread: the suite's pytest workers already occupy the cores.
torch.set_num_threads(1)


def _rand(seed, *shape, scale=1.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _both(tree):
    """A numpy tree as (reference, port) trees."""
    return (jax.tree.map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, "cpu"))


# ------------------------------------------------------------ elementwise

def test_norms_rope_and_mlps():
    xj, xt = _rand(0, 2, 5, 3, 16, scale=3.0)
    gj, gt = _rand(1, 16)
    close(common.rms_norm(gt, xt), ref_common.rms_norm(gj, xj), 1e-5, 1e-5)
    bj, bt = _rand(2, 16)
    close(common.layer_norm({"g": gt, "b": bt}, xt),
          ref_common.layer_norm({"g": gj, "b": bj}, xj), 1e-5, 1e-5)
    pos = np.random.default_rng(3).integers(0, 5000, (2, 5)).astype(np.int32)
    close(common.apply_rope(xt, torch.from_numpy(pos), 1e6),
          ref_common.apply_rope(xj, jnp.asarray(pos), 1e6), 1e-5, 1e-5)
    close(common.softcap(xt, 2.0), ref_common.softcap(xj, 2.0), 1e-5, 1e-5)

    rng = np.random.default_rng(4)
    mlp = {"wi": rng.normal(size=(16, 40)), "wg": rng.normal(size=(16, 40)),
           "wo": rng.normal(size=(40, 16)) * 0.2}
    mlp = {k: v.astype(np.float32) for k, v in mlp.items()}
    pj, pt = _both(mlp)
    close(common.swiglu(pt, xt), ref_common.swiglu(pj, xj), 1e-5, 1e-5)
    gelu = {"wi": mlp["wi"], "bi": rng.normal(size=40).astype(np.float32),
            "wo": mlp["wo"], "bo": rng.normal(size=16).astype(np.float32)}
    pj, pt = _both(gelu)
    close(common.gelu_mlp(pt, xt), ref_common.gelu_mlp(pj, xj), 1e-5, 1e-5)


# -------------------------------------------------------------- attention

@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 5, 0.0), (True, 0, 3.0), (False, 0, 0.0)],
    ids=["causal", "windowed", "softcapped", "bidirectional"])
def test_full_attention(causal, window, cap):
    qj, qt = _rand(0, 2, 11, 4, 8)
    kj, kt = _rand(1, 2, 11, 2, 8)
    vj, vt = _rand(2, 2, 11, 2, 8)
    kw = dict(causal=causal, window=window, softcap_val=cap)
    close(attention.full_attention(qt, kt, vt, **kw),
          ref_attn.full_attention(qj, kj, vj, **kw))


@pytest.mark.parametrize("shape,chunks,window,hkv", [
    ((2, 256, 4, 16), (32, 64), 0, 2), ((1, 128, 2, 8), (16, 32), 32, 2)],
    ids=["gqa", "windowed"])
def test_chunked_attention(shape, chunks, window, hkv):
    """The shapes of the reference's test_lm_consistency.py."""
    b, s, h, hd = shape
    qj, qt = _rand(0, b, s, h, hd)
    kj, kt = _rand(1, b, s, hkv, hd)
    vj, vt = _rand(2, b, s, hkv, hd)
    kw = dict(causal=True, q_chunk=chunks[0], k_chunk=chunks[1],
              window=window)
    close(attention.chunked_attention(qt, kt, vt, **kw),
          jax.jit(lambda q, k, v: ref_attn.chunked_attention(
              q, k, v, **kw))(qj, kj, vj))


@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention_on_a_partly_filled_cache(window):
    qj, qt = _rand(0, 2, 1, 6, 8)
    kj, kt = _rand(1, 2, 10, 3, 8)
    vj, vt = _rand(2, 2, 10, 3, 8)
    got = attention.decode_attention(qt, kt, vt, torch.tensor(7),
                                     window=window, softcap_val=5.0)
    want = ref_attn.decode_attention(qj, kj, vj, jnp.asarray(7),
                                     window=window, softcap_val=5.0)
    close(got, want)
    # what lies past the length does not enter (finite: 0 x NaN would)
    kt[:, 7:] = 1e4
    vt[:, 7:] = -1e4
    close(attention.decode_attention(qt, kt, vt, 7, window=window,
                                     softcap_val=5.0), want)


# -------------------------------------------------------------------- MoE

def _moe_case(arch, s, capacity_factor):
    rc, pc = cfgs(arch, capacity_factor=capacity_factor)
    p = bridge.to_numpy(port_params(arch)["blocks"]["ffn"])
    p = jax.tree.map(lambda a: a[0], p)            # layer 0's experts
    pj, pt = _both(p)
    xj, xt = _rand(5, 2, s, rc.d_model)
    return rc, pc, pj, pt, xj, xt


@pytest.mark.parametrize("arch,s,cf", [
    ("granite_moe_1b_a400m", 48, None), ("granite_moe_1b_a400m", 40, 1.25),
    ("qwen2_moe_a2p7b", 48, None), ("qwen2_moe_a2p7b", 40, 1.25)],
    ids=["granite-drop-free", "granite-drops", "qwen2-drop-free",
         "qwen2-drops"])
def test_moe_ffn(arch, s, cf):
    """Drop-free (capacity_factor = n_experts / top_k, so every expert
    holds the whole sequence) and at 1.25, where some assignments drop."""
    base = configs.get_reduced(arch).moe
    cf = cf or base.n_experts / base.top_k
    rc, pc, pj, pt, xj, xt = _moe_case(arch, s, cf)
    out, aux = moe.moe_ffn(pt, pc, xt)
    out_r, aux_r = jax.jit(lambda p, x: ref_moe.moe_ffn(p, rc, x))(pj, xj)
    close(out, out_r, what="out")
    close(aux, aux_r, what="aux")

    # routing: expert ids, then each row's sort, ranks and kept mask
    gates, ids, _ = moe.route(pt, pc, xt)
    probs = jax.nn.softmax(xj @ pj["router"], axis=-1)
    gates_r, ids_r = jax.lax.top_k(probs, rc.moe.top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))
    cap = moe.capacity(pc, s)
    se, rank, keep, order, tok_s = moe.dispatch(ids, moe.padded_experts(pc),
                                                cap)
    for b in range(2):
        _, se_r, rank_r, (order_r, tok_r, keep_r) = ref_moe._dispatch_one(
            xj[b], gates_r[b], ids_r[b], ref_moe.padded_experts(rc), cap)
        for got, want in ((se, se_r), (rank, rank_r), (keep, keep_r),
                          (order, order_r), (tok_s, tok_r)):
            np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    drops = int((~keep).sum())
    assert (drops > 0) == (cf == 1.25), drops


# -------------------------------------------------------------- recurrences

@pytest.mark.parametrize("s", [512, 100, 300], ids=["chunked", "one-window",
                                                    "not-a-multiple"])
def test_rglru_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 0.999, (2, s, 8)).astype(np.float32)
    u = rng.normal(size=(2, s, 8)).astype(np.float32)
    h0 = rng.normal(size=(2, 8)).astype(np.float32)
    for h in (None, h0):
        got = griffin.rglru_scan(torch.from_numpy(a), torch.from_numpy(u),
                                 None if h is None else torch.from_numpy(h))
        want = jax.jit(lambda a, u, h: ref_griffin.rglru_scan(a, u, h))(
            a, u, h)
        close(got, want, 1e-5, 1e-5, f"h0 {h is not None}")


def _block_params(arch, group, name, i=0):
    p = jax.tree.map(lambda a: a[i],
                     bridge.to_numpy(port_params(arch)[group][name]))
    return _both(p)


def test_rglru_block_with_state():
    rc, pc = cfgs("recurrentgemma_9b")
    pj, pt = _block_params("recurrentgemma_9b", "periods", "0_r")
    xj, xt = _rand(0, 2, 9, rc.d_model)
    block_r = jax.jit(lambda p, x, st: ref_griffin.recurrent_block(
        p, rc, x, st))
    out, st = griffin.recurrent_block(pt, pc, xt)
    out_r, st_r = block_r(pj, xj, None)
    close(out, out_r)
    close_trees(st, st_r, what="state")
    # one more step from that state
    yj, yt = _rand(1, 2, 1, rc.d_model)
    out, st = griffin.recurrent_block(pt, pc, yt, st)
    out_r, st_r = block_r(pj, yj, st_r)
    close(out, out_r)
    close_trees(st, st_r, what="state after a step")


def test_mlstm_with_a_padded_tail():
    """13 steps in chunks of 8: the last chunk holds 3 padded steps."""
    rc, pc = cfgs("xlstm_125m")
    pj, pt = _block_params("xlstm_125m", "periods", "0_m")
    xj, xt = _rand(0, 2, 13, rc.d_model)
    out, st = xlstm.mlstm_block(pt, pc, xt)
    out_r, st_r = jax.jit(lambda p, x: ref_xlstm.mlstm_block(p, rc, x))(
        pj, xj)
    close(out, out_r)
    close_trees(st, st_r, what="state")

    # mlstm_sequence itself, and the padded steps leave the state exactly
    # as the real steps left it
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 13, 8)).astype(
        np.float32)) for _ in range(3))
    log_i = torch.from_numpy(rng.normal(size=(2, 2, 13)).astype(np.float32))
    log_f = torch.nn.functional.logsigmoid(torch.from_numpy(
        rng.normal(size=(2, 2, 13)).astype(np.float32) + 2))
    cell = (torch.zeros(2, 2, 8, 8), torch.zeros(2, 2, 8),
            torch.full((2, 2), xlstm.NEG_INF))
    h, st = xlstm.mlstm_sequence(q, k, v, log_i, log_f, cell, 13)
    h_r, st_r = ref_xlstm.mlstm_sequence(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, log_i, log_f)),
        tuple(jnp.asarray(t.numpy()) for t in cell), 13)
    close(h, h_r)
    close_trees(list(st), list(st_r), what="sequence state")
    pad = lambda t, val=0.0: torch.nn.functional.pad(t, (0, 3), value=val)
    _, st_p = xlstm._mlstm_chunk(
        *(torch.nn.functional.pad(t, (0, 0, 0, 3)) for t in (q, k, v)),
        pad(log_i, xlstm.NEG_INF), pad(log_f), cell)
    for a, b in zip(st_p, st):
        assert torch.equal(a, b)


def test_slstm_block():
    rc, pc = cfgs("xlstm_125m")
    pj, pt = _block_params("xlstm_125m", "periods", "3_s")
    xj, xt = _rand(0, 2, 7, rc.d_model)
    out, st = xlstm.slstm_block(pt, pc, xt)
    out_r, st_r = jax.jit(lambda p, x: ref_xlstm.slstm_block(p, rc, x))(
        pj, xj)
    close(out, out_r)
    close_trees(st, st_r, what="state")


def test_slstm_scan_gradients_equal_autograd_of_the_step_loop():
    """``xlstm.slstm_scan`` (the recurrence as one op, its reverse pass
    written out) against autograd of the eager step loop, from a nonzero
    state, with gradients into every step's state and the final one:
    every input's gradient within 1e-5 x max(1, max|g|)."""
    rng = np.random.default_rng(3)
    b, s, h, dh = 3, 9, 2, 4
    d = h * dh
    r = torch.from_numpy(rng.normal(0, 0.5, (4, h, dh, dh)).astype(
        np.float32))
    wx = torch.from_numpy(rng.normal(size=(b, s, 4 * d)).astype(np.float32))
    st0 = [torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
           for _ in range(4)]                            # c, n, h, m
    st0[1] = st0[1].abs() + 0.5
    ws = [torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
          for _ in range(4)]

    def grads(scan):
        ins = [t.clone().requires_grad_(True) for t in (r, wx, *st0)]
        if scan:
            outs = xlstm.slstm_scan(*ins, h)             # h, c, n, m
        else:
            st, steps = xlstm.SLSTMState(*ins[2:]), []
            for t in range(s):
                st = xlstm._slstm_step(ins[0], h, ins[1][:, t], st)
                steps.append(st)
            outs = [torch.stack([getattr(x, f) for x in steps], 1)
                    for f in ("h", "c", "n", "m")]
        loss = sum((o * w).sum() for o, w in zip(outs, ws)) \
            + outs[1][:, -1].square().sum()
        return [o.detach() for o in outs], torch.autograd.grad(loss, ins)

    (outs, got), (want_outs, want) = grads(True), grads(False)
    for a, e in zip(outs, want_outs):
        assert torch.equal(a, e)
    for a, e in zip(got, want):
        np.testing.assert_allclose(
            a.numpy(), e.numpy(), rtol=0,
            atol=1e-5 * max(1.0, float(e.abs().max())))


def test_encode():
    rc, pc = cfgs("whisper_base")
    pj, pt = ref_params("whisper_base"), port_params("whisper_base")
    xj, xt = _rand(0, 2, rc.n_audio_frames, rc.d_model)
    close(encdec.encode(pt, pc, xt),
          jax.jit(lambda p, x: ref_encdec.encode(p, rc, x))(pj, xj))
    # whisper's 1,500 positions: an f32 angle near 1,500 rad is resolved to
    # 1.2e-4, so sin/cos agree to two such steps
    np.testing.assert_allclose(encdec.sinusoids(1500, 512).numpy(),
                               np.asarray(ref_encdec.sinusoids(1500, 512)),
                               rtol=0, atol=2 * np.spacing(np.float32(1500)))


# -------------------------------------------- configs, trees and the bridge

def test_configs_equal_the_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.ALIASES == ref_configs.ALIASES
    for arch in list(ARCHS) + list(configs.ALIASES):
        for get in ("get", "get_reduced"):
            pc = getattr(configs, get)(arch)
            rc = getattr(ref_configs, get)(arch)
            assert dataclasses.asdict(pc) == dataclasses.asdict(rc), arch
            assert pc.n_params() == rc.n_params(), arch
            assert pc.n_active_params() == rc.n_active_params(), arch
            assert pc.layer_kinds() == rc.layer_kinds(), arch
    for sys_, cfg in (("dpmd_copper", port_types.COPPER_DP),
                      ("dpmd_water", port_types.WATER_DP)):
        assert configs.get(sys_) is cfg
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            ref_configs.get(sys_))
    assert [dataclasses.astuple(s) for s in __import__(
        "repro_torch.models", fromlist=["x"]).ASSIGNED_SHAPES] == [
        dataclasses.astuple(s) for s in __import__(
            "repro.models", fromlist=["x"]).ASSIGNED_SHAPES]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_equals_the_reference(arch):
    """Keys, shapes and dtypes of the init (the reference's traced only)."""
    shapes = jax.eval_shape(ref_build(ref_configs.get_reduced(arch)).init,
                            jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
            for k, v in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
           for k, v in jax.tree_util.tree_leaves_with_path(
               bridge.to_numpy(port_params(arch)))}
    assert got == want


def test_reference_init_through_params_from_numpy():
    """The reference's own weights carried across drive the same logits."""
    rapi, papi = apis("qwen3_1p7b")
    rp = jax.jit(rapi.init)(jax.random.PRNGKey(0))
    pp = bridge.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    kj, kt = inputs(rapi.cfg)
    close(papi.forward(pp, **kt)[0],
          jax.jit(lambda p, t: rapi.forward(p, tokens=t)[0])(rp, kj["tokens"]))


def test_bridge_bf16_bit_for_bit_and_caches():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (3, 7, 5),
                                     jnp.bfloat16))
    assert x.dtype.name == "bfloat16"
    t = bridge.params_from_numpy({"a": [x]}, "cpu")["a"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  x.view(np.int16))
    back = bridge.to_numpy(t)
    np.testing.assert_array_equal(back, x.astype(np.float32))
    # a bf16 cache: every leaf a tensor, its length too
    rc, _ = cfgs("qwen3_1p7b", "bfloat16")
    cache = ref_attn.init_kv_cache(rc, 2, 2, 5, jnp.bfloat16)
    cache = cache._replace(k=cache.k + 1.5, length=jnp.asarray(3, jnp.int32))
    got = bridge.cache_from_numpy(jax.tree.map(np.asarray, cache), "cpu")
    assert isinstance(got, attention.KVCache)
    assert got.k.dtype == torch.bfloat16 and bool((got.k == 1.5).all())
    assert got.length.dtype == torch.int32 and int(got.length) == 3
    xc = ref_xlstm.init_cache(None, cfgs("xlstm_125m")[0], 2)
    got = bridge.cache_from_numpy(jax.tree.map(np.asarray, xc), "cpu")
    assert isinstance(got.states[0]["0_m"], xlstm.MLSTMState)
    assert isinstance(got.states[0]["3_s"], xlstm.SLSTMState)
    close_trees(got, xc, what="xlstm cache")
