"""The port's LM training pieces against the reference on the CPU: the
cross-entropy (whole and chunked), the token pipeline's contract, the
gradients at the masked points of the forward, the in-place AdamW, a
3-step trajectory, the loss falling, a restart bit for bit, a checkpoint
carried across the packages both ways, the train state through the
bridge, and the training CLI.

The pipeline's draws cannot match the reference's threefry stream, so the
parity tests feed the reference's batches to both packages; the port's
pipeline is held to its contract (determinism, ranges, dtypes, keys).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.tokens import TokenPipeline as RefTokenPipeline
from repro.data.tokens import pipeline_for as ref_pipeline_for
from repro.models import attention as ref_attention
from repro.models import build as ref_build
from repro.models import losses as ref_losses
from repro.models import xlstm as ref_xlstm
from repro.train import checkpoint as ref_checkpoint
from repro.train import optim as ref_optim
from repro.train.steps import init_train_state as ref_init_train_state
from repro.train.steps import make_train_step as ref_make_train_step
from repro_torch import bridge, configs
from repro_torch.data import TokenPipeline, pipeline_for
from repro_torch.launch import train as train_mod
from repro_torch.models import attention, build, losses, xlstm
from repro_torch.train import checkpoint, optim, tree
from repro_torch.train.steps import TrainState, make_train_step

from _torch_lm import ref_jit

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _batch_t(batch):
    return {k: bridge.params_from_numpy({"x": np.asarray(v)}, "cpu")["x"]
            for k, v in batch.items()}


# ------------------------------------------------------------------ losses

def _ce_inputs(with_mask):
    """test_lm_consistency.py's shapes: hidden (2, 64, 16), V 101."""
    rng = np.random.default_rng(0)
    hidden = rng.normal(size=(2, 64, 16)).astype(np.float32)
    w = (rng.normal(size=(16, 101)) * 0.2).astype(np.float32)
    labels = rng.integers(0, 101, (2, 64)).astype(np.int32)
    mask = (rng.uniform(size=(2, 64)) < 0.7).astype(np.float32) \
        if with_mask else None
    return hidden, w, labels, mask


@pytest.mark.parametrize("chunk", [16, 64], ids=["chunked", "s_eq_chunk"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["all", "mask"])
def test_chunked_cross_entropy_matches_reference(with_mask, chunk):
    """Value at rtol 1e-5, gradients (hidden and the head) at rtol 1e-4,
    atol 1e-6; chunk 64 == S takes the whole-sequence path."""
    hidden, w, labels, mask = _ce_inputs(with_mask)

    def ref(h, w):
        m = None if mask is None else jnp.asarray(mask)
        return ref_losses.chunked_softmax_cross_entropy(
            h, lambda x: x @ w, jnp.asarray(labels), m, chunk=chunk)

    val_r, (gh_r, gw_r) = jax.jit(jax.value_and_grad(ref, (0, 1)))(
        jnp.asarray(hidden), jnp.asarray(w))
    h_t, w_t = _t(hidden).requires_grad_(), _t(w).requires_grad_()
    val = losses.chunked_softmax_cross_entropy(
        h_t, lambda x: x @ w_t, _t(labels),
        None if mask is None else _t(mask), chunk=chunk)
    gh, gw = torch.autograd.grad(val, (h_t, w_t))
    np.testing.assert_allclose(float(val.detach()), float(val_r), rtol=1e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(gh_r), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_r), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("with_mask", [False, True], ids=["all", "mask"])
def test_chunked_cross_entropy_equals_full(with_mask):
    hidden, w, labels, mask = _ce_inputs(with_mask)
    m = None if mask is None else _t(mask)
    h_t = _t(hidden).requires_grad_()
    f = lambda x: x @ _t(w)
    full = losses.softmax_cross_entropy(f(h_t), _t(labels), m)
    chunked = losses.chunked_softmax_cross_entropy(h_t, f, _t(labels), m,
                                                   chunk=16)
    g_full, = torch.autograd.grad(full, h_t)
    g_chunk, = torch.autograd.grad(chunked, h_t)
    torch.testing.assert_close(chunked, full, rtol=1e-5, atol=0)
    torch.testing.assert_close(g_chunk, g_full, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------- pipeline

def test_pipeline_is_a_pure_function_of_seed_and_step():
    """test_train_and_checkpoint.py's determinism test, on the port."""
    p1 = TokenPipeline(vocab=101, seq_len=8, global_batch=4, seed=3)
    p2 = TokenPipeline(vocab=101, seq_len=8, global_batch=4, seed=3)
    b1, b2 = p1.batch(17, "cpu"), p2.batch(17, "cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["labels"], b2["labels"])
    assert not torch.equal(b1["tokens"], p1.batch(18, "cpu")["tokens"])
    p3 = dataclasses.replace(p1, seed=4)
    assert not torch.equal(b1["tokens"], p3.batch(17, "cpu")["tokens"])


def test_pipeline_stream_ranges_and_shift():
    """Tokens in [0, V); labels are the stream one position on; each step
    of the stream is drift (1..6) plus a noise difference (-16..16)."""
    v = 101
    b = TokenPipeline(vocab=v, seq_len=64, global_batch=16, seed=1).batch(
        0, "cpu")
    tok, lab = b["tokens"], b["labels"]
    assert tok.dtype == lab.dtype == torch.int32
    assert tok.shape == lab.shape == (16, 64)
    assert int(tok.min()) >= 0 and int(tok.max()) < v
    assert torch.equal(lab[:, :-1], tok[:, 1:])
    step = (lab.long() - tok.long() + 15) % v        # drift + dn + 15
    assert int(step.min()) >= 0 and int(step.max()) <= 6 + 16 + 15


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llava-next-34b",
                                  "whisper-base"])
def test_pipeline_frontends_match_reference_layout(arch):
    """Each frontend's keys, shapes and dtypes are the reference's; the
    stub embeddings and frames are normals x 0.02."""
    cfg_r = ref_configs.get_reduced(arch)
    cfg = configs.get_reduced(arch)
    want = ref_pipeline_for(cfg_r, 32, 4, seed=2).batch(3)
    got = pipeline_for(cfg, 32, 4, seed=2).batch(3, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == \
            want[k].dtype.name, k
    for k in ("embeds", "frames"):
        if k in got:
            assert 0.015 < float(got[k].float().std()) < 0.025


# ------------------------------------------------- gradients at the masks

def _attn_inputs(shape, hkv, seed=0):
    rng = np.random.default_rng(seed)
    b, s, h, hd = shape
    q = rng.normal(size=shape).astype(np.float32)
    k, v, ct = (rng.normal(size=sz).astype(np.float32) for sz in
                ((b, s, hkv, hd), (b, s, hkv, hd), (b, s, h * hd)))
    return q, k, v, ct


def _grads_both(ref_fn, port_fn, arrays, ct):
    """d sum(out x ct) / d inputs in both packages."""
    g_r = jax.jit(jax.grad(lambda *a: jnp.sum(ref_fn(*a) * ct),
                           tuple(range(len(arrays)))))(
        *[jnp.asarray(a) for a in arrays])
    xs = [_t(a).requires_grad_() for a in arrays]
    g = torch.autograd.grad((port_fn(*xs) * _t(ct)).sum(), xs)
    return g, g_r


@pytest.mark.parametrize("path", ["full_q_offset", "chunked_window"])
def test_attention_gradients_finite_in_fully_masked_rows(path):
    """NEG_INF = -1e30 masks give finite gradients equal to the
    reference's where a row (full attention with q before every key) or a
    whole kv tile of a row (chunked attention, window 8 < the 32-wide
    tile) is masked."""
    if path == "full_q_offset":
        q, k, v, ct = _attn_inputs((1, 8, 4, 8), 2)
        kw = dict(causal=True, q_offset=-4)        # rows 0-3 see no key
        ref_fn = lambda q, k, v: ref_attention.full_attention(q, k, v, **kw)
        port_fn = lambda q, k, v: attention.full_attention(q, k, v, **kw)
    else:
        q, k, v, ct = _attn_inputs((1, 64, 4, 8), 2)
        kw = dict(causal=True, q_chunk=16, k_chunk=32, window=8)
        ref_fn = lambda q, k, v: ref_attention.chunked_attention(q, k, v,
                                                                 **kw)
        port_fn = lambda q, k, v: attention.chunked_attention(q, k, v, **kw)
    g, g_r = _grads_both(ref_fn, port_fn, (q, k, v), ct)
    for a, b in zip(g, g_r):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()))


def _mlstm_inputs(log_f_level, seed=0):
    rng = np.random.default_rng(seed)
    b, h, l_, dh = 2, 2, 8, 4
    q, k, v = (rng.normal(size=(b, h, l_, dh)).astype(np.float32)
               for _ in range(3))
    log_i = rng.normal(size=(b, h, l_)).astype(np.float32)
    log_f = (log_f_level + 0.1 * rng.normal(size=(b, h, l_))).astype(
        np.float32)
    c0 = np.zeros((b, h, dh, dh), np.float32)
    n0 = np.zeros((b, h, dh), np.float32)
    m0 = np.full((b, h), -1e30, np.float32)
    ct = rng.normal(size=(b, h, l_, dh)).astype(np.float32)
    return (q, k, v, log_i, log_f), (c0, n0, m0), ct


def test_mlstm_chunk_gradients_finite_with_strongly_negative_forget_gates():
    """Above the diagonal the exponent of D_ij grows with the forget gates'
    decay: at log f = -20 a step it reaches ~160 and exp overflows f32.
    The reference masks after the exp and its gradient is NaN there (0 x
    inf); the port masks before it (ROADMAP §C): the same forward, a
    finite gradient equal to the port's own in f64, where nothing
    overflows (atol 1e-6 x the largest gradient). At log f = -1 the port's gradient is the reference's."""
    for level in (-1.0, -20.0):
        arrays, state, ct = _mlstm_inputs(level)

        def ref_fn(*a):
            return ref_xlstm._mlstm_chunk(*a, tuple(jnp.asarray(s)
                                                   for s in state))[0]

        def port_fn(*a):
            st = tuple(_t(s).to(a[0].dtype) for s in state)
            return xlstm._mlstm_chunk(*a, st)[0]

        g, g_r = _grads_both(ref_fn, port_fn, arrays, ct)
        out_r = ref_fn(*[jnp.asarray(a) for a in arrays])
        out = port_fn(*[_t(a) for a in arrays])
        np.testing.assert_allclose(out.numpy(), np.asarray(out_r),
                                   rtol=1e-5, atol=1e-6)
        assert all(torch.isfinite(x).all() for x in g)
        if level == -1.0:
            for a, b in zip(g, g_r):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-4, atol=1e-6)
        else:
            assert any(np.isnan(np.asarray(b)).any() for b in g_r)
            xs = [_t(a).double().requires_grad_() for a in arrays]
            g64 = torch.autograd.grad(
                (port_fn(*xs) * _t(ct).double()).sum(), xs)
            scale = max(float(b.abs().max()) for b in g64)
            for a, b in zip(g, g64):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                           atol=1e-6 * scale)


# ------------------------------------------------------------ the optimizer

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"blocks": {"norm": (3, 8), "w": (3, 8, 5)}, "embed": (11, 8),
              "final_norm": (8,)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))

    return draw(shapes)


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clipped", "no_clip"])
def test_in_place_adamw_is_bit_equal_to_out_of_place(clip):
    """``AdamW.update_`` (the donated step) gives ``update``'s params,
    moments, count and grad norm bit for bit, over 4 steps of the cosine
    schedule, with decay on the stacked norms (ndim 2) too."""
    opt = optim.AdamW(lr=optim.cosine_schedule(1e-2, 2, 10), grad_clip=clip)
    params = _opt_tree(0)
    st_a = opt.init(params)
    p_a = params
    p_b = tree.tree_map(torch.clone, params)
    st_b = opt.init(p_b)
    for i in range(4):
        grads = tree.tree_map(lambda t: t * 3.0, _opt_tree(i + 1))
        p_a, st_a, gn_a = opt.update(grads, st_a, p_a)
        p_b, st_b, gn_b = opt.update_(tree.tree_map(torch.clone, grads),
                                      st_b, p_b)
        assert torch.equal(gn_a, gn_b)
        for a, b in zip(tree.leaves((p_a, st_a)), tree.leaves((p_b, st_b))):
            assert torch.equal(a, b)


def test_donated_train_step_is_bit_equal_and_in_place():
    """make_train_step(donate=True) updates the state's tensors in place
    and equals the out-of-place step bit for bit over 2 steps."""
    cfg = dataclasses.replace(configs.get_reduced("qwen3-1.7b"),
                              dtype="float32")
    api = build(cfg)
    opt = optim.AdamW(lr=optim.cosine_schedule(3e-3, 5, 100))
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=2)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    donated = tree.tree_map(torch.clone, state)
    embed = donated.params["embed"]
    for it in range(2):
        batch = pipe.batch(it, "cpu")
        state, m_a = make_train_step(api, opt, loss_chunk=8)(state, batch)
        donated, m_b = make_train_step(api, opt, loss_chunk=8,
                                       donate=True)(donated, batch)
        for k in m_a:
            assert torch.equal(m_a[k], m_b[k]), k
    assert donated.params["embed"] is embed
    for a, b in zip(tree.leaves(state), tree.leaves(donated)):
        assert torch.equal(a, b)


# ------------------------------------------------------- trajectories

def _f32(arch):
    return (dataclasses.replace(ref_configs.get_reduced(arch),
                                dtype="float32"),
            dataclasses.replace(configs.get_reduced(arch), dtype="float32"))


def test_three_step_trajectory_matches_reference():
    """Reduced qwen3 in f32 from the reference's init_train_state, carried
    through bridge.train_state_from_numpy, on the reference's batches: the
    loss of each of 3 steps at rtol 1e-5."""
    rc, pc = _f32("qwen3-1.7b")
    rapi, papi = ref_build(rc), build(pc)
    sched = (3e-3, 5, 100)
    r_opt = ref_optim.AdamW(lr=ref_optim.cosine_schedule(*sched))
    p_opt = optim.AdamW(lr=optim.cosine_schedule(*sched))
    r_state = ref_jit(lambda k: ref_init_train_state(rapi, r_opt, k))(
        jax.random.PRNGKey(0))
    state = bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, r_state), "cpu")
    for a, b in zip(tree.leaves(state), jax.tree.leaves(r_state)):
        assert np.array_equal(bridge.to_numpy(a), np.asarray(b))
    r_step = ref_jit(ref_make_train_step(rapi, r_opt, loss_chunk=16))
    step = make_train_step(papi, p_opt, loss_chunk=16, donate=True)
    pipe = RefTokenPipeline(vocab=rc.vocab, seq_len=32, global_batch=4)
    for it in range(3):
        batch = pipe.batch(it)
        r_state, m_r = r_step(r_state, batch)
        state, m = step(state, _batch_t(batch))
        np.testing.assert_allclose(float(m["loss"]), float(m_r["loss"]),
                                   rtol=1e-5, err_msg=f"step {it}")
    assert int(state.step) == int(r_state.step) == 3


def test_lm_loss_decreases():
    """test_train_and_checkpoint.py's test, with its numbers, on the
    port: 40 steps of reduced qwen3 (bf16 compute)."""
    cfg = configs.get_reduced("qwen3-1.7b")
    api = build(cfg)
    opt = optim.AdamW(lr=optim.cosine_schedule(3e-3, 5, 100))
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(api, opt, loss_chunk=16, donate=True)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=8)
    history = []
    for it in range(40):
        state, m = step(state, pipe.batch(it, "cpu"))
        history.append(float(m["loss"]))
    assert np.mean(history[-5:]) < np.mean(history[:5]) - 0.1, history[::8]


def test_restart_from_checkpoint_is_bit_for_bit(tmp_path):
    """train_loop for 8 steps straight, and again as 5 steps, a checkpoint
    and a restart that restores it and runs 3 more: the same final state
    (the cosine schedule's first 5 steps do not depend on the total)."""
    kw = dict(reduced=True, global_batch=4, seq_len=16, loss_chunk=8,
              verbose=False, device="cpu")
    straight, _ = train_mod.train_loop("glm4-9b", steps=8, **kw)
    d = str(tmp_path)
    train_mod.train_loop("glm4-9b", steps=5, ckpt_dir=d, ckpt_every=5, **kw)
    assert checkpoint.latest_step(d) == 5
    resumed, hist = train_mod.train_loop("glm4-9b", steps=8, ckpt_dir=d,
                                         ckpt_every=5, **kw)
    assert hist[0]["step"] == 6 and checkpoint.latest_step(d) == 8
    for a, b in zip(tree.leaves(straight), tree.leaves(resumed)):
        assert torch.equal(a, b)


def test_checkpoint_continues_across_packages(tmp_path):
    """The reference trains reduced glm4-9b (f32) for 5 steps and saves;
    the port restores it through launch.train's restore path and takes 3
    steps on the reference's batches: its losses equal the reference's own
    continuation at rtol 1e-5. The port's checkpoint after those steps
    restores in the reference, leaf for leaf."""
    rc, pc = _f32("glm4-9b")
    rapi, papi = ref_build(rc), build(pc)
    r_opt = ref_optim.AdamW(lr=lambda s: 1e-3)
    r_step = ref_jit(ref_make_train_step(rapi, r_opt, loss_chunk=8))
    pipe = RefTokenPipeline(vocab=rc.vocab, seq_len=16, global_batch=4)
    r_state = ref_jit(lambda k: ref_init_train_state(rapi, r_opt, k))(
        jax.random.PRNGKey(0))
    for it in range(5):
        r_state, _ = r_step(r_state, pipe.batch(it))
    d = str(tmp_path / "ref")
    ref_checkpoint.save(d, 5, r_state)

    p_opt = optim.AdamW(lr=lambda s: torch.tensor(1e-3))
    state, s0 = train_mod.init_or_restore(papi, p_opt, d, seed=0,
                                          device="cpu")
    assert s0 == 5 and int(state.step) == 5
    step = make_train_step(papi, p_opt, loss_chunk=8, donate=True)
    for it in range(5, 8):
        batch = pipe.batch(it)
        r_state, m_r = r_step(r_state, batch)
        state, m = step(state, _batch_t(batch))
        np.testing.assert_allclose(float(m["loss"]), float(m_r["loss"]),
                                   rtol=1e-5, err_msg=f"step {it}")
    d2 = str(tmp_path / "port")
    checkpoint.save(d2, 8, state)
    back, s1 = ref_checkpoint.restore(d2, jax.eval_shape(lambda: r_state))
    assert s1 == 8
    for a, b in zip(jax.tree.leaves(back), tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), bridge.to_numpy(b))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "xlstm-125m",
                                  "recurrentgemma-9b", "whisper-base"])
def test_train_state_tree_is_the_references(arch):
    """Each family's TrainState flattens to the reference's leaf paths
    (the checkpoint format), and crosses the bridge both ways bit for
    bit."""
    rapi, papi = ref_build(ref_configs.get_reduced(arch)), build(
        configs.get_reduced(arch))
    r_opt = ref_optim.AdamW(lr=lambda s: 1e-3)
    want = jax.eval_shape(lambda k: ref_init_train_state(rapi, r_opt, k),
                          jax.random.PRNGKey(0))
    params = papi.init(torch.Generator().manual_seed(0), device="cpu")
    opt = optim.AdamW(lr=lambda s: 1e-3)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    leaves, paths = tree.flatten_with_paths(state)
    r_leaves, r_paths, _ = ref_checkpoint._flatten_with_paths(want)
    assert paths == r_paths
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in r_leaves]
    back = bridge.train_state_from_numpy(bridge.to_numpy(state), "cpu")
    for a, b in zip(tree.leaves(back), leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------------------- CLI

def test_train_cli_on_the_cpu(capsys):
    state, history = train_mod.main(
        ["--arch", "qwen3-1.7b", "--reduced", "--steps", "3", "--batch",
         "2", "--seq", "16", "--loss-chunk", "8", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step      1  loss ") and "ms/step" in out[0]
    assert out[-1].startswith("final loss: ")
    assert int(state.step) == 3 and history[0]["step"] == 1
    assert all(np.isfinite(h["loss"]) for h in history)


def test_train_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenPipeline(vocab=11, seq_len=4, global_batch=1).batch(0)


def test_train_cli_refuses_a_model_axis():
    with pytest.raises(ValueError, match="sharding"):
        train_mod.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1",
                        "--model-axis", "2", "--device", "cpu"])
