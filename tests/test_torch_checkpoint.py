"""The port's checkpoints: round trip, retention, async save, bfloat16
leaves, files that either package reads from the other, and a bit-exact
restart of the DP trainer on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dp_model as jax_dp
from repro.core.types import DPConfig as JaxDPConfig
from repro.train import checkpoint as jax_ckpt
from repro.train import optim as jax_optim
from repro.train.steps import TrainState as JaxTrainState
from repro_torch import bridge
from repro_torch.core import dp_model
from repro_torch.core.types import DPConfig
from repro_torch.train import checkpoint, dp_trainer, tree
from repro_torch.train.steps import TrainState

# One torch thread: the suite's pytest workers already occupy the cores.
torch.set_num_threads(1)

CPU = "cpu"
TINY = dict(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(48,), type_map=("Cu",),
            embed_widths=(8, 16, 32), axis_neuron=4, fit_widths=(32, 32, 32))


def _mixed(offset):
    """float32, a 0-d int32 and bfloat16 leaves, dict keys out of order."""
    return {"b": {"d": torch.ones(4, dtype=torch.bfloat16) * (1 + offset),
                  "c": torch.tensor(3 + offset, dtype=torch.int32)},
            "a": torch.arange(6, dtype=torch.float32).reshape(2, 3) + offset}


def _assert_trees_equal(got, want):
    g_leaves, g_paths = tree.flatten_with_paths(got)
    w_leaves, w_paths = tree.flatten_with_paths(want)
    assert g_paths == w_paths
    for path, g, w in zip(g_paths, g_leaves, w_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path


def test_roundtrip_and_retention(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        checkpoint.save(d, s, _mixed(s), keep=2)
    assert checkpoint.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    restored, step = checkpoint.restore(d, _mixed(0))
    assert step == 4
    _assert_trees_equal(restored, _mixed(4))
    assert restored["b"]["d"].dtype == torch.bfloat16
    old, _ = checkpoint.restore(d, _mixed(0), step=3)
    _assert_trees_equal(old, _mixed(3))
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(d, {"a": torch.zeros(2, 3)})


def test_async_save(tmp_path):
    state = _mixed(7)
    handle = checkpoint.save_async(str(tmp_path), 7, state)
    path = handle.wait()
    assert os.path.isdir(path) and path.endswith("step_00000007")
    restored, step = checkpoint.restore(str(tmp_path), _mixed(0))
    assert step == 7
    _assert_trees_equal(restored, state)


def test_restore_without_checkpoints_raises(tmp_path):
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path), _mixed(0))


def _jax_train_state():
    """The reference's DP TrainState one AdamW update in (moments nonzero);
    jitted, since eager JAX compiles every primitive anew."""
    cfg = JaxDPConfig(**TINY)
    params = jax.jit(jax_dp.init_dp_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    opt = jax_optim.AdamW(lr=jax_optim.exp_decay_schedule(1e-3, 500, 0.95),
                          weight_decay=0.0)
    grads = jax.tree.map(lambda p: 0.5 * p, params)
    new, opt_state, _ = jax.jit(opt.update)(grads, opt.init(params), params)
    before = JaxTrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    after = JaxTrainState(new, opt_state, jnp.ones((), jnp.int32))
    return before, after


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _mixed_jax(offset):
    return jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        {torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32,
         torch.float32: jnp.float32}[t.dtype]), _mixed(offset),
        is_leaf=lambda x: isinstance(x, torch.Tensor))


@pytest.mark.parametrize("kind", ["train_state", "bfloat16_tree"])
def test_checkpoints_cross_between_packages(tmp_path, kind):
    """A file saved by the reference restores in the port leaf for leaf, and
    one saved by the port restores in the reference; the two manifests are
    equal (step, paths, dtypes, shapes)."""
    if kind == "train_state":
        j_before, j_after = _jax_train_state()
        t_before = bridge.train_state_from_numpy(_np(j_before), CPU)
        t_after = bridge.train_state_from_numpy(_np(j_after), CPU)
        assert isinstance(t_after, TrainState)
    else:
        j_before, j_after = _mixed_jax(0), _mixed_jax(5)
        t_before, t_after = _mixed(0), _mixed(5)
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(j_dir)
    os.makedirs(t_dir)
    j_path = jax_ckpt.save(j_dir, 5, j_after)
    t_path = checkpoint.save(t_dir, 5, t_after)
    assert _manifest(j_path) == _manifest(t_path)

    restored, step = checkpoint.restore(j_dir, t_before)
    assert step == 5
    _assert_trees_equal(restored, t_after)

    back, step = jax_ckpt.restore(t_dir, j_before)
    assert step == 5
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(j_after)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(want, np.float32))


def test_restart_is_bitwise_deterministic(tmp_path):
    """The reference's restart test on the DP trainer: 5 steps, save, 3
    more; restored, the same 3 steps give equal losses and parameters."""
    cfg = DPConfig(**TINY)
    gen = torch.Generator().manual_seed(0)
    teacher = dp_model.init_dp_params(gen, cfg, device=CPU)
    data = dp_trainer.teacher_data(cfg, teacher, n_configs=4, device=CPU)
    loss_cfg = dp_trainer.DPLossConfig()
    opt = dp_trainer.make_optimizer(loss_cfg)
    student = dp_trainer.fit_env_stats(
        dp_model.init_dp_params(gen, cfg, device=CPU), cfg, data)
    state = TrainState(student, opt.init(student),
                       torch.zeros((), dtype=torch.int32))
    step = dp_trainer.make_dp_train_step(cfg, loss_cfg, opt)
    rng = np.random.default_rng(0)
    batches = [dp_trainer.minibatch(data, rng.integers(0, 4, 2))
               for _ in range(8)]
    for mb in batches[:5]:
        state, _ = step(state, mb)
    checkpoint.save(str(tmp_path), 5, state)

    def run_on(s):
        losses = []
        for mb in batches[5:]:
            s, m = step(s, mb)
            losses.append(float(m["loss"]))
        return s, losses

    sa, cont_a = run_on(state)
    zeros = tree.tree_map(torch.zeros_like, state)
    restored, s0 = checkpoint.restore(str(tmp_path), zeros)
    assert s0 == 5 and int(restored.step) == 5
    _assert_trees_equal(restored, state)
    sb, cont_b = run_on(restored)
    assert cont_a == cont_b
    _assert_trees_equal(sb, sa)
