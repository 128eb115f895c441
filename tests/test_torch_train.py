"""The port's Deep Potential trainer against the reference's.

Same numpy inputs and the same weights (the reference's pytree through
``bridge``) go through ``repro.train`` and ``repro_torch.train``, on the
reference's two tiny configurations of ``examples/train_dp.py`` (copper
sel 48 at rcut 4: ~70% of the slots are padding, so the double backward
runs through padded slots). The reference's ``batch_energy_forces`` runs
under ``jax.jit`` here, as its train step runs it, and so does its
``init_dp_params`` (eager, JAX compiles every primitive anew: ~15 s a
system).

Tolerances: energies rtol 1e-5 and forces atol 1e-5 x max(1, max|F|) (f32
sums in another order); loss gradients rtol 1e-4 with atol 1e-5 x max|g| of
the leaf; AdamW rtol 1e-6; train-step metrics rtol 1e-4, parameters after
five steps atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dp_model as jax_dp
from repro.core.types import DPConfig as JaxDPConfig
from repro.train import dp_trainer as jax_tr
from repro.train import optim as jax_optim
from repro.train.steps import TrainState as JaxTrainState
from repro_torch import bridge
from repro_torch.core.types import DPConfig
from repro_torch.train import dp_trainer, optim, tree

# One torch thread: the suite's pytest workers already occupy the cores.
torch.set_num_threads(1)

CPU = "cpu"
B = 3
# examples/train_dp.py's two configurations; water on one 192-atom cell
SYSTEMS = {
    "copper": (dict(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(48,),
                    type_map=("Cu",), embed_widths=(8, 16, 32),
                    axis_neuron=4, fit_widths=(32, 32, 32)), (2, 2, 2)),
    "water": (dict(ntypes=2, rcut=4.0, rcut_smth=0.5, sel=(16, 32),
                   type_map=("O", "H"), embed_widths=(8, 16, 32),
                   axis_neuron=4, fit_widths=(32, 32, 32)), (1, 1, 1)),
}


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _jax_optimizer():
    lc = jax_tr.DPLossConfig()
    return jax_optim.AdamW(
        lr=jax_optim.exp_decay_schedule(lc.lr_start, lc.lr_decay_steps,
                                        lc.lr_decay_rate),
        weight_decay=0.0, grad_clip=1.0)


@pytest.fixture(scope="module", params=sorted(SYSTEMS))
def case(request):
    """Both packages' teacher data (B configurations) and the student after
    ``fit_env_stats``, from the reference's weights."""
    name = request.param
    kw, supercell = SYSTEMS[name]
    jcfg, cfg = JaxDPConfig(**kw), DPConfig(**kw)
    init = jax.jit(jax_dp.init_dp_params, static_argnums=1)
    teacher = init(jax.random.PRNGKey(1), jcfg)
    student = init(jax.random.PRNGKey(2), jcfg)
    data_kw = dict(n_configs=B, supercell=supercell, seed=0, system=name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tr, "batch_energy_forces", jax.jit(
            jax_tr.batch_energy_forces, static_argnames=("cfg", "impl")))
        jdata = jax_tr.teacher_data(jcfg, teacher, **data_kw)
        jstudent = jax_tr.fit_env_stats(student, jcfg, jdata)
    tdata = dp_trainer.teacher_data(
        cfg, bridge.params_from_numpy(_np(teacher), CPU), device=CPU,
        **data_kw)
    tstudent = dp_trainer.fit_env_stats(
        bridge.params_from_numpy(_np(student), CPU), cfg, tdata)
    return dict(name=name, jcfg=jcfg, cfg=cfg, jdata=jdata, tdata=tdata,
                jstudent=jstudent, tstudent=tstudent)


def _assert_forces(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_teacher_data_and_env_stats_match_reference(case):
    jd, td = case["jdata"], case["tdata"]
    for name in ("rij", "nmask", "atype", "nlist"):
        want = np.asarray(getattr(jd, name))
        got = getattr(td, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_allclose(td.e_ref.numpy(), np.asarray(jd.e_ref),
                               rtol=1e-5)
    _assert_forces(td.f_ref.numpy(), jd.f_ref)
    np.testing.assert_allclose(case["tstudent"]["dstd"].numpy(),
                               np.asarray(case["jstudent"]["dstd"]),
                               rtol=1e-6)


def test_batch_energy_forces_matches_reference(case):
    jd, td = case["jdata"], case["tdata"]
    e_j, f_j = jax.jit(jax_tr.batch_energy_forces,
                       static_argnames=("cfg", "impl"))(
        case["jstudent"], case["jcfg"], jd, impl="mlp")
    e_t, f_t = dp_trainer.batch_energy_forces(case["tstudent"], case["cfg"],
                                              td, impl="mlp")
    assert e_t.shape == (B,) and f_t.shape == td.f_ref.shape
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5)
    _assert_forces(f_t.numpy(), f_j)


def _jax_loss_grads(params, cfg, batch, step):
    """The reference train step's loss (``dp_trainer.py`` ``loss_fn``) and
    its gradient with respect to every leaf."""
    lc = jax_tr.DPLossConfig()
    lr_fn = _jax_optimizer().lr

    def loss_fn(p):
        e, f = jax_tr.batch_energy_forces(p, cfg, batch, impl="mlp")
        na = batch.rij.shape[1]
        l_e = jnp.mean((e - batch.e_ref) ** 2) / na ** 2
        l_f = jnp.mean((f - batch.f_ref) ** 2)
        frac = lr_fn(step) / lc.lr_start
        p_e = lc.pref_e_limit + (lc.pref_e_start - lc.pref_e_limit) * frac
        p_f = lc.pref_f_limit + (lc.pref_f_start - lc.pref_f_limit) * frac
        return p_e * l_e + p_f * l_f

    return jax.jit(jax.value_and_grad(loss_fn))(params)


def test_loss_gradients_of_every_leaf_match_reference(case):
    """The double backward: d loss / d weights through the forces, for every
    leaf (embed, fit, dstd, ebias), on a batch with padded slots."""
    td = case["tdata"]
    assert not bool(td.nmask.all()), "the batch must hold padded slots"
    step = 7
    loss_j, g_j = _jax_loss_grads(case["jstudent"], case["jcfg"],
                                  case["jdata"], jnp.asarray(step, jnp.int32))
    train_step = dp_trainer.make_dp_train_step(
        case["cfg"], dp_trainer.DPLossConfig(),
        dp_trainer.make_optimizer(dp_trainer.DPLossConfig()))
    loss_t, _, g_t = train_step.loss_and_grads(
        case["tstudent"], td, torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    want, paths = tree.flatten_with_paths(_np(g_j))
    got, got_paths = tree.flatten_with_paths(g_t)
    assert got_paths == paths
    assert {p.split("/")[0] for p in paths} == {"dstd", "ebias", "embed",
                                                "fit"}
    for path, g, w in zip(paths, got, want):
        g = g.numpy()
        assert np.all(np.isfinite(g)) and np.all(np.isfinite(w)), path
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=path)


def test_five_train_steps_match_reference(case):
    jopt = _jax_optimizer()
    jstep = jax_tr.make_dp_train_step(case["jcfg"], jax_tr.DPLossConfig(),
                                      jopt)
    jstate = JaxTrainState(case["jstudent"], jopt.init(case["jstudent"]),
                           jnp.zeros((), jnp.int32))
    tstate = bridge.train_state_from_numpy(_np(jstate), CPU)
    assert tstate.step.dtype == torch.int32 and tstate.step.dim() == 0
    assert tstate.opt.count.dtype == torch.int32
    tstep = dp_trainer.make_dp_train_step(
        case["cfg"], dp_trainer.DPLossConfig(),
        dp_trainer.make_optimizer(dp_trainer.DPLossConfig()))
    rng = np.random.default_rng(0)
    for _ in range(5):
        idx = rng.integers(0, B, 2)
        jstate, jm = jstep(jstate, jax.tree.map(lambda x: x[idx],
                                                case["jdata"]))
        tstate, tm = tstep(tstate, dp_trainer.minibatch(case["tdata"], idx))
        for k in ("loss", "rmse_e_atom", "rmse_f", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
    # Adam moves each weight by about +-lr on its first steps, whatever the
    # gradient's size; these inputs have no entry whose gradient is float
    # noise, so the parameters hold at atol 1e-5 (lr is 1e-3).
    want, paths = tree.flatten_with_paths(_np(jstate))
    got, got_paths = tree.flatten_with_paths(tstate)
    assert got_paths == paths
    for path, g, w in zip(paths, got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5,
                                   err_msg=path)
    assert int(tstate.step) == 5 and int(tstate.opt.count) == 5


def _adamw_tree(rng, grid=None):
    """A tree with a 2-D, a 1-D and a 3-D leaf; values on a grid of step
    ``grid`` if given."""
    def draw(shape):
        x = rng.normal(size=shape) * 4.0
        return (x if grid is None else np.round(x / grid) * grid).astype(
            np.float32)
    return {"w": draw((3, 4)), "b": draw((4,)),
            "blocks": [{"k": draw((2, 2, 2))}]}


@pytest.mark.parametrize("grads", ["grid", "normal"])
@pytest.mark.parametrize("schedule", ["exp_decay", "cosine"])
def test_adamw_matches_reference(schedule, grads):
    """Five updates with clipping active (|g| ~ 20 > 1), weight decay on
    the 2-D and 3-D leaves only, and either schedule.

    The two packages sum the squares of a leaf in another order (XLA in
    sequence for short leaves, torch in vector lanes), so their global
    norms may differ in the last bit. On gradients of a 1/4 grid every sum
    is exact and the norms are equal: then the moments are held too (a
    moment is a running sum, so a last-bit change of the norm shows in it
    relatively where its terms cancel). On normal draws the norms and the
    parameters are held.
    """
    rng = np.random.default_rng(3)
    params = _adamw_tree(rng)
    make = {"exp_decay": lambda m: m.exp_decay_schedule(1e-2, 3, 0.5),
            "cosine": lambda m: m.cosine_schedule(1e-2, 2, 6)}[schedule]
    jopt = jax_optim.AdamW(lr=make(jax_optim), weight_decay=0.1,
                           grad_clip=1.0)
    topt = optim.AdamW(lr=make(optim), weight_decay=0.1, grad_clip=1.0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = bridge.params_from_numpy(params, CPU)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        g = _adamw_tree(rng, 0.25 if grads == "grid" else None)
        gt = bridge.params_from_numpy(g, CPU)
        g = jax.tree.map(jnp.asarray, g)
        norm_t, norm_j = optim.global_norm(gt), jax_optim.global_norm(g)
        jp, js, jn = jopt.update(g, js, jp)
        tp, ts, tn = topt.update(gt, ts, tp)
        assert float(tn) == float(norm_t) > 1.0     # clipping is active
        if grads == "grid":
            assert float(norm_t) == float(norm_j)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    pairs = [(tp, jp)] + ([(ts.mu, js.mu), (ts.nu, js.nu)]
                          if grads == "grid" else [])
    for t_tree, j_tree in pairs:
        for got, want in zip(tree.leaves(t_tree), tree.leaves(_np(j_tree))):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert int(ts.count) == int(js.count) == 5
    assert ts.count.dtype == torch.int32


def test_dp_training_converges():
    """The reference's ``test_dp_training_converges``, on the port alone."""
    cfg = DPConfig(**SYSTEMS["copper"][0])
    _, log = dp_trainer.train_dp(cfg, steps=120, n_configs=8, batch_size=4,
                                 log_every=40, verbose=False, device=CPU)
    assert log[-1]["rmse_f"] < 0.3 * log[0]["rmse_f"]
    assert all(np.isfinite(row["loss"]) for row in log)
