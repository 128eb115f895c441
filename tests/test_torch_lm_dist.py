"""Sharded LM training on 4 gloo CPU processes against one device: the
port's sharding (``repro_torch.sharding``) with REDUCED qwen3-1.7b, seq 32,
global batch 8, on a 2 x 2 (data, model) grid.

The reference's own FSDP check (``tests/distributed/run_lm_dist.py``)
fails on the installed JAX, so the oracle is the single-device step, the
port's and the reference's (the same init through ``bridge``, the same
batches), with that check's tolerances: losses within 5e-3 over 6 steps in
bf16, the elastic restart within 2e-2. f32 runs hold 1e-4, the bound set
for them beforehand (REDUCED with vocab 512, so that the vocab split of
the head and the loss is held too: REDUCED's 503 does not divide). The
f32 steps also run on (1, 4), whose model axis does not divide REDUCED's
2 kv heads (k/v whole on it, their gradient a partial sum, as qwen3's 8 kv
heads on the production grid's 16). Every f32 gradient leaf of the first
batch is held to the single device's within GRAD_TOL of its largest
entry, and sharded prefill and decode (serve plan, sequence-split cache)
to the single device's logits within SERVE_TOL of the largest logit:
f32 summation order alone, about 10x what a first run read (2.8e-6 and
9e-7); a missing or doubled partial sum is off by 0.5 or more.

The workers (``tests/_torch_lm_dist_worker.py``) run once for the module;
the test process holds their results against both single-device runs.

The other four families (``worker.families``, spawned once for all of
them): REDUCED granite-moe-1b-a400m (drop-free), qwen2-moe-a2.7b (capacity
1.25: drops), xlstm-125m (2 heads, uneven on (1, 4)), recurrentgemma-9b and
whisper-base, f32 with vocab 512, on (2, 2) and (1, 4): the init bit for
bit, the gradients' placements, every gradient leaf within GRAD_TOL and
sharded prefill and decode within SERVE_TOL (xLSTM within RECURRENT_TOL,
below), 3 steps within 1e-4 of both single devices; and the
expert-parallel ``moe_ffn`` with drops on (1, 4) within 1e-5 of one
device, each rank holding and running e_pad / 4 experts.
RECURRENT_TOL: on the first run xLSTM's gradient leaves read up to 1.6e-5
of their largest entry and its decode logits 7.6e-6 of the largest logit
(f32 sums in another order, carried through its recurrences; the other
families 2.9e-6 and 1.1e-6 or less), so xLSTM is held at 1e-4, as far
below the 0.5 of a missing or doubled partial sum.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import _torch_lm_dist_worker as worker  # noqa: E402
from _torch_lm import ref_jit  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.train import checkpoint as ref_checkpoint  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro.train.steps import TrainState as RefTrainState  # noqa: E402
from repro.train.steps import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train import tree  # noqa: E402
from repro_torch.train.steps import init_train_state, make_train_step  # noqa: E402

torch.set_num_threads(1)

TOL = {"bfloat16": 5e-3, "float32": 1e-4}
RESTART_TOL = 2e-2
GRAD_TOL = 1e-5      # of a leaf's largest |gradient|
RECURRENT_TOL = 1e-4  # the ssm family's gradients and logits (docstring)
MOE_TOL = 1e-5       # expert-parallel moe_ffn: of the largest |value|
SERVE_TOL = 1e-5     # of the largest |logit|
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(fn, out, name):
    """``fn`` in 4 spawned gloo processes; rank 0's ``<out>/<name>``."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=(_free_port(), str(out)), nprocs=4, join=False,
        start_method="spawn")
    deadline = time.monotonic() + 300
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "gloo ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    with np.load(out / name) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The workers' results and their output directory."""
    out = tmp_path_factory.mktemp("lm_dist")
    return _spawn(worker.worker, out, "result.npz"), out


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """The other four families' workers' results."""
    return _spawn(worker.families, tmp_path_factory.mktemp("lm_families"),
                  "families.npz")


@functools.lru_cache(maxsize=None)
def _port_losses(dtype):
    cfg = worker.config(dtype)
    api = build(cfg)
    state = init_train_state(api, worker.opt(),
                             torch.Generator().manual_seed(worker.SEED),
                             "cpu")
    step = make_train_step(api, worker.opt(), loss_chunk=worker.LOSS_CHUNK,
                           donate=True)
    losses = []
    for b in worker.batches(cfg):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        losses.append(float(m["loss"]))
    return np.asarray(losses)


@functools.lru_cache(maxsize=None)
def _ref_losses(dtype):
    """The reference's single-device steps from the port's init."""
    cfg = worker.config(dtype)
    params = build(cfg).init(torch.Generator().manual_seed(worker.SEED),
                             device="cpu")
    rp = jax.tree.map(jnp.asarray, bridge.to_numpy(params))
    opt = ref_optim.AdamW(lr=lambda s: worker.LR)
    state = RefTrainState(rp, opt.init(rp), jnp.zeros((), jnp.int32))
    rcfg = dataclasses.replace(ref_configs.get_reduced("qwen3-1.7b"),
                               dtype=cfg.dtype, vocab=cfg.vocab)
    step = ref_jit(ref_make_train_step(ref_build(rcfg), opt,
                                       loss_chunk=worker.LOSS_CHUNK))
    losses = []
    for b in worker.batches(cfg):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return np.asarray(losses)


@pytest.mark.parametrize("dtype", worker.DTYPES)
def test_sharded_init_equals_single_device(sharded, dtype):
    assert bool(sharded[0][f"{dtype}/init_equal"])


@pytest.mark.parametrize("dtype", worker.DTYPES)
def test_gradients_land_in_their_params_placements(sharded, dtype):
    assert bool(sharded[0][f"{dtype}/placements_equal"])


@pytest.mark.parametrize("dtype", worker.DTYPES)
def test_sharded_steps_match_single_device(sharded, dtype):
    got = sharded[0][f"{dtype}/losses"]
    port, ref = _port_losses(dtype), _ref_losses(dtype)
    assert got.shape == (worker.STEPS,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, port, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL[dtype])
    assert got[-1] < got[0]


def test_sharded_steps_on_1x4_match_single_device(sharded):
    got = sharded[0]["float32/losses_1x4"]
    assert got.shape == (worker.STEPS,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, _port_losses("float32"), rtol=0,
                               atol=TOL["float32"])
    np.testing.assert_allclose(got, _ref_losses("float32"), rtol=0,
                               atol=TOL["float32"])


@pytest.mark.parametrize("grid", worker.GRIDS)
def test_sharded_gradients_equal_single_device(sharded, grid):
    errs = sharded[0][f"grads/{grid}"]
    assert errs.shape == (14,)                  # every leaf of REDUCED qwen3
    assert errs.max() <= GRAD_TOL, errs


@pytest.mark.parametrize("grid", worker.GRIDS)
def test_sharded_prefill_and_decode_match_single_device(sharded, grid):
    res = sharded[0]
    for phase in ("prefill", "decode"):
        err = float(res[f"serve/{grid}/{phase}"])
        assert err <= SERVE_TOL * float(res["serve/scale"]), (phase, err)


def test_elastic_restart_onto_another_grid(sharded):
    res, out = sharded
    np.testing.assert_allclose(res["restart/after"], res["restart/before"],
                               rtol=RESTART_TOL, atol=RESTART_TOL)
    # the reference reads what the sharded run wrote
    cfg = configs.get_reduced("qwen3-1.7b")
    rapi = ref_build(ref_configs.get_reduced("qwen3-1.7b"))
    shapes = jax.eval_shape(rapi.init, jax.random.PRNGKey(0))
    opt = ref_optim.AdamW(lr=lambda s: worker.LR)
    like = RefTrainState(shapes, jax.eval_shape(opt.init, shapes),
                         jax.ShapeDtypeStruct((), jnp.int32))
    state, step = ref_checkpoint.restore(str(out / "ckpt"), like)
    assert step == 3 and int(state.step) == 3
    assert state.params["embed"].shape == (cfg.vocab, cfg.d_model)


def test_train_cli_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--model-axis", "2", "--arch", "qwen3-1.7b",
         "--reduced", "--steps", "3", "--batch", "8", "--seq", "32",
         "--loss-chunk", "16", "--ckpt-dir", str(tmp_path / "ck")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.count("final loss") == 1
    assert (tmp_path / "ck" / "step_00000003").is_dir()


# ------------------------------------------------- the other four families

FAMILY_CASES = [(a, g) for a in worker.FAMILY_ARCHS for g in worker.GRIDS]


@functools.lru_cache(maxsize=None)
def _family_single(arch):
    """(port, reference) single-device losses of the family run."""
    cfg = worker.family_config(arch)
    api = build(cfg)
    state = init_train_state(api, worker.opt(),
                             torch.Generator().manual_seed(worker.SEED),
                             "cpu")
    # copied: the port's donated steps update the params in place, and
    # jnp.asarray may share a host array's memory
    rp = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                      bridge.to_numpy(state.params))
    step = make_train_step(api, worker.opt(), loss_chunk=worker.LOSS_CHUNK,
                           donate=True)
    data = worker.family_batches(cfg)
    port = []
    for b in data:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        port.append(float(m["loss"]))
    opt = ref_optim.AdamW(lr=lambda s: worker.LR)
    rstate = RefTrainState(rp, opt.init(rp), jnp.zeros((), jnp.int32))
    rcfg = dataclasses.replace(ref_configs.get_reduced(arch),
                               dtype=cfg.dtype, vocab=cfg.vocab)
    rstep = ref_jit(ref_make_train_step(ref_build(rcfg), opt,
                                        loss_chunk=worker.LOSS_CHUNK))
    ref = []
    for b in data:
        rstate, m = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        ref.append(float(m["loss"]))
    return np.asarray(port), np.asarray(ref)


@pytest.mark.parametrize("arch,grid", FAMILY_CASES)
def test_family_sharded_init_equals_single_device(families, arch, grid):
    assert bool(families[f"{arch}/{grid}/init_equal"])


@pytest.mark.parametrize("arch,grid", FAMILY_CASES)
def test_family_gradients_land_in_their_params_placements(families, arch,
                                                          grid):
    assert bool(families[f"{arch}/{grid}/placements_equal"])


@pytest.mark.parametrize("arch,grid", FAMILY_CASES)
def test_family_sharded_gradients_equal_single_device(families, arch, grid):
    errs = families[f"{arch}/{grid}/grads"]
    n = len(tree.leaves(build(worker.family_config(arch)).init(
        torch.Generator(), device="meta")))
    tol = RECURRENT_TOL if arch == "xlstm-125m" else GRAD_TOL
    assert errs.shape == (n,) and errs.max() <= tol, errs


@pytest.mark.parametrize("arch,grid", FAMILY_CASES)
def test_family_sharded_steps_match_single_device(families, arch, grid):
    got = families[f"{arch}/{grid}/losses"]
    port, ref = _family_single(arch)
    assert got.shape == (worker.FAMILY_STEPS,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, port, rtol=0, atol=TOL["float32"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL["float32"])


@pytest.mark.parametrize("arch,grid", FAMILY_CASES)
def test_family_sharded_prefill_and_decode_match_single_device(
        families, arch, grid):
    scale = float(families[f"{arch}/{grid}/scale"])
    tol = RECURRENT_TOL if arch == "xlstm-125m" else SERVE_TOL
    for phase in ("prefill", "decode"):
        err = float(families[f"{arch}/{grid}/{phase}"])
        assert err <= tol * scale, (phase, err, scale)


def test_expert_parallel_moe_ffn_with_drops_equals_single_device(families):
    """qwen2-moe's 6 experts pad to 16, 4 a rank on (1, 4): each rank's
    wi/wg/wo and the capacity buffer it fills hold 4 experts."""
    assert int(families["moe/dropped"]) > 0
    assert float(families["moe/out"]) <= MOE_TOL
    grads = families["moe/grads"]
    assert grads.shape == (9,) and grads.max() <= MOE_TOL, grads
    e_pad = int(families["moe/e_pad"])
    assert e_pad == 16
    assert families["moe/local"].tolist() == [e_pad // 4] * 4
