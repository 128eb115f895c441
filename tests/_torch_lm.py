"""Shared helpers of the LM parity tests (``tests/test_torch_lm_*.py``).

Both packages run one parameter tree. The port draws it on the CPU from
seed 0 (its trunc-normal init is the reference's distribution; the tree,
shapes and dtypes equal the reference's init, which
``test_torch_lm_layers.py`` holds) and the reference reads it as numpy
through ``bridge.to_numpy``; one test also carries the reference's own
init across with ``bridge.params_from_numpy``. Skipping the reference's
init saves its compile (1-5 s an architecture). The reference's functions
run compiled (``ref_jit``), as its serving loop runs them, with XLA's
excess precision off: by default XLA keeps a fusion's bf16 intermediates
in f32, which the reference's op-by-op (eager) semantics do not, and
which can flip an MoE routing decision (reduced qwen2-moe's jitted prefill
sits 1.19 from its own eager run at a decode step, the port 0.03 from it).
Every torch op rounds to bf16, as eager JAX does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.models import build as ref_build
from repro.models import encdec as ref_encdec
from repro.models import transformer as ref_transformer
from repro_torch import bridge, configs
from repro_torch.models import build, encdec, moe
from repro_torch.train import tree
from repro_torch.train.steps import make_serve_step

ARCHS = configs.all_archs()
F32, BF16 = "float32", "bfloat16"
# a router gap under which bf16 rounding may pick another top-k expert
NEAR_TIE = 1e-2


def cfgs(arch: str, dtype: str = F32, **moe):
    """(reference config, port config) of ``arch``'s REDUCED size in
    ``dtype``; ``moe`` replaces MoEConfig fields in both."""
    out = []
    for reg in (ref_configs, configs):
        c = reg.get_reduced(arch)
        if moe:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
        out.append(dataclasses.replace(c, dtype=dtype))
    return tuple(out)


def ref_jit(fn):
    """``fn`` compiled by XLA with excess precision off, per input shapes."""
    compiled = {}

    def call(*args):
        key = jax.tree.structure(args), tuple(
            (np.shape(a), str(np.asarray(a).dtype) if not hasattr(a, "dtype")
             else str(a.dtype)) for a in jax.tree.leaves(args))
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled[key](*args)

    return call


def apis(arch: str, dtype: str = F32, **moe):
    rc, pc = cfgs(arch, dtype, **moe)
    return ref_build(rc), build(pc)


@functools.lru_cache(maxsize=None)
def port_params(arch: str):
    """The port's weights of ``arch``'s REDUCED config (seed 0, CPU);
    the compute dtype does not enter the (f32 master) tree."""
    return build(configs.get_reduced(arch)).init(
        torch.Generator().manual_seed(0), device="cpu")


@functools.lru_cache(maxsize=None)
def ref_params(arch: str):
    """The same weights for the reference."""
    return jax.tree.map(jnp.asarray, bridge.to_numpy(port_params(arch)))


def inputs(cfg, b: int = 2, s: int = 12, seed: int = 0):
    """(reference kwargs, port kwargs) of a forward: tokens, or llava's
    stub embeddings, plus whisper's stub frames; numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    arrs = {}
    if cfg.frontend == "vision_stub":
        arrs["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    else:
        arrs["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.family == "encdec":
        arrs["frames"] = rng.normal(
            size=(b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v).long() if k == "tokens"
             else torch.from_numpy(v) for k, v in arrs.items()})


def tokens(vocab: int, b: int = 2, s: int = 12, seed: int = 7):
    t = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    return jnp.asarray(t), torch.from_numpy(t).long()


def f32(x) -> np.ndarray:
    """A result of either package as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, rtol: float = 1e-4, scale_atol: float = 1e-4,
          what: str = ""):
    """allclose with atol scaled by max(1, max|want|)."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=scale_atol * max(1.0, float(np.abs(want).max())), err_msg=what)


def close_bf16(got, want, what: str = ""):
    """The reference's own bf16 tolerance (test_lm_consistency.py)."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.08, atol=0.05,
                               err_msg=what)


def close_trees(got, want, rtol: float = 1e-4, scale_atol: float = 1e-4,
                what: str = "", cmp=None):
    """Every leaf of a port tree against the reference's (same order),
    by ``close`` at (rtol, scale_atol) or by ``cmp``."""
    g = jax.tree.leaves(bridge.to_numpy(got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert np.shape(a) == np.shape(b), f"{what} leaf {i}"
        if np.asarray(b).ndim == 0:
            assert int(a) == int(b), f"{what} leaf {i}"
        else:
            if cmp is None:
                close(a, b, rtol, scale_atol, f"{what} leaf {i}")
            else:
                cmp(a, b, what=f"{what} leaf {i}")


def _cmp(dtype):
    return close if dtype == F32 else close_bf16


def clone(cache):
    return tree.tree_map(lambda t: t.clone(), cache)


# ----------------------------------------------------- shared test bodies

def check_forward(arch: str, dtype: str) -> None:
    """Teacher-forced logits (and MoE aux) against the reference's: f32 at
    rtol 1e-4, atol 1e-4 x max(1, max|logit|); bf16 at the reference's
    0.08 / 0.05. xLSTM's bf16 logits are held otherwise: a rounding flip
    in one block grows through its recurrences, and the reference's own
    bf16 logits lie up to 0.40 from its f32 ones at these inputs (the
    port's 0.35), so the port's bf16 error against the reference's f32
    logits must stay within 1.25x the reference's own, max and mean."""
    rapi, papi = apis(arch, dtype)
    kj, kt = inputs(rapi.cfg)
    rp = ref_params(arch)
    names = sorted(kj)
    fwd = ref_jit(lambda p, *a: rapi.forward(p, **dict(zip(names, a))))
    logits_r, aux_r = fwd(rp, *[kj[n] for n in names])
    logits, aux = papi.forward(port_params(arch), **kt)
    close(aux, aux_r, what="aux")
    if dtype == F32 or papi.cfg.family != "ssm":
        _cmp(dtype)(logits, logits_r, what=f"{arch} {dtype} logits")
        return
    ref32 = f32(ref_jit(lambda p, *a: apis(arch)[0].forward(
        p, **dict(zip(names, a))))(rp, *[kj[n] for n in names])[0])
    err_port = np.abs(f32(logits) - ref32)
    err_ref = np.abs(f32(logits_r) - ref32)
    assert err_port.max() <= 1.25 * err_ref.max(), (err_port.max(),
                                                     err_ref.max())
    assert err_port.mean() <= 1.25 * err_ref.mean(), (err_port.mean(),
                                                      err_ref.mean())


@contextlib.contextmanager
def routing_margins():
    """Record each call of the port's router: every token's gap between
    its k-th and (k+1)-th router probability, (B, S)."""
    seen, orig = [], moe.route

    def route(p, cfg, x):
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        top = probs.sort(dim=-1, descending=True).values
        k = cfg.moe.top_k
        seen.append((top[..., k - 1] - top[..., k]).detach().numpy())
        return orig(p, cfg, x)

    moe.route = route
    try:
        yield seen
    finally:
        moe.route = orig


def _tied(seen, b):
    """Rows with a routing decision of gap < NEAR_TIE since the last call
    (then clears the record)."""
    tied = np.zeros(b, bool)
    for g in seen:
        tied |= g.reshape(b, -1).min(1) < NEAR_TIE
    seen.clear()
    return tied


def check_prefill_decode(arch: str, dtype: str, k0: int = 8,
                         s: int = 12) -> None:
    """prefill of the first k0 tokens, then one decode step a token: the
    logits of each and the caches (k, v, length) against the reference's.

    In bf16 an MoE router's near-tie (top-k gap < NEAR_TIE) may go either
    way on a one-ulp difference of its input (seen: reduced qwen2-moe,
    gap 3.6e-4, expert 1 against 3, logits 0.69 apart). A batch row whose
    logits miss the tolerance there is left out of the comparison from
    then on, but only if one of its routing decisions so far was such a
    near-tie; at least one row must stay in to the end. f32 compares every
    row.
    """
    rapi, papi = apis(arch, dtype)
    rc = rapi.cfg
    cmp = _cmp(dtype)
    rp, pp = ref_params(arch), port_params(arch)
    tj, tt = tokens(rc.vocab, s=s)
    b, max_len = tt.shape[0], s + 4
    rows = np.ones(b, bool)             # rows still compared
    tied = np.zeros(b, bool)            # rows with a near-tie so far
    moe_bf16 = dtype == BF16 and rc.family == "moe"

    def compare(logits, logits_r, what):
        nonlocal rows
        if moe_bf16:
            got, want = f32(logits), f32(logits_r)
            ok = np.all(np.abs(got - want) <= 0.05 + 0.08 * np.abs(want),
                        axis=-1)
            assert np.all(ok | ~rows | tied), (what, ok, tied)
            rows &= ok
        cmp(logits[torch.from_numpy(rows)], f32(logits_r)[rows], what=what)

    with routing_margins() as seen:
        logits_r, cache_r = ref_jit(lambda p, t: ref_transformer.prefill(
            p, rc, t, max_len))(rp, tj[:, :k0])
        logits, cache = papi.prefill(pp, tt[:, :k0], max_len)
        tied |= _tied(seen, b)
        compare(logits, logits_r, "prefill")
        dec = ref_jit(rapi.decode_step)
        for t in range(k0, s):
            logits_r, cache_r = dec(rp, tj[:, t:t + 1], cache_r)
            logits, cache = papi.decode_step(pp, tt[:, t:t + 1], cache)
            tied |= _tied(seen, b)
            compare(logits, logits_r, f"decode pos {t}")
    assert rows.any()
    assert int(cache.length) == int(cache_r.length) == s
    keep = torch.from_numpy(rows)
    for got, want in ((cache.k, cache_r.k), (cache.v, cache_r.v)):
        cmp(got[:, keep], f32(want)[:, rows], what="cache")


def _caches(arch, rapi, papi, kj, kt, b, max_len):
    if rapi.cfg.family == "encdec":
        return (ref_encdec.init_cache(ref_params(arch), rapi.cfg, b, max_len,
                                      frames=kj["frames"]),
                encdec.init_cache(port_params(arch), papi.cfg, b, max_len,
                                  frames=kt["frames"]))
    return (rapi.init_cache(ref_params(arch), b, max_len),
            papi.init_cache(port_params(arch), b, max_len))


def check_recurrent_decode(arch: str, s: int = 10) -> None:
    """Stateful decode from scratch (f32): each step's logits and the
    final state against the reference's."""
    rapi, papi = apis(arch)
    kj, kt = inputs(rapi.cfg, s=s, seed=9)
    cache_r, cache = _caches(arch, rapi, papi, kj, kt, 2, s + 2)
    dec = ref_jit(rapi.decode_step)
    for t in range(s):
        logits_r, cache_r = dec(ref_params(arch), kj["tokens"][:, t:t + 1],
                                cache_r)
        logits, cache = papi.decode_step(port_params(arch),
                                         kt["tokens"][:, t:t + 1], cache)
        close(logits, logits_r, what=f"pos {t}")
    close_trees(cache, cache_r, what="state")


def check_serve_step(arch: str) -> None:
    """make_serve_step's step equals api.decode_step, bit for bit."""
    rapi, papi = apis(arch)
    pp = port_params(arch)
    kj, kt = inputs(papi.cfg, s=6, seed=3)
    toks = tokens(papi.cfg.vocab, s=6, seed=3)[1]
    if papi.prefill is not None:
        _, cache = papi.prefill(pp, toks[:, :5], 8)
    else:
        _, cache = _caches(arch, rapi, papi, kj, kt, 2, 8)
    step = make_serve_step(papi)
    tok = toks[:, 5:6]
    logits_a, cache_a = papi.decode_step(pp, tok, clone(cache))
    logits_b, cache_b = step(pp, tok, clone(cache))
    assert torch.equal(logits_a, logits_b)
    for a, b in zip(tree.leaves(cache_a), tree.leaves(cache_b)):
        assert torch.equal(a, b)
