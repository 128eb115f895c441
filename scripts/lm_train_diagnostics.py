"""Why phase 14's xLSTM check (d) holds the loss and not the gradient's
norm: xlstm-125m's gradient at its full CONFIG grows with the sequence,
in the reference as in the port.

On the CPU, both packages (the reference, JAX, beside the port), the same
weights (the port's init from seed 0, carried to the reference as numpy)
and batch (the port's pipeline, seed 0, 2 sequences): the loss of
``make_train_step``'s loss function (``loss_chunk`` 64) and its gradient's
global norm and largest |g| (and which leaf holds it), at sequence 32, 64
and 128 in f32 and at 128 in bf16; then the port alone with the sLSTM
recurrent matrices ``r_zifo`` at std 1/sqrt(head dim) instead of the
init's 1/sqrt(4) (phase 13's rescaling).

``--row-order``: whether the first-step gradient's sensitivity to the
order of a sum is the port's alone. Phase 16 (b) holds the sharded
xlstm-125m against a one-rank run that takes the gradient a batch row at
a time and averages it. Here both packages take that gradient both ways
on the same weights (the port's init from seed 0 with phase 16's
rescaled ``r_zifo``) and batch (2 x 512 tokens, f32, ``loss_chunk``
256), at 8 and 12 layers, and print per package the largest over the
leaves of max |d g| / max |g| (and the median and the leaf).

    PYTHONPATH=src python scripts/lm_train_diagnostics.py    # ~3-5 min
    PYTHONPATH=src python scripts/lm_train_diagnostics.py --row-order
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH = "xlstm-125m"
CHUNK = 64


def report(tag, loss, leaves, paths):
    big = [float(np.abs(x).max()) for x in leaves]
    i = int(np.argmax(big))
    norm = float(np.sqrt(sum(float((np.asarray(x, np.float64) ** 2).sum())
                             for x in leaves)))
    print(f"  {tag}: loss {loss:.5f}, |grad| {norm:.4e}, max|g| "
          f"{big[i]:.4e} in {paths[i]}", flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models import build as ref_build
    from repro.models.losses import chunked_softmax_cross_entropy as ref_ce
    from repro_torch import bridge, configs
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.models import build
    from repro_torch.train import optim, tree
    from repro_torch.train.steps import make_train_step

    torch.set_num_threads(8)
    base = configs.get(ARCH)
    params = build(base).init(torch.Generator().manual_seed(0), device="cpu")
    ref_params = jax.tree.map(jnp.asarray, bridge.to_numpy(params))
    paths = tree.flatten_with_paths(params)[1]
    print(f"{ARCH}: full CONFIG, d {base.d_model}, pattern "
          f"{base.xlstm_pattern}, {base.n_layers} layers; batch 2",
          flush=True)
    for seq, dtype in ((32, "float32"), (64, "float32"), (128, "float32"),
                       (128, "bfloat16")):
        cfg = dataclasses.replace(base, dtype=dtype)
        rapi = ref_build(dataclasses.replace(ref_configs.get(ARCH),
                                             dtype=dtype))
        batch = pipeline_for(cfg, seq, 2, seed=0).batch(0, "cpu")
        step = make_train_step(build(cfg), optim.AdamW(lr=lambda s: 1e-3),
                               loss_chunk=CHUNK)
        loss, _, grads = step.loss_and_grads(params, batch)
        print(f" seq {seq}, {dtype}", flush=True)
        report("port     ", float(loss),
               [bridge.to_numpy(g) for g in tree.leaves(grads)], paths)

        def ref_loss(p, toks, labels):
            hidden, aux = rapi.forward(p, tokens=toks, return_hidden=True)
            return ref_ce(hidden, rapi.logits_fn(p), labels, None,
                          chunk=CHUNK) + 0.001 * aux

        val, g = jax.jit(jax.value_and_grad(ref_loss))(
            ref_params, jnp.asarray(batch["tokens"].numpy()),
            jnp.asarray(batch["labels"].numpy()))
        report("reference", float(val),
               [np.asarray(x, np.float32) for x in jax.tree.leaves(g)],
               paths)
    dh = base.d_model // base.n_heads
    scaled = tree.tree_map(lambda t: t, params)
    for name, block in scaled["periods"].items():
        if name.endswith("_s"):
            block["r_zifo"] = block["r_zifo"] * (4 / dh) ** 0.5
    batch = pipeline_for(base, 128, 2, seed=0).batch(0, "cpu")
    step = make_train_step(build(dataclasses.replace(base, dtype="float32")),
                           optim.AdamW(lr=lambda s: 1e-3), loss_chunk=CHUNK)
    loss, _, grads = step.loss_and_grads(scaled, batch)
    print(" seq 128, float32, r_zifo at std 1/sqrt(head dim)", flush=True)
    report("port     ", float(loss),
           [bridge.to_numpy(g) for g in tree.leaves(grads)], paths)


def order_ratios(whole, rows, paths):
    """Per leaf max |whole - rows| / max |whole|; prints the largest, the
    median and the leaf of the largest."""
    r = np.array([float(np.abs(a - b).max()) / max(float(np.abs(a).max()),
                                                    1e-30)
                  for a, b in zip(whole, rows)])
    i = int(np.argmax(r))
    return f"max {r[i]:.3e} ({paths[i]}), median {np.median(r):.3e}"


def row_order():
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models import build as ref_build
    from repro.models.losses import chunked_softmax_cross_entropy as ref_ce
    from repro_torch import bridge, configs
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.models import build
    from repro_torch.train import optim, tree
    from repro_torch.train.steps import make_train_step

    torch.set_num_threads(8)
    seq, batch_n, chunk = 512, 2, 256
    for layers in (8, 12):
        cfg = dataclasses.replace(configs.get(ARCH), n_layers=layers,
                                  dtype="float32")
        params = build(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
        dh = cfg.d_model // cfg.n_heads
        for name, block in params["periods"].items():
            if name.endswith("_s"):
                block["r_zifo"].mul_((4 / dh) ** 0.5)
        paths = tree.flatten_with_paths(params)[1]
        batch = pipeline_for(cfg, seq, batch_n, seed=0).batch(0, "cpu")
        rows = [{k: v[i:i + 1] for k, v in batch.items()}
                for i in range(batch_n)]
        print(f"{ARCH}: {layers} of {configs.get(ARCH).n_layers} layers, "
              f"full width, f32, {batch_n} x {seq} tokens; first-step "
              f"gradient of the whole batch against the mean of its rows' "
              f"gradients", flush=True)

        step = make_train_step(build(cfg), optim.AdamW(lr=lambda s: 1e-3),
                               loss_chunk=chunk)

        def port_grads(b):
            return [bridge.to_numpy(g)
                    for g in tree.leaves(step.loss_and_grads(params, b)[2])]

        whole = port_grads(batch)
        parts = [port_grads(b) for b in rows]
        print("  port:      " + order_ratios(
            whole, [sum(g) / batch_n for g in zip(*parts)], paths),
            flush=True)

        rapi = ref_build(dataclasses.replace(ref_configs.get(ARCH),
                                             n_layers=layers,
                                             dtype="float32"))
        ref_params = jax.tree.map(jnp.asarray, bridge.to_numpy(params))

        def ref_loss(p, toks, labels):
            hidden, aux = rapi.forward(p, tokens=toks, return_hidden=True)
            return ref_ce(hidden, rapi.logits_fn(p), labels, None,
                          chunk=chunk) + 0.001 * aux

        grad = jax.jit(jax.grad(ref_loss))

        def ref_grads(b):
            g = grad(ref_params, jnp.asarray(b["tokens"].numpy()),
                     jnp.asarray(b["labels"].numpy()))
            return [np.asarray(x, np.float32) for x in jax.tree.leaves(g)]

        whole = ref_grads(batch)
        parts = [ref_grads(b) for b in rows]
        print("  reference: " + order_ratios(
            whole, [sum(g) / batch_n for g in zip(*parts)], paths),
            flush=True)


if __name__ == "__main__":
    if "--row-order" in sys.argv[1:]:
        row_order()
    else:
        main()
