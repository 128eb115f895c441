"""Why phase 13's LM checks hold what they hold: measurements behind
``chip_smoke.py`` phase 13's check (b) and its xLSTM check (a).

On a card (default), full-width configs, batch 4, prompt 256, 32 steps:

  1. qwen3-1.7b cut to 2, 7, 14 and 28 layers: the bf16 decode against the
     bf16 teacher-forced forward (max, mean, share of logits outside the
     reference's rtol 0.08 / atol 0.05), the f32 decode against the f32
     forward, and each bf16 path against the f32 forward over the same
     tokens; at 28 layers also the f32 forward of bf16-rounded weights.
  2. granite-moe-1b-a400m drop-free, bf16 and f32: how many token-layer
     routing decisions differ between the decode and the forward, and the
     smallest top-k gaps among them.
  3. xlstm-125m in f32: decode against forward, position by position,
     at the reference's init and with the sLSTM recurrent matrices at std
     1/sqrt(head dim).

    python3 scripts/lm_serve_diagnostics.py

With ``--cpu-xlstm`` it runs on the CPU instead and imports the reference
package (JAX) beside the port: xLSTM at width 768, 4 layers, vocab 211,
128 steps (not a published config), sLSTM-only, mLSTM-only and the mixed
pattern: decode against forward in each package, and the two forwards.

    PYTHONPATH=src python scripts/lm_serve_diagnostics.py --cpu-xlstm
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

B, P, S = 4, 256, 32


def stats(tag, got, want):
    err = (got - want).abs()
    outside = float((err > 0.05 + 0.08 * want.abs()).float().mean())
    print(f"  {tag}: max {float(err.max()):.4e} mean {float(err.mean()):.4e}"
          f" outside {outside:.3e} (max|want| {float(want.abs().max()):.3f})",
          flush=True)


def on_card():
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve_lm import serve
    from repro_torch.models import build
    from repro_torch.train import tree

    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev)
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)

    def prompts(cfg):
        return torch.randint(0, cfg.vocab, (B, P),
                             generator=gen.manual_seed(1), device=dev)

    def served(api, params, pr):
        res = serve(api, params, pr, S, keep_logits=True)
        return torch.stack(res.logits, 1).float(), torch.cat(
            [pr, res.tokens[:, :-1]], dim=1)

    # 1. qwen3: bf16 error against depth
    cfg = configs.get("qwen3-1.7b")
    params = build(cfg).init(gen.manual_seed(0), device=dev)
    pr = prompts(cfg)
    for depth in (2, 7, 14, 28):
        c = dataclasses.replace(cfg, n_layers=depth)
        p = dict(params, blocks=tree.tree_map(lambda t: t[:depth],
                                              params["blocks"]))
        a16, a32 = build(c), build(dataclasses.replace(c, dtype="float32"))
        got16, seq16 = served(a16, p, pr)
        got32, seq32 = served(a32, p, pr)
        want16 = cs.lm_teacher_forced(a16, p, seq16, P)
        want32 = cs.lm_teacher_forced(a32, p, seq16, P)
        print(f"qwen3-1.7b, {depth} layers:", flush=True)
        stats("bf16 decode vs bf16 forward", got16, want16)
        stats("f32 decode vs f32 forward",
              got32, cs.lm_teacher_forced(a32, p, seq32, P))
        stats("bf16 decode vs f32 forward (same tokens)", got16, want32)
        stats("bf16 forward vs f32 forward (same tokens)", want16, want32)
        if depth == cfg.n_layers:
            rounded = tree.tree_map(
                lambda t: t.to(torch.bfloat16).float() if t.dim() >= 2
                else t, p)
            stats("f32 forward of bf16-rounded weights vs f32 forward",
                  cs.lm_teacher_forced(a32, rounded, seq16, P), want32)
    del params
    torch.cuda.empty_cache()

    # 2. granite-moe: routing decisions, decode against forward
    cfg = configs.get("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    params = build(cfg).init(gen.manual_seed(0), device=dev)
    pr = prompts(cfg)
    for dtype in ("bfloat16", "float32"):
        api = build(dataclasses.replace(cfg, dtype=dtype))
        got, seq = served(api, params, pr)
        with cs.RoutingTape(cfg.n_layers) as dec_tape:
            cs.lm_decode_along(api, params, seq, P)
        with cs.RoutingTape(cfg.n_layers) as fwd_tape:
            want = cs.lm_teacher_forced(api, params, seq, P)
        flips = total = 0
        for a, b in zip(dec_tape.recorded(), fwd_tape.recorded()):
            differ = (a.sort(-1).values != b.sort(-1).values).any(-1)
            flips += int(differ.sum())
            total += differ.numel()
        print(f"granite-moe-1b-a400m {dtype}, drop-free: {flips} of {total} "
              f"token-layer routing decisions differ, decode against "
              f"forward", flush=True)
        stats(f"{dtype} decode vs forward", got, want)
    del params
    torch.cuda.empty_cache()

    # 3. xlstm-125m: decode against forward, position by position
    cfg = dataclasses.replace(configs.get("xlstm-125m"), dtype="float32")
    api = build(cfg)
    params = api.init(gen.manual_seed(0), device=dev)
    pr = prompts(cfg)
    dh = cfg.d_model // cfg.n_heads
    rescaled = tree.tree_map(lambda t: t, params)
    for name, block in rescaled["periods"].items():
        if name.endswith("_s"):
            block["r_zifo"] = block["r_zifo"] * (4 / dh) ** 0.5
    for tag, p in (("reference init", params),
                   ("sLSTM r_zifo at std 1/sqrt(dh)", rescaled)):
        with torch.inference_mode():
            want, _ = api.forward(p, tokens=pr)
            cache = api.init_cache(p, B, P)
            errs = []
            for t in range(P):
                logits, cache = api.decode_step(p, pr[:, t:t + 1], cache)
                errs.append(float((logits - want[:, t]).abs().max()))
        limit = 1e-3 * float(want.abs().max())
        first = next((i for i, e in enumerate(errs) if e > limit), None)
        print(f"xlstm-125m f32, {tag}: decode vs forward max "
              f"{max(errs):.4e}, first position past 1e-3 x max|logit|: "
              f"{first}; at positions 0, 8, 16, 32, 64, 255: "
              f"{[f'{errs[i]:.2e}' for i in (0, 8, 16, 32, 64, 255)]}",
              flush=True)


def cpu_xlstm():
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models import build as ref_build
    from repro_torch import bridge, configs
    from repro_torch.models import build

    torch.set_num_threads(4)
    steps = 128
    tok = np.random.default_rng(1).integers(0, 211, (2, steps))
    for pattern in ("ssss", "mmmm", "mmms"):
        over = dict(d_model=768, xlstm_chunk=64, dtype="float32",
                    xlstm_pattern=pattern)
        rc = dataclasses.replace(ref_configs.get_reduced("xlstm-125m"),
                                 **over)
        pc = dataclasses.replace(configs.get_reduced("xlstm-125m"), **over)
        ref_api, api = ref_build(rc), build(pc)
        params = api.init(torch.Generator().manual_seed(0), device="cpu")
        ref_params = jax.tree.map(jnp.asarray, bridge.to_numpy(params))
        fwd = api.forward(params, tokens=torch.from_numpy(tok))[0]
        ref_fwd = np.asarray(jax.jit(lambda p, t: ref_api.forward(
            p, tokens=t)[0])(ref_params, jnp.asarray(tok)))
        cache = api.init_cache(params, 2, steps)
        ref_cache = ref_api.init_cache(ref_params, 2, steps)
        dec = jax.jit(ref_api.decode_step)
        err, ref_err = 0.0, 0.0
        for t in range(steps):
            logits, cache = api.decode_step(
                params, torch.from_numpy(tok[:, t:t + 1]), cache)
            ref_logits, ref_cache = dec(ref_params, jnp.asarray(
                tok[:, t:t + 1]), ref_cache)
            err = max(err, float((logits - fwd[:, t]).abs().max()))
            ref_err = max(ref_err, float(np.abs(np.asarray(ref_logits)
                                                - ref_fwd[:, t]).max()))
        print(f"xLSTM width 768, pattern {pattern}, {steps} steps (CPU): "
              f"decode vs forward max {err:.4e} (port), {ref_err:.4e} "
              f"(reference); port forward vs reference forward "
              f"{float(np.abs(fwd.numpy() - ref_fwd).max()):.4e}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--cpu-xlstm"]:
        cpu_xlstm()
    else:
        if not torch.cuda.is_available():
            sys.exit("needs an NVIDIA GPU (or --cpu-xlstm)")
        on_card()
