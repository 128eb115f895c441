"""Serve an LM of the zoo with batched requests: prefill + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-1.7b \
        --batch 4 [--prompt-len 32] [--gen-len 32] [--device cpu]

The counterpart of the reference's ``examples/serve_lm.py``: the arch's
REDUCED config, weights from seed 0, prompts from seed 1. The dense and MoE
families prefill the prompt in one pass, then decode; the recurrent
families (ssm, hybrid, encdec) consume the prompt token by token through
the decode step. The encoder-decoder family gets stub frames (seed 2) for
its cross-KV; the reference serves it with a zero cross-KV. Prints the
prefill time, the decode time per token and sample token ids. Runs on the
card unless ``--device cpu`` is given.

``serve`` is the loop itself, for callers with their own model and
weights (``chip_smoke.py`` serves full-width configs through it).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List, Optional

import torch

from repro_torch import configs
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import build, encdec
from repro_torch.models.zoo import ModelAPI
from repro_torch.train.steps import make_serve_step


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor        # (B, steps + 1) greedy ids; the first from the prompt
    logits: List[torch.Tensor]  # the prompt's last logits, then each step's (keep_logits)
    cache: Any                  # the decode cache after the last step
    prefill_ms: float           # the prompt (one pass, or token by token)
    decode_ms: float            # all decode steps

    @property
    def ms_per_token(self) -> float:
        return self.decode_ms / max(1, self.tokens.shape[1] - 1)


def serve(api: ModelAPI, params: Any, prompts: torch.Tensor, steps: int,
          frames: Optional[torch.Tensor] = None,
          keep_logits: bool = False) -> ServeResult:
    """Greedy serving of a batch of prompts (B, P): the prompt, then
    ``steps`` decode steps through ``make_serve_step``. The cache holds
    P + steps positions; each step's token is the argmax of the last
    logits, on the device (no host sync inside the loop)."""
    cfg = api.cfg
    b, p_len = prompts.shape
    max_len = p_len + steps
    step = make_serve_step(api)
    dev = prompts.device
    with torch.inference_mode():
        synchronize(dev)
        t0 = time.perf_counter()
        if api.prefill is not None:
            logits, cache = api.prefill(params, prompts, max_len)
        else:
            if cfg.family == "encdec":
                cache = encdec.init_cache(params, cfg, b, max_len,
                                          frames=frames)
            else:
                cache = api.init_cache(params, b, max_len)
            for t in range(p_len):
                logits, cache = step(params, prompts[:, t:t + 1], cache)
        tok = logits.argmax(-1, keepdim=True)
        synchronize(dev)
        t1 = time.perf_counter()
        kept = [logits] if keep_logits else []
        out = [tok]
        for _ in range(steps):
            logits, cache = step(params, tok, cache)
            tok = logits.argmax(-1, keepdim=True)
            out.append(tok)
            if keep_logits:
                kept.append(logits)
        synchronize(dev)
        t2 = time.perf_counter()
    return ServeResult(tokens=torch.cat(out, dim=1), logits=kept, cache=cache,
                       prefill_ms=(t1 - t0) * 1e3, decode_ms=(t2 - t1) * 1e3)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get_reduced(args.arch)
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0), device=dev)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1))
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn((args.batch, cfg.n_audio_frames, cfg.d_model),
                             generator=torch.Generator().manual_seed(2))
        frames = frames.to(dev)
    res = serve(api, params, prompts.to(dev), args.gen_len - 1, frames)
    how = "in one pass" if api.prefill is not None else "token by token"
    print(f"prefill: {args.batch} x {args.prompt_len} tokens {how} in "
          f"{res.prefill_ms:.0f} ms")
    print(f"decoded {args.gen_len} tokens x {args.batch} requests in "
          f"{res.decode_ms:.0f} ms ({res.ms_per_token:.1f} ms/token)")
    print("sample token ids:", res.tokens[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
