"""Family dispatch (``repro.models.zoo``): one API over the dense / moe /
ssm / hybrid / encdec models.

``build(cfg)`` returns a ``ModelAPI`` whose members close over the family
module. ``init`` takes a ``torch.Generator`` and a device (the card unless
``device="cpu"`` is asked for). ``init_cache`` signatures are normalized to
(params, batch, max_len); families with O(1) state ignore max_len. The
dense and MoE families also expose ``prefill`` (params, tokens, max_len).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.models import attention as attn_mod
from repro_torch.models import common, encdec, griffin, transformer, xlstm
from repro_torch.models.lm_types import LMConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: LMConfig
    init: Callable[..., Any]            # (gen, device="cuda") -> params
    forward: Callable[..., Any]         # (params, **inputs) -> (logits, aux)
    decode_step: Callable[..., Any]     # (params, tokens, cache) -> (logits, cache)
    init_cache: Callable[..., Any]      # (params, batch, max_len) -> cache
    logits_fn: Callable[..., Any]       # (params) -> ((B,c,d) -> (B,c,V))
    sub_quadratic: bool                 # eligible for long_500k
    has_decode: bool = True
    prefill: Optional[Callable[..., Any]] = None  # (params, tokens, max_len)


def build(cfg: LMConfig) -> ModelAPI:
    cfg.validate()
    if cfg.family in ("dense", "moe"):
        def init_cache(params, batch, max_len):
            return attn_mod.init_kv_cache(cfg, cfg.n_layers, batch, max_len,
                                          common.dtype_of(cfg.dtype),
                                          params["embed"].device)

        return ModelAPI(
            cfg=cfg,
            init=lambda gen, device="cuda": transformer.init_params(
                gen, cfg, device),
            forward=lambda params, **kw: transformer.forward(params, cfg,
                                                             **kw),
            decode_step=lambda params, tokens, cache: transformer.decode_step(
                params, cfg, tokens, cache),
            init_cache=init_cache,
            logits_fn=lambda params: transformer.logits_fn(params, cfg),
            sub_quadratic=False,
            prefill=lambda params, tokens, max_len: transformer.prefill(
                params, cfg, tokens, max_len),
        )
    if cfg.family == "ssm":
        mod, sub_q = xlstm, True
        init_cache = lambda params, batch, max_len: xlstm.init_cache(
            params, cfg, batch)
    elif cfg.family == "hybrid":
        mod, sub_q = griffin, True
        init_cache = lambda params, batch, max_len: griffin.init_cache(
            params, cfg, batch)
    else:   # encdec (validate() admits no other family)
        mod, sub_q = encdec, False
        init_cache = lambda params, batch, max_len: encdec.init_cache(
            params, cfg, batch, max_len)
    return ModelAPI(
        cfg=cfg,
        init=lambda gen, device="cuda": mod.init_params(gen, cfg, device),
        forward=lambda params, **kw: mod.forward(params, cfg, **kw),
        decode_step=lambda params, tokens, cache: mod.decode_step(
            params, cfg, tokens, cache),
        init_cache=init_cache,
        logits_fn=lambda params: mod.logits_fn(params, cfg),
        sub_quadratic=sub_q,
    )
