"""Deterministic synthetic LM token pipeline (``repro.data.tokens``).

Batches are a pure function of (seed, step): a restart from a checkpoint
at step k replays exactly the batches k, k+1, ... that the failed run
would have seen. The stream has structure to learn: token t is
(base + drift * t + noise) mod V with a per-sequence base and drift and a
small noise. The draws come from a ``torch.Generator`` on the CPU seeded
from (seed, step), so a batch is the same whichever device it goes to; it
cannot match the reference's threefry draws, only their ranges, dtypes and
keys.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from (seed, step) through numpy's
    SeedSequence (distinct streams for distinct pairs)."""
    word = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(word >> np.uint64(1)))


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: str = "none"       # none | vision_stub | audio_stub
    d_model: int = 0
    n_frames: int = 0

    def batch(self, step: int,
              device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
        """``labels`` (B, S) int32, and ``tokens`` (B, S) int32 (the
        stream one position earlier) or, for ``vision_stub``, ``embeds``
        (B, S, d) bf16; ``audio_stub`` adds ``frames`` (B, n_frames, d)
        f32. Drawn on the CPU, then moved to ``device``."""
        dev = resolve_device(device)
        gen = _generator(self.seed, step)
        b, s = self.global_batch, self.seq_len
        drift = torch.randint(1, 7, (b, 1), generator=gen)
        base = torch.randint(0, self.vocab, (b, 1), generator=gen)
        noise = torch.randint(0, 17, (b, s + 1), generator=gen)
        idx = torch.arange(s + 1)[None, :]
        stream = ((base + drift * idx + noise) % self.vocab).int()
        out = {"labels": stream[:, 1:]}
        if self.frontend == "vision_stub":
            out["embeds"] = torch.randn(
                (b, s, self.d_model), generator=gen).to(torch.bfloat16) * 0.02
        else:
            out["tokens"] = stream[:, :-1]
        if self.frontend == "audio_stub":
            out["frames"] = torch.randn(
                (b, self.n_frames, self.d_model), generator=gen) * 0.02
        return {k: v.contiguous().to(dev) for k, v in out.items()}


def pipeline_for(cfg, seq_len: int, global_batch: int,
                 seed: int = 0) -> TokenPipeline:
    return TokenPipeline(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=seed,
        frontend=cfg.frontend if cfg.frontend != "none" else
        ("audio_stub" if cfg.family == "encdec" else "none"),
        d_model=cfg.d_model, n_frames=cfg.n_audio_frames)
