"""Loss functions (``repro.models.losses``): token cross-entropy with f32
accumulation, whole or one sequence chunk at a time.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import common


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[label] per token, in f32, the max taken out of
    the gradient."""
    logits = logits.float()
    shifted = logits - logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(shifted).sum(-1))
    return lse - shifted.gather(-1, labels[..., None].long())[..., 0]


def _chunk_nll(logits_fn: Callable[[torch.Tensor], torch.Tensor],
               h: torch.Tensor, labels: torch.Tensor, w: torch.Tensor):
    """(sum of w x nll, sum of w) over one chunk (B, c, d)."""
    return (_token_nll(logits_fn(h), labels) * w).sum(), w.sum()


def chunked_softmax_cross_entropy(hidden: torch.Tensor,
                                  logits_fn: Callable[[torch.Tensor],
                                                      torch.Tensor],
                                  labels: torch.Tensor,
                                  mask: Optional[torch.Tensor] = None,
                                  chunk: int = 512) -> torch.Tensor:
    """Cross-entropy without materialising the (B, S, V) logits.

    The LM head and the log-softmax run one sequence chunk at a time, each
    under activation checkpointing: the logits live at (B, chunk, V) only
    and are recomputed in backward. The whole sequence goes at once, as in
    the reference, when ``chunk`` does not divide S or equals it.

    hidden: (B, S, d) post-final-norm states; logits_fn: (B, c, d) ->
    (B, c, V); labels: (B, S) int; mask: (B, S) optional weights.
    """
    b, s, _ = hidden.shape
    if s % chunk != 0 or s == chunk:
        return softmax_cross_entropy(logits_fn(hidden), labels, mask)
    w = (torch.ones((b, s), dtype=torch.float32, device=hidden.device)
         if mask is None else mask.float())
    nll, wsum = zip(*[
        common.remat(True, _chunk_nll, logits_fn, hidden[:, c0:c0 + chunk],
                     labels[:, c0:c0 + chunk], w[:, c0:c0 + chunk])
        for c0 in range(0, s, chunk)])
    return torch.stack(nll).sum() / torch.stack(wsum).sum().clamp_min(1.0)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean token cross-entropy.

    logits: (..., V) of any float dtype (the log-softmax runs in f32, its
    max taken out of the gradient); labels: (...) int; mask: (...)
    optional weights, the mean then over max(sum w, 1).
    """
    nll = _token_nll(logits, labels)
    if mask is not None:
        w = mask.float()
        return (nll * w).sum() / w.sum().clamp_min(1.0)
    return nll.mean()
