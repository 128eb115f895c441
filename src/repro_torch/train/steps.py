"""The training state, the LM train step and the serving step of the LM zoo
(``repro.train.steps``).

``make_train_step`` returns ``(state, batch) -> (state, metrics)``: bf16
compute against f32 master params (the models cast per call), the chunked
cross-entropy plus ``aux_weight`` x the MoE load-balance loss, gradients
of every leaf by ``torch.autograd.grad``, and the reference's AdamW. The
reference jits the step with the state donated; ``donate=True`` is the
counterpart: the update runs in place and the old state is consumed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.losses import chunked_softmax_cross_entropy
from repro_torch.models.zoo import ModelAPI
from repro_torch.train import tree
from repro_torch.train.optim import AdamW, AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor       # 0-d int32


def init_train_state(api: ModelAPI, opt: AdamW, gen: torch.Generator,
                     device: DeviceLike = "cuda") -> TrainState:
    """Parameters from ``gen`` (drawn on the generator's device, then
    moved to ``device``), zero moments, step 0."""
    dev = resolve_device(device)
    params = api.init(gen, device=dev)
    return TrainState(params=params, opt=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


class LMTrainStep:
    """One optimizer step on a batch: ``state, metrics = step(state,
    batch)``, with ``metrics`` {"loss", "ce", "moe_aux", "grad_norm"} as
    0-d tensors on the state's device (no host sync). ``loss_and_grads``
    is the differentiation alone, for checks of the gradients."""

    def __init__(self, api: ModelAPI, opt: AdamW, aux_weight: float,
                 loss_chunk: int, donate: bool):
        self.api, self.opt = api, opt
        self.aux_weight, self.loss_chunk = aux_weight, loss_chunk
        self.donate = donate

    def loss_and_grads(self, params: Any, batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
        """(loss, {"ce", "moe_aux"}, grads): grads a tree like ``params``,
        one for every leaf (zeros where the loss does not reach one)."""
        api = self.api
        with torch.enable_grad():
            live = tree.tree_map(lambda p: p.detach().requires_grad_(True),
                                 params)
            kw = {"frames": batch["frames"]} if "frames" in batch else {}
            if "embeds" in batch:
                kw["embeds"] = batch["embeds"]
            else:
                kw["tokens"] = batch["tokens"]
            hidden, aux = api.forward(live, return_hidden=True, **kw)
            ce = chunked_softmax_cross_entropy(
                hidden, api.logits_fn(live), batch["labels"],
                batch.get("mask"), chunk=self.loss_chunk)
            loss = ce + self.aux_weight * aux
            leaves = tree.leaves(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (loss.detach(), {"ce": ce.detach(), "moe_aux": aux.detach()},
                tree.unflatten(params, grads))

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, aux, grads = self.loss_and_grads(state.params, batch)
        update = self.opt.update_ if self.donate else self.opt.update
        params, opt_state, gnorm = update(grads, state.opt, state.params)
        return (TrainState(params=params, opt=opt_state, step=state.step + 1),
                {"loss": loss, **aux, "grad_norm": gnorm})


def make_train_step(api: ModelAPI, opt: AdamW, aux_weight: float = 0.001,
                    loss_chunk: int = 512,
                    donate: bool = False) -> LMTrainStep:
    """The reference's entry point. With ``donate`` the step updates the
    state's params and moments in place (``AdamW.update_``): the caller
    promises not to read the old state again, as a jitted step with
    ``donate_argnums=(0,)`` forbids it."""
    return LMTrainStep(api, opt, aux_weight, loss_chunk, donate)


def make_serve_step(api: ModelAPI) -> Callable:
    """One-token decode step: (params, tokens (B,1), cache) -> (logits,
    cache), under ``torch.inference_mode``."""

    @torch.inference_mode()
    def serve_step(params, tokens, cache):
        return api.decode_step(params, tokens, cache)

    return serve_step
