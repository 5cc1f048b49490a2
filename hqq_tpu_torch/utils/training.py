# SPDX-License-Identifier: Apache-2.0
"""HQQ+ training: the causal-LM loss and a LoRA train step.

Mirrors `hqq_tpu.utils.training`. Gradients reach only the leaves that a
`core.peft.TrainableParams` selects (the LoRA A and B, by default): its
`values` turns ``requires_grad`` on for them and off for the frozen
quantized backbone, whose `QuantLinear` layers return a gradient for their
input and none for their weights (`nn.linear.dequant_matmul`). Attention
over the whole sequence runs through the flash kernels forward and backward
(`ops.attention.flash_attention`) from T = 256 on.

The caller builds the optimizer over ``trainable.values()``, as `hqq_tpu`'s
caller builds the optax one; the step is eager PyTorch, not jitted.
Checkpointing the train state (`hqq_tpu`'s `save_train_state`) waits for
`models.serialize`.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.peft import TrainableParams
from ..models import llama

__all__ = ["causal_lm_loss", "make_lora_train_step"]


def causal_lm_loss(params: Any, cfg: llama.LlamaConfig, tokens: torch.Tensor,
                   loss_mask: Optional[torch.Tensor] = None,
                   forward: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross-entropy over tokens [B, T] (no cache, causal): the
    logits of tokens[:, :-1] against tokens[:, 1:], log-softmax in fp32,
    the mean over the targets (or over those that ``loss_mask[:, 1:]``
    keeps). ``forward`` is the family's forward (`models.gemma.forward`,
    ...; default `llama.forward`)."""
    logits, _ = (forward or llama.forward)(params, cfg, tokens[:, :-1])
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if loss_mask is not None:
        m = loss_mask[:, 1:].to(torch.float32)
        return (nll * m).sum() / torch.clamp_min(m.sum(), 1.0)
    return nll.mean()


def make_lora_train_step(cfg: llama.LlamaConfig, trainable: TrainableParams, optimizer,
                         loss_fn: Optional[Callable] = None, remat: bool = False):
    """Build ``step(params, batch) -> loss``: zero the gradients, the loss
    (``loss_fn(params, cfg, *batch)``, default `causal_lm_loss`; ``batch``
    a tensor of tokens or a tuple of arguments), its backward, one
    ``optimizer.step()``. ``optimizer`` is built over ``trainable.values()``.

    remat=True wraps the loss in `torch.utils.checkpoint.checkpoint`
    (non-reentrant), as `jax.checkpoint` does in `hqq_tpu`: the forward's
    activations are recomputed in the backward instead of stored."""
    loss_fn = loss_fn or causal_lm_loss
    trainable.values()  # requires_grad on the trainable leaves only

    def _loss(params, batch):
        if isinstance(batch, (tuple, list)):
            return loss_fn(params, cfg, *batch)
        return loss_fn(params, cfg, batch)

    def step(params: Any, batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        if remat:
            loss = checkpoint(_loss, params, batch, use_reentrant=False)
        else:
            loss = _loss(params, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
