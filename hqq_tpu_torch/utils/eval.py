# SPDX-License-Identifier: Apache-2.0
"""Perplexity evaluation harness.

Mirrors `hqq_tpu.utils.eval`: sliding-window perplexity with
``max_length=1024`` / ``stride=512`` and ``ppl = exp(-sum(loglik) / end_loc)``,
the protocol of HQQ's published quality numbers, so that quantized-vs-fp
deltas compare directly. The harness takes token ids that are already
tokenized. Each window is one cache-free forward (`llama.forward` with
``cache=None``), whose attention is the `flash_attention` kernel for windows
of at least `ops.attention.FLASH_MIN_SEQ` tokens.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models import llama

__all__ = ["perplexity", "loglikelihood"]


def _token_loglik(forward_fn, params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """log p(t_i | t_<i) of every target of tokens [B, T]: [B, T-1], fp32."""
    logits, _ = forward_fn(params, cfg, tokens[:, :-1])
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]


@torch.no_grad()
def loglikelihood(params, cfg, tokens, forward_fn: Optional[Callable] = None,
                  device="cuda") -> torch.Tensor:
    """Sum of log p(t_i | t_<i) over one window [1, T] (fp32 softmax)."""
    forward_fn = forward_fn or llama.forward
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=device)
    return _token_loglik(forward_fn, params, cfg, tokens).sum()


@torch.no_grad()
def perplexity(
    params,
    cfg,
    token_ids: np.ndarray,
    max_length: int = 1024,
    stride: int = 512,
    forward_fn: Optional[Callable] = None,
    verbose: bool = False,
    device="cuda",
) -> float:
    """Sliding-window perplexity over a 1-D token stream.

    Windows of ``max_length`` advance by ``stride``; only the last
    ``trg_len`` targets of each window count; the normaliser is the final
    ``end_loc`` (the reference protocol's convention, kept so that numbers
    compare). Windows are right-padded to one shape, with a target mask
    built on the host, so every window runs the same kernels.
    """
    token_ids = np.asarray(token_ids).reshape(-1)
    seq_len = token_ids.shape[0]
    forward_fn = forward_fn or llama.forward

    nll_sum = 0.0
    prev_end = 0
    end_loc = 0
    for begin in range(0, seq_len, stride):
        end_loc = min(begin + max_length, seq_len)
        window = token_ids[begin:end_loc]
        if len(window) < 2:
            break
        trg_len = end_loc - prev_end
        n_tgt = min(trg_len, len(window) - 1)

        padded = np.zeros(max_length, np.int64)
        padded[: len(window)] = window
        mask = np.zeros(max_length - 1, np.float32)
        t_valid = len(window) - 1  # real targets in this window
        mask[t_valid - n_tgt: t_valid] = 1.0

        tokens = torch.from_numpy(padded[None]).to(device)
        ll = _token_loglik(forward_fn, params, cfg, tokens)[0]
        nll_sum += float((ll * torch.from_numpy(mask).to(device)).sum())
        prev_end = end_loc
        if verbose:
            print(f"  ppl@{end_loc}: {np.exp(-nll_sum / end_loc):.4f}")
        if end_loc == seq_len:
            break

    return float(np.exp(-nll_sum / end_loc))
