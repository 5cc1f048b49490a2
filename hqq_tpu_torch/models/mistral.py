# SPDX-License-Identifier: Apache-2.0
"""Mistral family: a Llama-shaped decoder with sliding-window attention.

Mirrors `hqq_tpu.models.mistral`. The one architectural delta, the
4096-token window, lives in `LlamaConfig.sliding_window`: the dense masks
of `llama.positions_and_masks` carry it, and the paged step sends windowed
layers to the gather route of `ops.paged.paged_attn` (without a window the
paged-attention kernel serves them, as it serves Llama).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import llama
from .llama import KVCache, forward, init_cache, init_params  # noqa: F401  (Mistral is llama-shaped)

__all__ = ["MistralConfig", "forward", "init_params", "init_cache", "KVCache"]


@dataclasses.dataclass(frozen=True)
class MistralConfig(llama.LlamaConfig):
    """Mistral-7B-v0.1 defaults (sliding_window 4096, 8 kv heads)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 32768
    sliding_window: Optional[int] = 4096

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "MistralConfig":
        return cls(vocab_size=vocab_size, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=512, sliding_window=16)
