# SPDX-License-Identifier: Apache-2.0
"""GPT-2 family (gpt2 to gpt2-xl, DistilGPT2, DialoGPT, CodeParrot).

Mirrors `hqq_tpu.models.gpt2` (HF ``modeling_gpt2.py``). Beside the llama
walk:

* learned absolute positions, ``wpe`` gathered at each token's position
  (per slot under continuous batching) and added to the token embedding;
  no rotary embedding;
* pre-LN blocks with biased LayerNorms, the fused ``c_attn`` giving
  [q | k | v] along the features;
* HF stores its Conv1D weights [in, out]: the loader transposes them into
  [out, in] ``Linear`` weights, so the quantizer groups along the inputs
  (axis=1) as for every other family;
* the MLP is c_fc, the tanh GELU (``gelu_new``), c_proj; the head is tied
  to ``wte``.

``max_position_embeddings`` (1024 for GPT-2) bounds the positions: a
cache longer than that, or a sequence that would run past it, is refused
with a ValueError (`check_positions`), so ``wpe`` is never indexed past
its end. `hqq_tpu`'s ``jnp.take`` clamps such a position silently. The
engines' dead slots, whose positions keep counting, read the last row
instead (their outputs are dropped).

Every LayerNorm is one launch of the fixed-order kernel. Attention is
plain torch over the dense cache's float pools; int8 pools are not read
(``reads_int8_kv``) and there is no paged branch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, Optional

import torch
import torch.nn.functional as F

from ..nn.linear import Linear
from . import llama
from .llama import KVCache, init_cache, refuse_int8_pools  # noqa: F401
from .llama import layer_norm as ln

__all__ = ["GPT2Config", "check_positions", "forward", "init_cache", "init_params",
           "params_from_hf_state_dict"]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768  # HF: n_embd
    num_hidden_layers: int = 12  # HF: n_layer
    num_attention_heads: int = 12  # HF: n_head
    max_position_embeddings: int = 1024  # HF: n_positions
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    # read by the shared helpers
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0

    # the forward reads the dense cache's float pools only
    reads_int8_kv: ClassVar[bool] = False

    @property
    def head_dim_(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads

    @property
    def max_cache_len(self) -> int:
        """The longest cache the learned positions cover."""
        return self.max_position_embeddings

    @classmethod
    def from_hf(cls, hf: dict) -> "GPT2Config":
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf.get("n_embd", hf.get("hidden_size", 768)),
            num_hidden_layers=hf.get("n_layer", hf.get("num_hidden_layers", 12)),
            num_attention_heads=hf.get("n_head", hf.get("num_attention_heads", 12)),
            max_position_embeddings=hf.get("n_positions",
                                           hf.get("max_position_embeddings", 1024)),
            layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
        )

    @classmethod
    def gpt2_xl(cls) -> "GPT2Config":
        """gpt2-xl's published config: n_embd 1600, 48 layers, 25 heads,
        1024 positions, vocab 50257."""
        return cls(hidden_size=1600, num_hidden_layers=48, num_attention_heads=25)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "GPT2Config":
        return cls(vocab_size=vocab_size, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, max_position_embeddings=128)


def check_positions(cfg: GPT2Config, t: int, start_pos, cache) -> None:
    """A ValueError where positions could pass the last learned one: a
    cache longer than ``max_position_embeddings``, or ``t`` tokens from an
    int ``start_pos`` (from 0 without a cache) running past it. A tensor
    ``start_pos`` is not read on the host: the cache's length bounds it."""
    n = cfg.max_position_embeddings
    if cache is not None and cache.max_len > n:
        raise ValueError(f"gpt2: a cache of {cache.max_len} positions exceeds the "
                         f"{n} learned positions (max_position_embeddings)")
    end = t + (0 if isinstance(start_pos, torch.Tensor) else int(start_pos))
    if end > n:
        raise ValueError(f"gpt2: positions up to {end - 1} exceed the {n} learned positions "
                         f"(max_position_embeddings)")


def forward(params: dict, cfg: GPT2Config, tokens: torch.Tensor, cache=None, start_pos=0):
    """`llama.forward`'s contract over a dense `KVCache` (float pools) or
    ``cache=None``: (logits [B, T, V] fp32, cache)."""
    refuse_int8_pools(cache, "gpt2")
    b, t = tokens.shape
    check_positions(cfg, t, start_pos, cache)
    nh, hd = cfg.num_attention_heads, cfg.head_dim_
    eps = cfg.layer_norm_epsilon
    device = tokens.device
    _, pos_bt, mask = llama.causal_mask(t, start_pos, None if cache is None else cache.max_len,
                                        None, device)
    wpe = params["wpe"]
    x = params["wte"][tokens] + wpe[pos_bt.clamp_max(wpe.shape[0] - 1)]

    for i, layer in enumerate(params["layers"]):
        h = ln(x, layer["ln_1"], eps)
        q, k, v = layer["attn"]["c_attn"](h).chunk(3, dim=-1)
        q, k, v = (a.reshape(b, t, nh, hd).transpose(1, 2) for a in (q, k, v))
        x = x + layer["attn"]["c_proj"](llama.float_attention(q, k, v, cache, i, start_pos, mask))
        h = ln(x, layer["ln_2"], eps)
        x = x + layer["mlp"]["c_proj"](F.gelu(layer["mlp"]["c_fc"](h), approximate="tanh"))

    x = ln(x, params["ln_f"], eps)
    return x.to(torch.float32) @ params["wte"].to(torch.float32).t(), cache


def init_params(cfg: GPT2Config, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """Random tree in `hqq_tpu`'s layout: linears N(0, 1/in_features) with
    zero biases, ``wte`` N(0, 0.02^2), ``wpe`` N(0, 0.01^2), drawn in fp32
    from ``generator`` (seed 0 on ``device`` when None)."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d = cfg.hidden_size

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def lin(o, i):
        return Linear((randn(o, i) / math.sqrt(i)).to(dtype),
                      torch.zeros((o,), dtype=dtype, device=device))

    def norm():
        return {"weight": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}

    layers = [{"ln_1": norm(), "attn": {"c_attn": lin(3 * d, d), "c_proj": lin(d, d)},
               "ln_2": norm(), "mlp": {"c_fc": lin(4 * d, d), "c_proj": lin(d, 4 * d)}}
              for _ in range(cfg.num_hidden_layers)]
    return {"wte": (randn(cfg.vocab_size, d) * 0.02).to(dtype),
            "wpe": (randn(cfg.max_position_embeddings, d) * 0.01).to(dtype),
            "layers": layers, "ln_f": norm()}


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: GPT2Config,
                              dtype=torch.bfloat16) -> dict:
    """An HF `GPT2LMHeadModel` state dict as the tree, the Conv1D weights
    transposed to [out, in]."""

    def arr(name):
        return state[name].to(dtype)

    def conv1d(prefix):
        return Linear(arr(prefix + ".weight").t().contiguous(), arr(prefix + ".bias"))

    def norm(prefix):
        return {"weight": arr(prefix + ".weight"), "bias": arr(prefix + ".bias")}

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"transformer.h.{i}"
        layers.append({
            "ln_1": norm(f"{p}.ln_1"),
            "attn": {"c_attn": conv1d(f"{p}.attn.c_attn"), "c_proj": conv1d(f"{p}.attn.c_proj")},
            "ln_2": norm(f"{p}.ln_2"),
            "mlp": {"c_fc": conv1d(f"{p}.mlp.c_fc"), "c_proj": conv1d(f"{p}.mlp.c_proj")},
        })
    return {"wte": arr("transformer.wte.weight"), "wpe": arr("transformer.wpe.weight"),
            "layers": layers, "ln_f": norm("transformer.ln_f")}
