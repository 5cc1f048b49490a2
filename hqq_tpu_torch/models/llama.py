# SPDX-License-Identifier: Apache-2.0
"""Llama-class decoder (RMSNorm, RoPE, GQA attention, SwiGLU MLP) in
PyTorch.

Mirrors `hqq_tpu.models.llama`. Parameters are a tree of dicts and lists (HF
naming, [out, in] weights) whose linear leaves are `Linear`, `QuantLinear`,
`PallasQuantLinear` or `A8QuantLinear` alike. `forward` is polymorphic in its
cache, as in `hqq_tpu`:

  * a dense `KVCache`, a stacked [L, B, n_kv, S_max, head_dim] pair of
    tensors updated in place at ``start_pos``: an int or a 0-d device tensor
    (the whole batch at one offset, by `index_copy_`; prefill and decode, a
    CUDA graph of the decode step replays it), or a [B] tensor (every slot
    at its own offset, one indexed write per pool: the dense continuous
    batching engine). With int8 pools (``init_cache(quantize_kv=True)``)
    new rows are absmax-quantized per row and the scales are applied after
    the products;
  * a `PagedKVCache` with ``page_indices`` (`ops.paged`): one decode step
    for every slot at its own offset, K/V written into pages in place and
    attention through the `paged_attention` kernel;
  * ``cache=None``: causal attention over the whole sequence through
    `ops.attention.prefill_attention` and no cache (perplexity evaluation,
    and training: under autograd this path differentiates, with no in-place
    update of a saved tensor, and its attention takes the flash Function,
    forward and backward kernels, from T = 256 on).

A layer's projections may be fused (`utils.patching.fuse_for_decode`):
``qkv_proj`` in place of q, k and v, ``gate_up_proj`` in place of gate
and up; their outputs are split as in `hqq_tpu`.

Over the dense cache ``kv_valid`` [B, S_max] masks cache slots (a
left-padded batch), and ``inputs_embeds`` [B, T, D] stands in for the
token embedding, as in `hqq_tpu`. Not yet ported: the sequence-parallel
page pool (``seq_axis``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import sys
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.linear import Linear
from ..ops.norm import apply_layer_norm, apply_rms_norm

__all__ = [
    "LlamaConfig",
    "KVCache",
    "init_params",
    "init_cache",
    "cache_for",
    "rms_norm",
    "layer_norm",
    "refuse_int8_pools",
    "positions_and_masks",
    "causal_mask",
    "float_attention",
    "forward",
]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    # Sliding-window attention (Mistral-style); None = full causal.
    sliding_window: Optional[int] = None
    # RoPE scaling as a hashable tuple of sorted (key, value) pairs;
    # rope_type "llama3", "linear" or "yarn". None = no scaling.
    rope_scaling: Optional[tuple] = None

    def __post_init__(self):
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(self, "rope_scaling", tuple(sorted(self.rope_scaling.items())))
        elif isinstance(self.rope_scaling, list):
            object.__setattr__(self, "rope_scaling", tuple((k, v) for k, v in self.rope_scaling))

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf(cls, hf: dict) -> "LlamaConfig":
        """Build from a HuggingFace config.json dict (Llama/Mistral family)."""
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim"),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            rope_theta=hf.get("rope_theta", 10000.0),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            attention_bias=hf.get("attention_bias", False),
            mlp_bias=hf.get("mlp_bias", False),
            sliding_window=hf.get("sliding_window"),
            rope_scaling=cls._canon_rope_scaling(hf.get("rope_scaling")),
        )

    @staticmethod
    def _canon_rope_scaling(rs: Optional[dict]) -> Optional[tuple]:
        if not rs:
            return None
        rt = rs.get("rope_type", rs.get("type", "default"))
        if rt == "default":
            return None
        if rt not in ("llama3", "linear", "yarn"):
            raise ValueError(f"rope_type {rt!r} not implemented (supported: llama3, linear, yarn)")
        keep = {k: v for k, v in rs.items()
                if k in ("rope_type", "type", "factor", "low_freq_factor",
                         "high_freq_factor", "original_max_position_embeddings",
                         "beta_fast", "beta_slow", "truncate",
                         "attention_factor", "mscale", "mscale_all_dim")}
        keep["rope_type"] = rt
        keep.pop("type", None)
        return tuple(sorted(keep.items()))

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def llama2_13b(cls) -> "LlamaConfig":
        return cls(hidden_size=5120, intermediate_size=13824, num_hidden_layers=40,
                   num_attention_heads=40, num_key_value_heads=40)

    @classmethod
    def llama2_70b(cls) -> "LlamaConfig":
        return cls(hidden_size=8192, intermediate_size=28672, num_hidden_layers=80,
                   num_attention_heads=64, num_key_value_heads=8)

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls(vocab_size=128256, intermediate_size=14336, num_key_value_heads=8,
                   rope_theta=500000.0, max_position_embeddings=8192)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "LlamaConfig":
        """2-layer model for tests."""
        return cls(vocab_size=vocab_size, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=512)


def init_params(
    cfg: LlamaConfig,
    generator: Optional[torch.Generator] = None,
    dtype=torch.bfloat16,
    device="cuda",
) -> dict:
    """Random parameter tree in HF naming (tests and benchmarks). Weights
    are N(0, 1/in_features) drawn in fp32 from ``generator`` (seed 0 on
    ``device`` when None), then cast to ``dtype``."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, f = cfg.hidden_size, cfg.intermediate_size
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def lin(out_f, in_f):
        return Linear((randn(out_f, in_f) / math.sqrt(in_f)).to(dtype))

    def ones():
        return torch.ones((d,), dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.num_hidden_layers):
        layers.append({
            "self_attn": {
                "q_proj": lin(nh * hd, d),
                "k_proj": lin(nkv * hd, d),
                "v_proj": lin(nkv * hd, d),
                "o_proj": lin(d, nh * hd),
            },
            "mlp": {
                "gate_proj": lin(f, d),
                "up_proj": lin(f, d),
                "down_proj": lin(d, f),
            },
            "input_layernorm": ones(),
            "post_attention_layernorm": ones(),
        })
    params = {
        "embed_tokens": (randn(cfg.vocab_size, d) * 0.02).to(dtype),
        "layers": layers,
        "norm": ones(),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = lin(cfg.vocab_size, d)
    return params


@dataclasses.dataclass
class KVCache:
    """Dense KV cache: k/v are [L, B, n_kv, S_max, head_dim].

    With ``k_scales`` set the pools are int8 with per-row absmax scales
    [L, B, n_kv, S_max, 1] in fp32 (`ops.paged.quant_rows`): half the K/V
    bytes a decode step reads, the scheme of the paged pool's int8 pages."""

    k: torch.Tensor
    v: torch.Tensor
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda", quantize_kv: bool = False) -> KVCache:
    """A zeroed dense cache; with ``quantize_kv`` int8 pools and scales of
    one (``dtype`` is then unused)."""
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim_)
    if quantize_kv:
        scales = shape[:-1] + (1,)
        return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       k_scales=torch.ones(scales, dtype=torch.float32, device=device),
                       v_scales=torch.ones(scales, dtype=torch.float32, device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def cache_for(cfg):
    """The function that makes ``cfg``'s family's dense cache: the
    ``init_cache`` of the module that defines its config class
    (DeepSeek-V3's MLA cache, whose K and V rows differ in width),
    `init_cache` where that module has none. The engines and `Generator`
    make their caches through it."""
    return getattr(sys.modules.get(type(cfg).__module__), "init_cache", init_cache)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 (`ops.norm`): one launch of the fixed-order kernel
    for a CUDA tensor, its plain twin for a CPU one, the autograd Function
    where a gradient is wanted. A row's mean square is summed in an order
    set by the width alone, so a row's norm does not depend on the rows
    beside it (a speculative verify window's rows give a one-token decode
    step's logits)."""
    return apply_rms_norm(x, w, eps)


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """A LayerNorm leaf ``{"weight", "bias"}`` (bias optional) applied to x
    in fp32 (`ops.norm.layer_norm`, the fixed-order kernel; its twin on the
    CPU): the LayerNorm families' norms."""
    return apply_layer_norm(x, p["weight"], p.get("bias"), eps)


def refuse_int8_pools(cache, family: str) -> None:
    """Raise where a forward that reads the dense cache's float pools only
    is handed int8 ones."""
    if isinstance(cache, KVCache) and cache.quantized:
        raise ValueError(f"{family}: this family's attention reads the dense cache's float "
                         f"pools only; int8 KV pools (quantize_kv) are not served for it")


@functools.lru_cache(maxsize=64)
def _scalar_in(m: float, dtype: torch.dtype) -> float:
    return torch.tensor(m, dtype=dtype).item()


def _scaled(x: torch.Tensor, m: float) -> torch.Tensor:
    """x times the scalar m rounded to x's type, the product in that type
    (`hqq_tpu`'s ``x * jnp.asarray(m, x.dtype)``); no tensor is made on
    the device, so a captured step may call it."""
    return x * _scalar_in(float(m), x.dtype)


def _rope_params(head_dim: int, theta: float, scaling: Optional[tuple], device):
    """(inverse frequencies [hd/2], attention factor) with optional scaling:
    "linear" divides every frequency by ``factor``; "llama3" interpolates
    the low frequencies smoothly (Llama-3.1); "yarn" interpolates by parts
    between the beta_fast/beta_slow dims and scales cos/sin."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )
    if scaling is None:
        return inv_freq, 1.0
    rs = dict(scaling)
    factor = float(rs.get("factor", 1.0))
    rt = rs.get("rope_type")
    if rt == "linear":
        return inv_freq / factor, 1.0
    if rt == "llama3":
        low = float(rs.get("low_freq_factor", 1.0))
        high = float(rs.get("high_freq_factor", 4.0))
        old_ctx = float(rs.get("original_max_position_embeddings", 8192))
        wavelen = 2.0 * math.pi / inv_freq
        low_wl = old_ctx / low
        high_wl = old_ctx / high
        scaled = torch.where(wavelen > low_wl, inv_freq / factor, inv_freq)
        smooth = (old_ctx / wavelen - low) / (high - low)
        smoothed = (1.0 - smooth) * scaled / factor + smooth * scaled
        is_medium = (wavelen >= high_wl) & (wavelen <= low_wl)
        return torch.where(is_medium, smoothed, scaled), 1.0
    # yarn
    beta_fast = float(rs.get("beta_fast") or 32)
    beta_slow = float(rs.get("beta_slow") or 1)
    old_ctx = float(rs.get("original_max_position_embeddings", 4096))
    truncate = bool(rs.get("truncate", True))
    att = rs.get("attention_factor")
    if att is None:
        mscale, mscale_all = rs.get("mscale"), rs.get("mscale_all_dim")

        def get_mscale(scale, m=1.0):
            return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

        if mscale and mscale_all:
            att = get_mscale(factor, mscale) / get_mscale(factor, mscale_all)
        else:
            att = get_mscale(factor)

    def corr_dim(n_rot):
        return (head_dim * math.log(old_ctx / (n_rot * 2 * math.pi))) / (2 * math.log(theta))

    low = corr_dim(beta_fast)
    high = corr_dim(beta_slow)
    if truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, head_dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    extrapolation_factor = 1.0 - ramp
    inv = inv_freq / factor * (1 - extrapolation_factor) + inv_freq * extrapolation_factor
    return inv, float(att)


def _rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  scaling: Optional[tuple] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-convention rotary tables [T, head_dim] with duplicated halves."""
    inv_freq, att = _rope_params(head_dim, theta, scaling, positions.device)
    freqs = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * att, emb.sin() * att


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, H, T, hd]; HF 'rotate_half' convention."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.to(torch.float32) * cos + rotated.to(torch.float32) * sin).to(x.dtype)


def positions_and_masks(cfg: LlamaConfig, t: int, start_pos, cache_max_len: Optional[int],
                        device="cuda", kv_valid: Optional[torch.Tensor] = None):
    """Positions, RoPE tables and the additive attention mask for ``t``
    tokens from ``start_pos``: an int or a 0-d tensor (the whole batch at
    one offset; a tensor is never read on the host, so a captured decode
    step can advance it on the device) or a [B] tensor (every slot at its
    own). Over a cache of ``cache_max_len``
    slots the mask is [B|1, 1, T, S]; with ``cache_max_len=None`` it is the
    causal [1, 1, T, T] mask of the sequence itself. The mask adds
    finfo(float32).min, not -inf, so that a fully masked row stays finite.
    Over a cache, ``kv_valid`` [B, S] (bool) adds finfo(float32).min more
    at each slot it leaves out, as `hqq_tpu` does (a left-padded batch).
    Returns (positions, cos, sin, mask) with cos/sin [B|1, 1, T, hd]."""
    positions, pos_bt, mask = causal_mask(t, start_pos, cache_max_len, cfg.sliding_window,
                                          device)
    if cache_max_len is not None and kv_valid is not None:
        zero = torch.zeros((), dtype=torch.float32, device=device)
        mask = mask + torch.where(kv_valid.to(device), zero,
                                  torch.finfo(torch.float32).min)[:, None, None, :]
    hd = cfg.head_dim_
    cos, sin = _rope_cos_sin(pos_bt.reshape(-1), hd, cfg.rope_theta, cfg.rope_scaling)
    cos = cos.reshape(*pos_bt.shape, hd)[:, None]
    sin = sin.reshape(*pos_bt.shape, hd)[:, None]
    return positions, cos, sin, mask


def causal_mask(t: int, start_pos, cache_max_len: Optional[int], window: Optional[int],
                device="cuda"):
    """`positions_and_masks` without the RoPE tables (the families with
    ALiBi or learned positions): (positions [T] or [B, T], the same as
    [B|1, T], the additive mask [B|1, 1, T, S])."""
    steps = torch.arange(t, device=device)
    if isinstance(start_pos, torch.Tensor) and start_pos.ndim == 1:
        positions = start_pos.to(device)[:, None] + steps[None, :]  # [B, T]
        pos_bt = positions
    else:
        offset = start_pos.to(device) if isinstance(start_pos, torch.Tensor) else int(start_pos)
        positions = offset + steps  # [T]
        pos_bt = positions[None, :]
    if cache_max_len is None:
        visible = torch.ones((t, t), dtype=torch.bool, device=device).tril()[None]
        if window is not None:
            visible &= (steps[:, None] - steps[None, :]) < window
    else:
        key_pos = torch.arange(cache_max_len, device=device)
        visible = key_pos[None, None, :] <= pos_bt[:, :, None]  # [B|1, T, S]
        if window is not None:
            visible &= (pos_bt[:, :, None] - key_pos[None, None, :]) < window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    mask = torch.where(visible, zero, torch.finfo(torch.float32).min)
    return positions, pos_bt, mask[:, None]


def _update_stacked_cache(k_all: torch.Tensor, v_all: torch.Tensor, layer_idx: int,
                          k: torch.Tensor, v: torch.Tensor, start_pos) -> None:
    """Write new K/V [B, n_kv, t, hd] into the stacked cache at layer
    ``layer_idx``, in place; the offsets stay on the device and the cache
    is never rebuilt. ``start_pos`` an int or a 0-d tensor: `index_copy_`
    at start_pos + arange(t) for the whole batch. A [B] tensor: every slot
    at its own offset, one indexed write per pool for all (slot, token)
    pairs, as `hqq_tpu`'s scatter, which drops a row past the cache's end
    (a speculative verify window near ``max_len``). Torch's indexed write
    would raise there (on the card a device-side assert), so such rows are
    sent to the slot's last row carrying the value that row ends with:
    the window's own row there, or the cache's where the window starts
    past it. Every write to that row then holds one value, in any order,
    and nothing is read on the host."""
    t = k.shape[2]
    steps = torch.arange(t, device=k_all.device)
    if isinstance(start_pos, torch.Tensor) and start_pos.ndim == 1:
        last = k_all.shape[3] - 1
        start = start_pos.to(k_all.device)[:, None]  # [B, 1]
        slots = torch.arange(k.shape[0], device=k_all.device)[:, None]  # [B, 1]
        rows = (start + steps[None, :]).clamp_max(last)  # [B, t]
        src = rows - start  # the window row each write takes; < 0: none of them
        for pool, new in ((k_all[layer_idx], k), (v_all[layer_idx], v)):
            # the indexed dims go first: the value is [B, t, n_kv, hd] (K's
            # and V's hd may differ: the MLA cache)
            idx = src.clamp_min(0)[:, :, None, None].expand(-1, -1, new.shape[1], new.shape[3])
            val = torch.gather(new.transpose(1, 2).to(pool.dtype), 1, idx)
            val = torch.where((src >= 0)[:, :, None, None], val, pool[slots, :, rows])
            pool[slots, :, rows] = val
        return
    rows = steps + (
        start_pos.to(k_all.device) if isinstance(start_pos, torch.Tensor) else int(start_pos))
    k_all[layer_idx].index_copy_(2, rows, k.to(k_all.dtype))
    v_all[layer_idx].index_copy_(2, rows, v.to(v_all.dtype))


def _qkv_rope(layer: dict, cfg: LlamaConfig, x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, norm_offset: float = 0.0):
    """The projections of x [B, T, D] as heads [B, H, T, hd], q and k
    normed where the layer has norms, then rotated: OLMo-2's
    ``q_norm_flat``/``k_norm_flat`` over the flat projection, Qwen3's and
    Gemma-3's ``q_norm``/``k_norm`` per head (weights ``w + norm_offset``:
    1 for Gemma's)."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    if "qkv_proj" in layer:  # fused by `fuse_for_decode`, or Phi-3's own: one wide matmul
        q, k, v = torch.split(layer["qkv_proj"](x), [nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q, k, v = layer["q_proj"](x), layer["k_proj"](x), layer["v_proj"](x)
    if "q_norm_flat" in layer:
        q = rms_norm(q, layer["q_norm_flat"], cfg.rms_norm_eps)
        k = rms_norm(k, layer["k_norm_flat"], cfg.rms_norm_eps)
    q, k, v = q.reshape(b, t, nh, hd), k.reshape(b, t, nkv, hd), v.reshape(b, t, nkv, hd)
    if "q_norm" in layer:  # per head, on [B, T, H, hd] before the heads move
        q = apply_rms_norm(q, layer["q_norm"], cfg.rms_norm_eps, norm_offset)
        k = apply_rms_norm(k, layer["k_norm"], cfg.rms_norm_eps, norm_offset)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return _apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v


def _attention_nocache(layer: dict, cfg: LlamaConfig, x: torch.Tensor, mask: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Attention over the whole sequence, no cache (perplexity evaluation):
    the flash kernel for long plain-causal sequences, the naive path for
    short ones and for a sliding window (see `ops.attention`). K and V go in
    with their own heads: `prefill_attention` shares each among nh / n_kv
    query heads, where `hqq_tpu` repeats them first, to the same result."""
    from ..ops.attention import prefill_attention

    b, t, _ = x.shape
    hd = cfg.head_dim_
    q, k, v = _qkv_rope(layer, cfg, x, cos, sin)
    flash_ok = cfg.sliding_window is None
    out = prefill_attention(q, k, v, causal=True, mask=None if flash_ok else mask,
                            scale=hd**-0.5)
    out = out.transpose(1, 2).reshape(b, t, cfg.num_attention_heads * hd)
    return layer["o_proj"](out)


def _attention_paged(layer: dict, cfg: LlamaConfig, x: torch.Tensor, cache, layer_idx: int,
                     lengths: torch.Tensor, page_indices: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor, window: Optional[int] = None,
                     q_scale: Optional[float] = None, softcap: Optional[float] = None,
                     norm_offset: float = 0.0,
                     sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over a paged pool: the projections and RoPE of `_attention`,
    but K/V land in pages (in place) and attention is `ops.paged.paged_attn`.
    x is [B, T, D]: T = 1 for decode, T > 1 for a verify window, where all T
    rows are written first and query j attends the keys below
    lengths + j + 1, one paged-attention call each. ``q_scale`` replaces the
    1/sqrt(hd) query scaling (Granite's attention multiplier, Gemma-2's
    query_pre_attn_scalar); ``softcap``, ``window`` and ``sinks`` (gpt-oss's
    per-head sink logits) send the layer to the gather route, as in
    `hqq_tpu`. q goes in pre-scaled, in fp32 with int8 pages and in the
    pool's type otherwise."""
    from ..ops.paged import paged_attn, write_token_to_pages

    b, t, _ = x.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    pg = cache.page_size
    q, k, v = _qkv_rope(layer, cfg, x, cos, sin, norm_offset)

    pos_bt = lengths[:, None] + torch.arange(t, device=x.device)[None, :]  # [B, T]
    page_of = torch.gather(page_indices.long(), 1, pos_bt // pg)
    offset = pos_bt % pg
    # one flattened [B*T]-row write per pool
    kw = k.transpose(1, 2).reshape(b * t, nkv, hd)
    vw = v.transpose(1, 2).reshape(b * t, nkv, hd)
    write_token_to_pages(cache, layer_idx, kw, vw, page_of.reshape(-1), offset.reshape(-1))

    qdt = torch.float32 if cache.quantized else cache.k.dtype
    scale = hd**-0.5 if q_scale is None else q_scale
    qd = (q * scale).to(qdt)  # [B, nh, T, hd]
    attn = torch.stack(
        [paged_attn(qd[:, :, j], cache, layer_idx, lengths + j + 1, page_indices, window=window,
                    softcap=softcap, sinks=sinks)
         for j in range(t)], dim=1)  # [B, T, nh, hd]
    out = attn.reshape(b, t, nh * hd).to(x.dtype)
    return layer["o_proj"](out)


def _scores(q: torch.Tensor, keys: torch.Tensor, hd: int, scale: Optional[float],
            softcap: Optional[float]) -> torch.Tensor:
    """q @ keys^T summed and kept in fp32 (`preferred_element_type=float32`),
    divided by sqrt(hd) or multiplied by ``scale``, then capped as
    ``softcap * tanh(s / softcap)`` where given."""
    scores = q.to(torch.float32) @ keys.to(torch.float32).transpose(-1, -2)
    scores = scores / math.sqrt(hd) if scale is None else scores * scale
    return scores if softcap is None else torch.tanh(scores / softcap) * softcap


def _attention(layer: dict, cfg: LlamaConfig, x: torch.Tensor, cache: Optional[KVCache],
               layer_idx: int, start_pos, mask: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, scale: Optional[float] = None, softcap: Optional[float] = None,
               norm_offset: float = 0.0) -> torch.Tensor:
    """Attention over the stacked dense cache; writes the layer's new K/V
    into ``cache`` in place. With ``cache=None`` the keys are the sequence's
    own (the families whose cache-free attention is the naive product in
    `hqq_tpu`). ``scale`` replaces 1/sqrt(hd), ``softcap`` caps the scores
    (Granite, Gemma-2/3)."""
    q, k, v = _qkv_rope(layer, cfg, x, cos, sin, norm_offset)
    if cache is not None and cache.quantized:
        rep = cfg.num_attention_heads // cfg.num_key_value_heads  # GQA: query heads a kv head
        return layer["o_proj"](_attention_int8(q, k, v, cache, layer_idx, start_pos, mask, rep,
                                               scale, softcap))
    return layer["o_proj"](float_attention(q, k, v, cache, layer_idx, start_pos, mask, scale,
                                           softcap))


def float_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: Optional[KVCache],
                    layer_idx: int, start_pos, mask: torch.Tensor,
                    scale: Optional[float] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + mask) v for q [B, nh, T, hd] and the new
    k, v [B, n_kv, T, hd], over the float pools of the dense cache (written
    in place first) or, with ``cache=None``, over the sequence's own keys;
    each kv head serves nh / n_kv query heads. The scores are summed and
    kept in fp32 (`_scores`); the probabilities are rounded to q's type
    before the product. Returns the heads merged, [B, T, nh * v's hd] (V
    rows may be narrower than q and K's: the MLA cache)."""
    b, nh, t, hd = q.shape
    if cache is None:
        keys, vals = k, v
    else:
        _update_stacked_cache(cache.k, cache.v, layer_idx, k, v, start_pos)
        keys, vals = cache.k[layer_idx], cache.v[layer_idx]
    rep = nh // keys.shape[1]
    if rep > 1:
        keys = _repeat_heads(keys, rep)
        vals = _repeat_heads(vals, rep)
    probs = torch.softmax(_scores(q, keys, hd, scale, softcap) + mask, dim=-1).to(q.dtype)
    return (probs @ vals).transpose(1, 2).reshape(b, t, nh * vals.shape[-1])


def _attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: KVCache,
                    layer_idx: int, start_pos, mask: torch.Tensor, rep: int,
                    scale: Optional[float] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """`_attention` over int8 pools: the new rows absmax-quantized per row
    and written with their scales, then the scales applied after the
    products (`hqq_tpu`'s scale-after-dot): the K scales multiply the score
    columns and the V scales fold into the probabilities, so no dequantized
    window is formed. Returns the heads merged, [B, T, nh * hd]."""
    from ..ops.paged import quant_rows

    b, nh, t, hd = q.shape
    kq, ks = quant_rows(k)
    vq, vs = quant_rows(v)
    _update_stacked_cache(cache.k, cache.v, layer_idx, kq, vq, start_pos)
    _update_stacked_cache(cache.k_scales, cache.v_scales, layer_idx, ks, vs, start_pos)
    keys, vals = cache.k[layer_idx], cache.v[layer_idx]
    ksl, vsl = cache.k_scales[layer_idx] / 127.0, cache.v_scales[layer_idx] / 127.0
    if rep > 1:
        keys, vals = _repeat_heads(keys, rep), _repeat_heads(vals, rep)
        ksl, vsl = _repeat_heads(ksl, rep), _repeat_heads(vsl, rep)
    ksl, vsl = ksl[..., 0], vsl[..., 0]  # [B, nh, S]
    scores = q.to(torch.float32) @ keys.to(torch.float32).transpose(-1, -2)
    if scale is None:
        scores = scores * (ksl[:, :, None, :] / math.sqrt(hd))
    else:
        scores = scores * ksl[:, :, None, :] * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    probs = torch.softmax(scores + mask, dim=-1)
    probs = (probs * vsl[:, :, None, :]).to(q.dtype)
    out = probs @ vals.to(q.dtype)
    return out.transpose(1, 2).reshape(b, t, nh * hd)


def _repeat_heads(x: torch.Tensor, rep: int) -> torch.Tensor:
    """[B, n_kv, S, hd] -> [B, n_kv * rep, S, hd], each head ``rep`` times
    in a row (`repeat_interleave` by an expanded view: no host read)."""
    b, n, s, hd = x.shape
    return x[:, :, None].expand(b, n, rep, s, hd).reshape(b, n * rep, s, hd)


def _mlp(layer: dict, x: torch.Tensor) -> torch.Tensor:
    if "gate_up_proj" in layer:  # fused by `fuse_for_decode`
        gate, up = layer["gate_up_proj"](x).chunk(2, dim=-1)
        return layer["down_proj"](F.silu(gate) * up)
    return layer["down_proj"](F.silu(layer["gate_proj"](x)) * layer["up_proj"](x))


def _logits(params: dict, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        return x.to(torch.float32) @ params["embed_tokens"].to(torch.float32).t()
    return params["lm_head"](x).to(torch.float32)


def _forward_paged(params: dict, cfg: LlamaConfig, tokens: torch.Tensor, cache,
                   lengths: torch.Tensor, page_indices: torch.Tensor, mlp_fn=None):
    """One paged step for all slots (T = 1 decode; T = k verify window):
    tokens [B] or [B, T], lengths [B] the position of each slot's first new
    token, page_indices [B, MP]. ``mlp_fn(layer, h)`` lets a family with
    another MLP block reuse the walk. Returns (logits [B, T, V] fp32,
    cache), the pool updated in place."""
    if mlp_fn is None:
        mlp_fn = lambda layer, h: _mlp(layer["mlp"], h)  # noqa: E731
    toks = tokens if tokens.ndim == 2 else tokens[:, None]
    x = params["embed_tokens"][toks]
    lengths = lengths.to(x.device)
    page_indices = page_indices.to(x.device)
    _, cos, sin, _ = positions_and_masks(cfg, toks.shape[1], lengths, None, x.device)

    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        x = x + _attention_paged(layer["self_attn"], cfg, h, cache, i, lengths, page_indices,
                                 cos, sin, window=cfg.sliding_window)
        h = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + mlp_fn(layer, h)
    return _logits(params, cfg, x), cache


def forward(
    params: dict,
    cfg: LlamaConfig,
    tokens: Optional[torch.Tensor],
    cache=None,
    start_pos=0,
    kv_valid: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    page_indices: Optional[torch.Tensor] = None,
    seq_axis: Optional[str] = None,
):
    """Run the model over ``tokens`` [B, T] from ``start_pos``. Returns
    (logits [B, T, V] fp32, cache), the cache updated in place.
    ``kv_valid`` [B, S_max] masks slots of the dense cache (left-padded
    batches); ``inputs_embeds`` [B, T, D] replaces the token embedding
    (multimodal prefixes), as in `hqq_tpu`.

    With a dense `KVCache`, ``start_pos`` is an int or a 0-d tensor on the
    device, which is never read on the host (a captured decode step
    advances it there). With a `PagedKVCache`
    and ``page_indices`` [B, MP] this is one paged decode step per slot at
    the offsets ``start_pos`` [B]. With ``cache=None`` attention is causal
    over the T tokens themselves and no cache comes back (perplexity
    evaluation)."""
    from ..ops.paged import PagedKVCache

    if seq_axis is not None:
        raise NotImplementedError("a page pool sharded over devices is not ported yet")
    if isinstance(cache, PagedKVCache):
        if page_indices is None:
            raise ValueError("a PagedKVCache needs page_indices")
        start_pos = torch.as_tensor(start_pos, device=cache.k.device)
        return _forward_paged(params, cfg, tokens, cache, start_pos, page_indices)
    x = inputs_embeds if inputs_embeds is not None else params["embed_tokens"][tokens]
    t = x.shape[1]
    device = x.device
    _, cos, sin, mask = positions_and_masks(
        cfg, t, start_pos, None if cache is None else cache.max_len, device, kv_valid)

    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        if cache is None:
            x = x + _attention_nocache(layer["self_attn"], cfg, h, mask, cos, sin)
        else:
            x = x + _attention(layer["self_attn"], cfg, h, cache, i, start_pos, mask, cos, sin)
        h = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + _mlp(layer["mlp"], h)
    return _logits(params, cfg, x), cache
