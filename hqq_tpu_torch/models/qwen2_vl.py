# SPDX-License-Identifier: Apache-2.0
"""Qwen2-VL: a vision tower (a ViT with 2-D rotary embeddings and a patch
merger) and a Qwen2 text model with M-RoPE, the multimodal 3-D rotary
embedding.

Mirrors `hqq_tpu.models.qwen2_vl` (HF ``modeling_qwen2_vl.py``):

* vision: patches are [N, C*tp*p*p] rows (the stride-equals-kernel Conv3d
  as a matmul). Each block is pre-LN (eps 1e-6) attention through the
  fused ``attn_qkv``, with q and k rotated by 2-D tables in fp32 (half the
  head by the patch's row, half by its column, the patches grouped by
  spatial_merge_size), non-causal within each frame of each image (a
  block-diagonal additive mask of finfo(float32).min), then a quick-GELU
  MLP. The merger layer-norms (``ln_q``) and joins each 2 x 2 group, then
  ``merger_fc1``, GELU, ``merger_fc2``. The GELU there is the tanh form:
  `hqq_tpu` calls ``jax.nn.gelu`` with its default, where HF uses erf; the
  port follows `hqq_tpu`;
* text: the Llama walk with attention biases, whose cos/sin come from
  three position streams (temporal, height, width): the head is cut into
  ``mrope_section`` chunks, doubled over the two rotary halves, chunk i
  driven by stream i % 3. Text tokens carry equal streams, which is
  ordinary RoPE.

Every LayerNorm is one launch of the fixed-order kernel (`ops.norm`); the
tower's attention is plain torch (scores and softmax in fp32), as
`hqq_tpu` computes it outside any Pallas kernel. The text attention is
`models.llama._attention` over the dense cache, fed the M-RoPE tables.

`serving_forward_fns` gives the dense engine's two forwards for
``mrope_offsets=True``: after the prompt the three streams advance
together, so each slot's decode position is its cache length plus one
offset.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.linear import Linear
from . import llama
from .llama import KVCache, init_cache, layer_norm, rms_norm  # noqa: F401 (re-export)
from .llava import quick_gelu, splice_rows

__all__ = ["VisionConfig", "Qwen2VLConfig", "init_params", "vision_forward", "forward",
           "embed_multimodal", "get_mrope_positions", "params_from_hf_state_dict",
           "serving_forward_fns", "init_cache"]


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 3584  # the text width the merger projects into
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    mlp_ratio: int = 4

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @classmethod
    def from_hf(cls, hf: dict) -> "VisionConfig":
        return cls(
            depth=hf.get("depth", 32),
            embed_dim=hf.get("embed_dim", 1280),
            hidden_size=hf.get("hidden_size", 3584),
            num_heads=hf.get("num_heads", 16),
            in_channels=hf.get("in_channels", 3),
            patch_size=hf.get("patch_size", 14),
            spatial_merge_size=hf.get("spatial_merge_size", 2),
            temporal_patch_size=hf.get("temporal_patch_size", 2),
            mlp_ratio=hf.get("mlp_ratio", 4),
        )


@dataclasses.dataclass(frozen=True)
class Qwen2VLConfig:
    text: llama.LlamaConfig
    vision: VisionConfig
    mrope_section: Tuple[int, ...] = (16, 24, 24)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652

    @classmethod
    def from_hf(cls, hf: dict) -> "Qwen2VLConfig":
        tc = dict(hf.get("text_config", hf))
        # M-RoPE lives in rope_scaling but is no frequency transform: it
        # comes out before the Llama config reads the rest
        rs = tc.get("rope_scaling") or {}
        section = tuple(rs.get("mrope_section", (16, 24, 24)))
        tc = dict(tc, rope_scaling=None, attention_bias=True)
        return cls(
            text=llama.LlamaConfig.from_hf(tc),
            vision=VisionConfig.from_hf(hf.get("vision_config", {})),
            mrope_section=section,
            image_token_id=hf.get("image_token_id", 151655),
            video_token_id=hf.get("video_token_id", 151656),
            vision_start_token_id=hf.get("vision_start_token_id", 151652),
        )

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "Qwen2VLConfig":
        """Test size, the vision token ids inside the tiny vocabulary."""
        return cls(
            text=llama.LlamaConfig.tiny(vocab_size=vocab_size),
            vision=VisionConfig(depth=2, embed_dim=64, hidden_size=256, num_heads=4,
                                patch_size=4, mlp_ratio=2),
            mrope_section=(16, 8, 8),
            image_token_id=vocab_size - 2,
            video_token_id=vocab_size - 3,
            vision_start_token_id=vocab_size - 4,
        )


def init_params(cfg: Qwen2VLConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """A random {"text", "vision"} tree in `hqq_tpu`'s layout: vision
    linears N(0, 0.05^2) with zero biases (the patch embed has none),
    LayerNorms weight one and bias zero, drawn in fp32 from ``generator``
    (seed 0 on ``device`` when None), cast to ``dtype``; the text tree is
    `llama.init_params`'s, drawn last."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    vc = cfg.vision
    e = vc.embed_dim

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def lin(o, i, bias=True):
        return Linear((randn(o, i) * 0.05).to(dtype),
                      torch.zeros((o,), dtype=dtype, device=device) if bias else None)

    def ln(d):
        return {"weight": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}

    vision = {
        "patch_embed": lin(e, vc.patch_dim, bias=False),
        "blocks": [{"norm1": ln(e), "attn_qkv": lin(3 * e, e), "attn_proj": lin(e, e),
                    "norm2": ln(e), "fc1": lin(e * vc.mlp_ratio, e),
                    "fc2": lin(e, e * vc.mlp_ratio)}
                   for _ in range(vc.depth)],
        "merger_ln_q": ln(e),
        "merger_fc1": lin(4 * e, 4 * e),
        "merger_fc2": lin(vc.hidden_size, 4 * e),
    }
    return {"vision": vision, "text": llama.init_params(cfg.text, generator, dtype, device)}


# --------------------------------------------------------------------------
# vision tower
# --------------------------------------------------------------------------


def _vision_rope_tables(cfg: VisionConfig, grid_thw) -> Tuple[np.ndarray, np.ndarray]:
    """The 2-D rotary tables [N, head_dim] for ``grid_thw`` (a (t, h, w)
    per image), on the host in fp32; positions permuted into
    spatial_merge_size x spatial_merge_size groups, the order the merger
    reads (HF ``rot_pos_emb``)."""
    m = cfg.spatial_merge_size
    hd = cfg.head_dim
    pos = []
    for t, h, w in grid_thw:
        hp = np.arange(h)[:, None].repeat(w, 1)
        wp = np.arange(w)[None, :].repeat(h, 0)

        def perm(a):
            return a.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)

        pos.append(np.tile(np.stack([perm(hp), perm(wp)], axis=-1), (t, 1)))  # [t*h*w, 2]
    pos = np.concatenate(pos, axis=0)
    inv = 1.0 / (10000.0 ** (np.arange(0, hd // 2, 2, dtype=np.float32) / (hd // 2)))
    freqs = (pos[..., None].astype(np.float32) * inv).reshape(len(pos), -1)  # [N, hd/2]
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb), np.sin(emb)


def _segment_mask(grid_thw) -> np.ndarray:
    """The block-diagonal additive mask [N, N]: 0 within a frame of an
    image, finfo(float32).min across (HF's cu_seqlens of h*w per frame)."""
    seg = np.concatenate([np.full(h * w, 1000 * i + f)
                          for i, (t, h, w) in enumerate(grid_thw) for f in range(t)])
    allow = seg[:, None] == seg[None, :]
    return np.where(allow, 0.0, np.finfo(np.float32).min).astype(np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def vision_forward(params: dict, cfg: VisionConfig, patches: torch.Tensor,
                   grid_thw) -> torch.Tensor:
    """The tower over patch rows [N, C*tp*p*p] with ``grid_thw`` a (t, h,
    w) per image (N = sum of t*h*w): merged rows [N / merge^2, hidden]."""
    nh, hd = cfg.num_heads, cfg.head_dim
    n = patches.shape[0]
    dev = patches.device
    x = params["patch_embed"](patches)  # [N, E]
    cos_np, sin_np = _vision_rope_tables(cfg, grid_thw)
    cos = torch.from_numpy(cos_np).to(dev)[None]  # [1, N, hd], over the heads
    sin = torch.from_numpy(sin_np).to(dev)[None]
    mask = torch.from_numpy(_segment_mask(grid_thw)).to(dev)

    for blk in params["blocks"]:
        h = layer_norm(x, blk["norm1"], 1e-6)
        qkv = blk["attn_qkv"](h).reshape(n, 3, nh, hd)
        q, k, v = (qkv[:, j].transpose(0, 1) for j in range(3))  # [nh, N, hd]
        qf, kf = q.to(torch.float32), k.to(torch.float32)
        q = (qf * cos + _rotate_half(qf) * sin).to(x.dtype)
        k = (kf * cos + _rotate_half(kf) * sin).to(x.dtype)
        scores = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) * (hd ** -0.5)
        probs = torch.softmax(scores + mask, dim=-1).to(x.dtype)
        att = (probs @ v.to(x.dtype)).transpose(0, 1).reshape(n, nh * hd)
        x = x + blk["attn_proj"](att)
        h = layer_norm(x, blk["norm2"], 1e-6)
        x = x + blk["fc2"](quick_gelu(blk["fc1"](h)))

    m2 = cfg.spatial_merge_size ** 2
    h = layer_norm(x, params["merger_ln_q"], 1e-6).reshape(n // m2, m2 * cfg.embed_dim)
    return params["merger_fc2"](F.gelu(params["merger_fc1"](h), approximate="tanh"))


# --------------------------------------------------------------------------
# text tower (Qwen2 with M-RoPE)
# --------------------------------------------------------------------------


def _mrope_cos_sin(cfg: Qwen2VLConfig, position_ids: torch.Tensor):
    """cos/sin [B, 1, T, head_dim] from the three streams ``position_ids``
    [3, B, T]: the head cut into ``mrope_section`` chunks (doubled over the
    rotary halves), chunk i from stream i % 3 (HF
    ``apply_multimodal_rotary_pos_emb``)."""
    hd = cfg.text.head_dim_
    dev = position_ids.device
    inv = 1.0 / (cfg.text.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=dev) / hd))
    freqs = position_ids[..., None].to(torch.float32) * inv  # [3, B, T, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos3, sin3 = emb.cos(), emb.sin()
    sections = list(cfg.mrope_section) * 2
    off, cos_parts, sin_parts = 0, [], []
    for i, sec in enumerate(sections):
        cos_parts.append(cos3[i % 3, ..., off:off + sec])
        sin_parts.append(sin3[i % 3, ..., off:off + sec])
        off += sec
    return torch.cat(cos_parts, dim=-1)[:, None], torch.cat(sin_parts, dim=-1)[:, None]


def forward(params: dict, cfg: Qwen2VLConfig, tokens: Optional[torch.Tensor],
            cache: Optional[KVCache] = None, start_pos=0,
            position_ids: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None):
    """The text forward (the Llama walk with M-RoPE tables). With
    ``position_ids=None`` the three streams all equal start_pos + arange(t),
    ordinary RoPE; ``position_ids`` [3, B, T] gives them (an image's
    patches); ``inputs_embeds`` [B, T, D] replaces the token embedding (the
    image rows spliced in, `embed_multimodal`). ``start_pos`` as in
    `llama.forward` over the dense cache (an int, a 0-d or a [B] tensor);
    ``cache=None`` attends over the sequence itself. Returns (logits [B, T,
    V] fp32, cache)."""
    tcfg = cfg.text
    x = inputs_embeds if inputs_embeds is not None else params["embed_tokens"][tokens]
    t = x.shape[1]
    dev = x.device
    _, cos, sin, mask = llama.positions_and_masks(
        tcfg, t, start_pos, None if cache is None else cache.max_len, dev)
    if position_ids is not None:
        cos, sin = _mrope_cos_sin(cfg, position_ids.to(dev))
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["input_layernorm"], tcfg.rms_norm_eps)
        if cache is None:
            x = x + llama._attention_nocache(layer["self_attn"], tcfg, h, mask, cos, sin)
        else:
            x = x + llama._attention(layer["self_attn"], tcfg, h, cache, i, start_pos, mask,
                                     cos, sin)
        h = rms_norm(x, layer["post_attention_layernorm"], tcfg.rms_norm_eps)
        x = x + llama._mlp(layer["mlp"], h)
    return llama._logits(params, tcfg, x), cache


def embed_multimodal(params: dict, cfg: Qwen2VLConfig, tokens: torch.Tensor,
                     image_embeds: torch.Tensor) -> torch.Tensor:
    """The token embedding of ``tokens`` [B, T] (``params`` the text tree)
    with row j of ``image_embeds`` over the j-th ``image_token_id``
    placeholder; the count is checked on the host (`llava.splice_rows`)."""
    emb = params["embed_tokens"][tokens.to(params["embed_tokens"].device)]
    return splice_rows(emb, tokens, cfg.image_token_id, image_embeds)


def get_mrope_positions(cfg: Qwen2VLConfig, tokens, grid_thw) -> np.ndarray:
    """The M-RoPE position ids [3, 1, T] of one sequence, on the host (HF
    ``get_rope_index``): a text token advances all three streams together;
    an image's placeholders take (t, h, w) grid positions (h and w in
    merged units) from the running position; after an image the streams
    go on at its largest position plus one."""
    toks = np.asarray(tokens).reshape(-1)
    m = cfg.vision.spatial_merge_size
    pos = np.zeros((3, len(toks)), np.int64)
    cur = img = i = 0
    while i < len(toks):
        if toks[i] == cfg.image_token_id:
            t, h, w = grid_thw[img]
            h, w = h // m, w // m
            n = t * h * w
            pos[0, i:i + n] = cur + np.repeat(np.arange(t), h * w)
            pos[1, i:i + n] = cur + np.tile(np.repeat(np.arange(h), w), t)
            pos[2, i:i + n] = cur + np.tile(np.arange(w), t * h)
            cur += max(t, h, w)
            img += 1
            i += n
        else:
            pos[:, i] = cur
            cur += 1
            i += 1
    return pos[:, None, :]


# --------------------------------------------------------------------------
# HF weights and serving
# --------------------------------------------------------------------------


def params_from_hf_state_dict(state: dict, cfg: Qwen2VLConfig, dtype=torch.bfloat16):
    """(text tree, vision tree) of an HF ``Qwen2VLForConditionalGeneration``
    state dict: the text under ``model.language_model.`` (transformers >=
    4.52) or ``model.``, the tower under ``visual.`` or ``model.visual.``."""
    from .hf import params_from_hf_state_dict as llama_loader

    text_state = {}
    for k, v in state.items():
        for pref in ("model.language_model.", "language_model.model."):
            if k.startswith(pref):
                text_state["model." + k[len(pref):]] = v
                break
        else:
            if (k.startswith("model.") and not k.startswith("model.visual.")) \
                    or k == "lm_head.weight":
                text_state[k] = v
    text = llama_loader(text_state, cfg.text, dtype)

    vpref = next(p for p in ("model.visual.", "visual.") if any(k.startswith(p) for k in state))

    def arr(name):
        return state[vpref + name].to(dtype)

    def lin(name):
        bias = vpref + name + ".bias"
        return Linear(arr(name + ".weight"), arr(name + ".bias") if bias in state else None)

    def ln(name):
        return {"weight": arr(name + ".weight"), "bias": arr(name + ".bias")}

    vc = cfg.vision
    blocks = [{"norm1": ln(f"blocks.{i}.norm1"), "attn_qkv": lin(f"blocks.{i}.attn.qkv"),
               "attn_proj": lin(f"blocks.{i}.attn.proj"), "norm2": ln(f"blocks.{i}.norm2"),
               "fc1": lin(f"blocks.{i}.mlp.fc1"), "fc2": lin(f"blocks.{i}.mlp.fc2")}
              for i in range(vc.depth)]
    vision = {
        "patch_embed": Linear(arr("patch_embed.proj.weight").reshape(vc.embed_dim, -1)),
        "blocks": blocks,
        "merger_ln_q": ln("merger.ln_q"),
        "merger_fc1": lin("merger.mlp.0"),
        "merger_fc2": lin("merger.mlp.2"),
    }
    return text, vision


def serving_forward_fns(cfg: Qwen2VLConfig):
    """(forward_fn, embeds_forward_fn) for `ContinuousBatchingEngine(...,
    mrope_offsets=True)`. Decode rotates at cache length + the slot's
    offset ``offs`` [B] (its prompt's largest position + 1 - its length,
    `get_mrope_positions`; 0 for a text-only slot, ordinary RoPE), which
    gives `engine.vl.HQQVLModel.generate`'s positions; the embeds forward
    takes the prompt's [3, 1, T] position ids."""

    def fwd(params, toks, cache, pos, offs=None):
        if offs is None:  # a token prefill: a text-only prompt
            return forward(params, cfg, toks, cache, pos)
        b, t = toks.shape
        steps = torch.arange(t, device=offs.device)
        base = torch.as_tensor(pos, device=offs.device) + offs
        pid = (base[:, None] + steps[None, :])[None].expand(3, b, t)
        return forward(params, cfg, toks, cache, pos, position_ids=pid)

    def efwd(params, embeds, cache, pos, position_ids):
        return forward(params, cfg, None, cache, pos, position_ids=position_ids,
                       inputs_embeds=embeds)

    return fwd, efwd
