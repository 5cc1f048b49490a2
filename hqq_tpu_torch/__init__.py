# SPDX-License-Identifier: Apache-2.0
"""hqq_tpu_torch — Half-Quadratic Quantization in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of `hqq_tpu` (JAX/Pallas) that follows its module tree and public
names: `core` (bit packing, the proximal solver, `quantize`/`dequantize`),
`nn` (quantized linear layers, multi-LoRA, stacked MoE experts), `ops`
(the fused matmul, grouped expert, paged-attention, flash-attention,
RMSNorm and LayerNorm kernels and their host side), `backends` and
`utils.patching` (inference backends, `fuse_for_decode`), `models`
(Llama and the RMSNorm families on its walk: Mistral, Granite, Gemma,
Gemma-2, Gemma-3, Phi-3, OLMo-2; the LayerNorm families: StarCoder2,
Phi-2, Cohere, GPT-2, BLOOM, Falcon; the MoE families: Mixtral,
Qwen3-MoE, gpt-oss), `serving` (generation, the paged and dense continuous-batching
engines, speculative decoding, the HTTP server), `serve` (the one-command server,
``python -m hqq_tpu_torch.serve``), `utils.eval` (perplexity),
`utils.training` (HQQ+ LoRA training) and `engine` (the user-facing
model).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .core import BaseQuantizeConfig, QTensor, dequantize, quantize  # noqa: F401
