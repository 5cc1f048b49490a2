# SPDX-License-Identifier: Apache-2.0
"""The one-command server: a checkpoint behind HTTP, on the card.

    python -m hqq_tpu_torch.serve --model /path/to/checkpoint --port 8000 \\
        --backend w4a8 --engine paged --slots 8

Mirrors `hqq_tpu.serve`. ``--model`` is, detected by its files, an
`hqq_tpu.v1` checkpoint (``hqq_config.json``, written by either package's
`save_quantized`; `from_quantized`) or a Hugging Face directory of fp
weights (``config.json``), quantized on the fly (``--nbits``,
``--group-size``). The tree is prepared for ``--backend``, fused for
decode (q/k/v and gate/up; ``--no-fuse`` keeps them apart), and served by
the paged engine (the paged-attention kernel) or the dense one
(``--engine dense``) through `serving.server.InferenceServer`. Everything
runs on ``--device`` (``cuda`` unless given).

A LLaVA checkpoint (``model_type`` llava, quantized by either package's
`engine.vl.HQQVLModel` or an HF directory quantized on the fly) serves
image requests: its text tree is prepared and fused as a Llama's, its
vision tree (the CLIP tower and the projector) stays as `quantize_model`
left it, and the server's embedder runs it on a request's
``pixel_values`` and splices the image rows over the placeholders
(`_build_llava_engine`). Qwen2-VL and Aria are refused with
`hqq_tpu.serve`'s SystemExit: they serve through the Python API
(`engine.vl`; Qwen2-VL on the dense engine with ``mrope_offsets``, Aria on
the dense engine with `models.aria.forward` as its forward).

Not served yet, each refused with an error that names what is missing: a
GPTQ checkpoint (`models/interop`) and ``--tp`` above 1 (`parallel/`).
A family whose forward has no paged branch (OLMo-2, the LayerNorm
families and DeepSeek-V3, whose MLA cache is its own) is served on the
dense engine, with a line that says so; one whose attention reads float
KV pools only (Phi-2, Cohere, GPT-2, BLOOM, Falcon, gpt-oss, DeepSeek-V3)
refuses ``--int8-kv`` before any weight is read. The MoE families
(Mixtral, Qwen3-MoE, gpt-oss) serve on either engine; their
checkpoints come from the families' own quantizers (``quantize_mixtral``,
...), while an HF directory quantized on the fly keeps its experts in bf16
(`quantize_model` quantizes `Linear` leaves only, as in `hqq_tpu`).
``--tokenizer`` imports `transformers` at start, only when asked.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

import torch

__all__ = ["build_engine", "make_parser", "main"]

# the vision-language model types: llava is served, qwen2_vl and aria serve
# through the Python API
_VL_TYPES = ("llava", "qwen2_vl", "aria")


def _read_model_type(model_dir: str):
    """The ``model_type`` of a checkpoint directory: `hqq_tpu.v1`
    checkpoints hold it in ``hqq_config.json`` (under "config"), HF
    directories in ``config.json``."""
    for name in ("hqq_config.json", "config.json"):
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            with open(path) as f:
                conf = json.load(f)
            return conf.get("config", conf).get("model_type") or conf.get("model_type")
    raise FileNotFoundError(f"{model_dir}: neither hqq_config.json nor config.json")


def _vl_type(model_dir: str):
    """The vision-language ``model_type`` of a checkpoint directory (llava,
    qwen2_vl or aria), else None; None too where the directory holds
    neither config file (the loader then says so), as `hqq_tpu.serve`'s
    ``_detect_vl``."""
    try:
        model_type = _read_model_type(model_dir)
    except FileNotFoundError:
        return None
    return model_type if model_type in _VL_TYPES else None


def _check_served(args, model_type: str) -> None:
    """Refuse, before any weight is read, what cannot be served: Qwen2-VL
    and Aria (with `hqq_tpu.serve`'s message), and ``--int8-kv`` for a family
    whose forward reads the dense cache's float pools only (the config's
    ``reads_int8_kv``)."""
    from .engine.hf import _lookup_arch

    if model_type in _VL_TYPES and model_type != "llava":
        raise SystemExit(
            f"VL type {model_type!r} serves through the Python API "
            f"(engine.vl.AutoHQQVLModel — M-RoPE decode needs per-request "
            f"positions the CLI engines don't carry); only llava (plain "
            f"RoPE) serves via the CLI")
    if model_type in _VL_TYPES:
        return
    if args.int8_kv and not getattr(_lookup_arch(model_type)["config_cls"], "reads_int8_kv",
                                    True):
        raise ValueError(f"--int8-kv: the {model_type} family's forward reads the dense cache's "
                         f"float pools only; int8 KV is not served for it")


def _load(args):
    """(params, cfg, family forward) of ``--model``, quantized, on the
    device."""
    from .core.quantize import BaseQuantizeConfig
    from .engine.hf import HQQModelForCausalLM

    model_dir = args.model
    _check_served(args, _read_model_type(model_dir))
    if os.path.exists(os.path.join(model_dir, "hqq_config.json")):
        model = HQQModelForCausalLM.from_quantized(model_dir, device=args.device)
    else:
        with open(os.path.join(model_dir, "config.json")) as f:
            conf = json.load(f)
        if (conf.get("quantization_config") or {}).get("quant_method") == "gptq":
            raise NotImplementedError(
                f"{model_dir}: a GPTQ checkpoint needs models/interop.py (load_gptq), which "
                f"is not ported yet")
        model = HQQModelForCausalLM.from_pretrained(model_dir, device=args.device)
        model.quantize_model(BaseQuantizeConfig(nbits=args.nbits, group_size=args.group_size))
    return model.params, model.cfg, model._arch["forward"]


def build_engine(args):
    """The serving engine ``args`` describe (see `make_parser`)."""
    from .serving.batching import family_name
    from .utils.patching import fuse_for_decode, prepare_for_inference

    if args.tp > 1:
        raise NotImplementedError(
            f"--tp {args.tp}: tensor-parallel serving needs parallel/ (the sharded tree and "
            f"forward over torch.distributed), which is not ported yet")
    vl_type = _vl_type(args.model)
    if vl_type is not None:
        _check_served(args, vl_type)
        return _build_llava_engine(args)
    params, cfg, family_fwd = _load(args)
    params = prepare_for_inference(params, args.backend)
    if args.fuse:
        params = fuse_for_decode(params)
    if args.engine == "paged" and "page_indices" not in inspect.signature(family_fwd).parameters:
        # a family forward without a paged branch serves on the dense engine
        print(f"# the {family_name(cfg)} family's forward has no paged branch: serving with "
              f"--engine dense", file=sys.stderr)
        args.engine = "dense"
    if args.engine == "paged":
        def fwd(p, toks, cache, pos, ptab=None):
            return family_fwd(p, cfg, toks, cache, pos, page_indices=ptab)
    else:
        def fwd(p, toks, cache, pos):
            return family_fwd(p, cfg, toks, cache, pos)
    return _engine_for(args, params, cfg, forward_fn=fwd)


def _build_llava_engine(args):
    """A LLaVA checkpoint behind the engine, and its embedder on
    ``engine._vl_embedder`` for the server: the text tree prepared for
    ``--backend`` and fused as a Llama's; the vision tree (tower and
    projector) as `quantize_model` left it, its quantized layers
    dequantizing their W in each forward. The embedder takes a request's
    ids and ``{"pixel_values": [B, C, H, W]}`` and gives its embeddings
    [T, D] on the device: the tower, the projector, the image rows over
    the ``image_token_index`` placeholders (a ValueError where the count or
    the pixels' shape is wrong)."""
    from .core.quantize import BaseQuantizeConfig
    from .engine.vl import AutoHQQVLModel
    from .models import llava
    from .utils.patching import fuse_for_decode, prepare_for_inference

    if os.path.exists(os.path.join(args.model, "hqq_config.json")):
        m = AutoHQQVLModel.from_quantized(args.model, device=args.device)
    else:
        m = AutoHQQVLModel.from_pretrained(args.model, device=args.device).quantize_model(
            BaseQuantizeConfig(nbits=args.nbits, group_size=args.group_size))
    cfg = m.cfg
    vision_tree = m.params["vision"]  # {"vision", "projector"}, unprepared
    text = prepare_for_inference(m.params["text"], args.backend)
    if args.fuse:
        text = fuse_for_decode(text)
    engine = _engine_for(args, text, cfg.text)
    vc = cfg.vision
    want = (vc.num_channels, vc.image_size, vc.image_size)
    device = torch.device(args.device)

    @torch.inference_mode()
    def embedder(prompt_ids, vl_inputs: dict) -> torch.Tensor:
        px = torch.as_tensor(vl_inputs["pixel_values"], dtype=torch.float32, device=device)
        if px.ndim == 3:
            px = px[None]
        if px.ndim != 4 or tuple(px.shape[1:]) != want:
            raise ValueError(f"pixel_values must be [B, {want[0]}, {want[1]}, {want[2]}], got "
                             f"{tuple(px.shape)}")
        img = llava.vision_forward(vision_tree, cfg, px).reshape(-1, cfg.text.hidden_size)
        toks = torch.as_tensor([list(prompt_ids)], dtype=torch.int64, device=device)
        return llava.embed_multimodal({"text": text}, cfg, toks, img)[0]

    embedder.vision_tree = vision_tree  # what it runs, for callers that time or check it
    engine._vl_embedder = embedder
    return engine


def _node_compute_dtype(node):
    """The compute dtype a layer carries, by this package's attribute for
    each kind: an `Int8QuantLinear`'s own, a kernel-layout layer's
    ``kqt``'s, a `QuantLinear`'s ``qweight``'s, a `LoRALinear`'s base's;
    None for anything else (a dense `Linear`, a norm)."""
    from .backends.int8_backend import Int8QuantLinear
    from .core.peft import LoRALinear
    from .nn.linear import QuantLinear

    if isinstance(node, Int8QuantLinear):
        return node.compute_dtype
    if isinstance(node, QuantLinear):
        return node.qweight.compute_dtype
    if isinstance(node, LoRALinear):
        return _node_compute_dtype(node.base)
    kqt = getattr(node, "kqt", None)  # the kernel-layout layers of both axes, LoRA too
    return None if kqt is None else kqt.compute_dtype


def _infer_cache_dtype(params):
    """The KV cache's dtype: the activations', which the quantized layers'
    compute dtype sets (not the fp leaves such as norms). The first
    quantized layer in tree order decides; bf16 where there is none, as in
    `hqq_tpu`."""
    stack = [params]
    while stack:
        node = stack.pop(0)
        if isinstance(node, dict):
            stack[:0] = list(node.values())
            continue
        if isinstance(node, (list, tuple)):
            stack[:0] = list(node)
            continue
        dt = _node_compute_dtype(node)
        if dt is not None:
            return dt
    return torch.bfloat16


def _engine_for(args, params, cfg, forward_fn=None):
    cache_dtype = _infer_cache_dtype(params)
    if args.engine == "paged":
        from .serving.paged import PagedBatchingEngine

        return PagedBatchingEngine(
            params, cfg, batch_slots=args.slots, num_pages=args.num_pages,
            page_size=args.page_size, max_pages_per_seq=args.max_pages_per_seq,
            eos_token_id=args.eos, do_sample=args.sample, horizon=args.horizon,
            quantize_kv=args.int8_kv, enable_prefix_cache=args.prefix_cache,
            prefill_chunk=args.prefill_chunk, forward_fn=forward_fn, cache_dtype=cache_dtype,
            device=args.device)
    from .serving.batching import ContinuousBatchingEngine

    return ContinuousBatchingEngine(
        params, cfg, batch_slots=args.slots, max_len=args.max_len, eos_token_id=args.eos,
        do_sample=args.sample, horizon=args.horizon, quantize_kv=args.int8_kv,
        forward_fn=forward_fn, cache_dtype=cache_dtype, device=args.device)


def make_parser():
    from .engine.hf import _HQQ_REGISTRY

    p = argparse.ArgumentParser("hqq_tpu_torch.serve")
    p.add_argument("--model", required=True,
                   help=f"checkpoint directory; model types served: {', '.join(_HQQ_REGISTRY)}")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda", help="torch device of the model and engine")
    p.add_argument("--backend", default="w4a8", choices=("w4a8", "int8", "pallas", "xla"))
    p.add_argument("--engine", default="paged", choices=("paged", "dense"))
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree (not ported yet: only 1)")
    p.add_argument("--fuse", action="store_true", default=True)
    p.add_argument("--no-fuse", dest="fuse", action="store_false")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--max-pages-per-seq", type=int, default=64)
    p.add_argument("--horizon", type=int, default=8)
    p.add_argument("--int8-kv", action="store_true")
    p.add_argument("--prefix-cache", action="store_true")
    p.add_argument("--prefill-chunk", type=int, default=None)
    p.add_argument("--eos", type=int, default=None)
    p.add_argument("--sample", action="store_true")
    p.add_argument("--nbits", type=int, default=4, help="on-the-fly quant bits")
    p.add_argument("--group-size", type=int, default=64)
    p.add_argument("--tokenizer", action="store_true",
                   help="load an HF tokenizer from --model for text I/O (needs transformers)")
    return p


def main(argv=None, serve: bool = True):
    """Build the engine and its server; with ``serve`` run it until
    interrupted, else return it unstarted (call ``.start()``)."""
    args = make_parser().parse_args(argv)
    engine = build_engine(args)
    tokenizer = None
    if args.tokenizer:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model)

    from .serving.server import InferenceServer

    srv = InferenceServer(engine, host=args.host, port=args.port, tokenizer=tokenizer,
                          embedder=getattr(engine, "_vl_embedder", None))
    print(f"serving {args.model} [{args.backend}/{args.engine}] on {args.device}, "
          f"{args.host}:{srv.port}", flush=True)
    if serve:  # pragma: no cover - interactive entry
        srv.serve_forever()
    return srv


if __name__ == "__main__":  # pragma: no cover
    main()
