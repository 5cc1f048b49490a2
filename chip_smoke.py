# SPDX-License-Identifier: Apache-2.0
"""Chip smoke test of hqq_tpu_torch: 4-bit HQQ Llama-2-7B on one GPU.

    python3 chip_smoke.py            # on cuda:0; takes no arguments

Phases (any failure exits non-zero):
  (a) device and build: the card, its power limit, and an nvcc build of
      every kernel under hqq_tpu_torch/csrc/;
  (b) each kernel against its plain PyTorch version at the main path's
      shapes: largest error against the stated tolerance, kernel time, plain
      time, the least time the card could take (bound), and for the matmuls
      torch.matmul on the pre-dequantized bf16 weight (a yardstick only);
  (c) the main path: Llama-2-7B at full width and depth with random weights
      from a seed, quantize_model(4-bit, g64), prepare_for_inference("w4a8"),
      generate for 4 prompts of 100 tokens (prefill M = 4*128 = 512 rows),
      one sampled request of batch 1, and .dequantize() of a prepared layer;
      every kernel's launch count must move;
  (d) end to end, on a 2-layer model at 7B width: prefill logits under
      "pallas" against "xla" on the same quantized weights; four decode
      steps under "w4a8", each w4a8 call held to its plain version on the
      same inputs, and the logits against the same steps through the plain
      version; wrong-meta controls that every bar must catch.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of every kernel
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
ROTATE_BYTES = 160 * 2**20  # cycle through input copies larger than the 50 MB L2

SRC = "hqq_tpu_torch/csrc/"
REPLACES = {
    "w4a8_matmul": "hqq_tpu/ops/fused_matmul.py:524",
    "quant_matmul": "hqq_tpu/ops/fused_matmul.py:307",
    "dequant": "hqq_tpu/ops/fused_matmul.py:982",
}
ALSO_REPLACES = {"w4a8_matmul": "hqq_tpu/ops/fused_matmul.py:776"}


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fns, iters: int) -> float:
    """Device time of one call, cycling through ``fns`` (one per input
    copy): the summed duration of every kernel and copy the calls ran on
    the card, from torch.profiler's CUDA trace, over ``iters`` calls after a
    warm-up. Host time between launches is not counted (at decode sizes it
    exceeds the kernels' own)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    if total_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return total_us / 1e3 / iters


def device_share(fn) -> dict:
    """Run ``fn`` once under torch.profiler: the wall time, the share of it
    the device spent in kernels and copies (one stream, so their durations
    add up), and the five kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    return dict(wall_ms=wall_ms, busy_share=device_ms / wall_ms,
                top={e.key[:40]: round(e.self_device_time_total / 1e3, 3) for e in top})


def phase_a(name: str, power: str) -> None:
    from hqq_tpu_torch.ops import _build

    log(f"[a] device: {name}; count {torch.cuda.device_count()}; nvidia-smi: {power}")
    log(f"[a] torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    logs = _build.build_all()
    log(f"[a] built {sorted(logs) or 'nothing (cached)'} in {time.time() - t0:.1f} s")
    for kname, text in sorted(logs.items()):
        regs = re.findall(r"Used (\d+) registers", text)
        spills = re.findall(r"(\d+) bytes spill stores", text)
        log(f"[a]   {kname}: {len(regs)} instantiations, registers {min(map(int, regs))}-"
            f"{max(map(int, regs))}, spill stores up to {max(map(int, spills))} bytes")


def _make_kqt(n: int, k: int, g: int, nbits: int, seed: int):
    from hqq_tpu_torch.core.quantize import quantize
    from hqq_tpu_torch.ops.fused_matmul import to_kernel_layout

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((n, k), generator=gen, device="cuda") / k**0.5
    qt = quantize(w, nbits=nbits, group_size=g, axis=1, round_zero=(nbits == 4))
    return to_kernel_layout(qt)


def _copies(kqt, x, bytes_each: int):
    """Input copies enough to overflow L2, so that each timed call reads its
    weight from device memory as the model's calls do."""
    import dataclasses

    n = max(1, min(16, -(-ROTATE_BYTES // max(bytes_each, 1))))
    kqts = [kqt] + [dataclasses.replace(kqt, wq=kqt.wq.clone(), scale=kqt.scale.clone(),
                                        zs=kqt.zs.clone()) for _ in range(n - 1)]
    xs = [x] + [x.clone() for _ in range(n - 1)] if x is not None else [None] * n
    return kqts, xs


def phase_b() -> dict:
    from hqq_tpu_torch.ops import fused_matmul as fm

    iters = 100
    g = 64
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(1)

    def record(key, row):
        rows.setdefault(key, []).append(row)
        log("[b] " + json.dumps(row))

    # -- w4a8_matmul: M in {1, 4, 32} at the 7B shapes, and K % 8g != 0 ------
    shapes = [(4096, 4096), (4096, 11008), (11008, 4096)]
    cases = [(m, k, n) for (k, n) in shapes for m in (1, 4, 32)]
    cases.append((4, 4096 + 3 * g, 4096))  # K % 8g != 0 (the `_qmm_a8_kernel` route)
    for (m, k, n) in cases:
        kqt = _make_kqt(n, k, g, 4, seed=k * 7 + n)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        x8, sx = fm.quantize_activations_int8(x)
        worst = 0.0
        for out_dtype, tol_rel in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)):
            y = fm.w4a8_matmul(x8, sx, kqt, out_dtype).float()
            ref = fm.w4a8_matmul_plain(x8, sx, kqt, out_dtype).float()
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            scale = ref.abs().max().item()
            # fp32: the group dots are exact, the fp32 epilogue sums in
            # another order; bf16: plus one rounding step of the output
            if not (err <= tol_rel * scale) or not torch.isfinite(y).all():
                raise AssertionError(f"w4a8_matmul M={m} K={k} N={n} {out_dtype}: "
                                     f"err {err} > {tol_rel} * {scale}")
            worst = max(worst, err)
        wbytes = kqt.wq.numel() + 8 * kqt.scale.numel()
        kq, xq = _copies(kqt, x8, wbytes)
        sxs = [sx.clone() for _ in kq]
        ms = time_ms([lambda a=a, b=b, s=s: fm.w4a8_matmul(b, s, a, torch.bfloat16)
                      for a, b, s in zip(kq, xq, sxs)], iters)
        plain = time_ms([lambda: fm.w4a8_matmul_plain(x8, sx, kqt, torch.bfloat16)], max(3, iters // 10))
        w_bf16 = fm.dequant_plain(kqt, torch.bfloat16)
        lib = time_ms([lambda: torch.matmul(x, w_bf16.t())], iters)
        del w_bf16, kq, xq, sxs
        nbytes = wbytes + m * k + 4 * m + 2 * m * n
        b_ms, by = bound_ms(nbytes, 2.0 * m * n * k, "int8")
        record("w4a8_matmul", dict(kernel="w4a8_matmul", m=m, k=k, n=n, max_abs_err=worst,
                                   ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                                   library_ms=lib))

    # -- quant_matmul at the prefill shape ---------------------------------
    for (m, k, n) in [(512, 4096, 4096), (512, 4096, 11008), (512, 11008, 4096)]:
        kqt = _make_kqt(n, k, g, 4, seed=k * 3 + n)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        y = fm.quant_matmul(x, kqt).float()
        ref = fm.quant_matmul_plain(x, kqt).float()
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        scale = ref.abs().max().item()
        # identical bf16 operands and exact products; fp32 sums in another
        # order, then one bf16 rounding of the output (2^-7 of its magnitude)
        if not (err <= 2.0**-7 * scale) or not torch.isfinite(y).all():
            raise AssertionError(f"quant_matmul M={m} K={k} N={n}: err {err} > 2^-7 * {scale}")
        wbytes = kqt.wq.numel() + 8 * kqt.scale.numel()
        kq, xq = _copies(kqt, x, wbytes)
        ms = time_ms([lambda a=a, b=b: fm.quant_matmul(b, a) for a, b in zip(kq, xq)], iters)
        plain = time_ms([lambda: fm.quant_matmul_plain(x, kqt)], max(3, iters // 10))
        w_bf16 = fm.dequant_plain(kqt, torch.bfloat16)
        lib = time_ms([lambda: torch.matmul(x, w_bf16.t())], iters)
        del w_bf16, kq, xq
        b_ms, by = bound_ms(wbytes + 2 * m * k + 2 * m * n, 2.0 * m * n * k, "bf16")
        record("quant_matmul", dict(kernel="quant_matmul", m=m, k=k, n=n, max_abs_err=err,
                                    ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                                    library_ms=lib))

    # -- dequant of one 4096 x 11008 layer (down_proj: out 4096, in 11008) --
    n, k = 4096, 11008
    kqt = _make_kqt(n, k, g, 4, seed=5)
    w = fm.dequant(kqt, torch.bfloat16)
    ref = fm.dequant_plain(kqt, torch.bfloat16)
    torch.cuda.synchronize()
    err = (w.float() - ref.float()).abs().max().item()
    # the same fp32 multiply and subtract, the same rounding: exact
    if err != 0.0:
        raise AssertionError(f"dequant {n}x{k}: err {err} != 0")
    wbytes = kqt.wq.numel() + 8 * kqt.scale.numel()
    kq, _ = _copies(kqt, None, wbytes + 2 * n * k)
    ms = time_ms([lambda a=a: fm.dequant(a, torch.bfloat16) for a in kq], iters)
    plain = time_ms([lambda: fm.dequant_plain(kqt, torch.bfloat16)], max(3, iters // 10))
    del kq, w, ref
    b_ms, by = bound_ms(wbytes + 2 * n * k, 2.0 * n * k, "fp32")
    record("dequant", dict(kernel="dequant", m=None, k=k, n=n, max_abs_err=err, ms=ms,
                           plain_ms=plain, bound_ms=b_ms, bound_by=by, library_ms=None))
    torch.cuda.empty_cache()
    return rows


def phase_c(dev_tag: str) -> dict:
    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.engine.hf import HQQModel
    from hqq_tpu_torch.models.llama import LlamaConfig, init_params
    from hqq_tpu_torch.ops import fused_matmul as fm

    cfg = LlamaConfig.llama2_7b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    log(f"[c] init_params {cfg.num_hidden_layers} layers: {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    model = HQQModel(params, cfg)
    del params
    t0 = time.time()
    model.quantize_model(BaseQuantizeConfig(nbits=4, group_size=64))
    torch.cuda.synchronize()
    quant_s = time.time() - t0
    t0 = time.time()
    model.prepare_for_inference("w4a8")
    torch.cuda.synchronize()
    prep_s = time.time() - t0
    gc.collect()
    log(f"[c] quantize_model {quant_s:.2f} s, prepare_for_inference(w4a8) {prep_s:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    prompts = torch.randint(0, cfg.vocab_size, (4, 100),
                            generator=torch.Generator().manual_seed(0)).numpy()
    new = 32

    # the least a decode step must read: every linear's codes, scale and zs
    # (and lm_head's bf16 weight) once, plus the K/V of the positions
    # attended, here on average prompt + new/2 (embeddings: B rows, left out)
    def step_bytes(tree):
        if isinstance(tree, dict):
            return sum(step_bytes(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(step_bytes(v) for v in tree)
        if hasattr(tree, "kqt"):
            return sum(t.numel() * t.element_size() for t in (tree.kqt.wq, tree.kqt.scale, tree.kqt.zs))
        if hasattr(tree, "weight"):
            return tree.weight.numel() * tree.weight.element_size()
        return 0

    kv_bytes = (2 * cfg.num_hidden_layers * prompts.shape[0] * cfg.num_key_value_heads
                * cfg.head_dim_ * 2 * (prompts.shape[1] + new // 2))
    bound_step_ms = (step_bytes(model.params) + kv_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"[c] decode bound: {step_bytes(model.params) / 1e9:.3f} GB of weights and meta + "
        f"{kv_bytes / 1e9:.3f} GB of K/V per step -> {bound_step_ms:.3f} ms per step, "
        f"{prompts.shape[0] / bound_step_ms * 1e3:.1f} tok/s at B={prompts.shape[0]}")

    # the main path's window: every count from 0, read right after
    fm.reset_launch_counts()
    model.generate(prompts, max_new_tokens=1)  # first call: lazy set-up
    torch.cuda.synchronize()
    t0 = time.time()
    model.generate(prompts, max_new_tokens=1)
    torch.cuda.synchronize()
    prefill_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    out = model.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.time() - t0
    decode_tok_s = prompts.shape[0] * (new - 1) / (gen_s - prefill_ms / 1e3)
    sampled = model.generate(prompts[:1], max_new_tokens=16, do_sample=True, top_k=20,
                             top_p=0.9, seed=1)
    busy = device_share(lambda: model.generate(prompts, max_new_tokens=8))
    w_dq = model.params["layers"][0]["mlp"]["down_proj"].dequantize()
    torch.cuda.synchronize()
    launches = {"w4a8_matmul": fm.w4a8_matmul.launches,
                "quant_matmul": fm.quant_matmul.launches,
                "dequant": fm.dequant.launches}
    log(f"[c] launches in the main path: {launches}")

    if out.shape != (4, new) or sampled.shape != (1, 16):
        raise AssertionError(f"unexpected output shapes {out.shape}, {sampled.shape}")
    for ids in (out, sampled):
        if ids.min() < 0 or ids.max() >= cfg.vocab_size:
            raise AssertionError("token ids outside the vocabulary")
    if tuple(w_dq.shape) != (4096, 11008) or w_dq.dtype != torch.bfloat16 \
            or not torch.isfinite(w_dq).all():
        raise AssertionError("dequantize() of a prepared layer is wrong")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[c] greedy ids[0][:8] {out[0][:8].tolist()}; sampled {sampled[0][:8].tolist()}")
    log(f"[c] {dev_tag}: prefill (B=4, t_pad=128, + first token) {prefill_ms:.1f} ms; "
        f"decode {decode_tok_s:.1f} tok/s total over B=4; peak memory {peak:.2f} GiB; "
        f"quantize {quant_s:.2f} s")
    log(f"[c] {dev_tag}: 8-token generate (B=4): device busy {busy['busy_share']:.3f} of "
        f"{busy['wall_ms']:.1f} ms wall; device ms by kernel: {busy['top']}")
    del model, w_dq
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_d(n_layers: int = 2) -> None:
    import dataclasses
    from unittest import mock

    from hqq_tpu_torch import BaseQuantizeConfig
    from hqq_tpu_torch.models.base import quantize_model
    from hqq_tpu_torch.models.llama import (KVCache, LlamaConfig, forward, init_cache,
                                            init_params)
    from hqq_tpu_torch.ops import fused_matmul as fm
    from hqq_tpu_torch.utils.patching import prepare_for_inference

    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), num_hidden_layers=n_layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2), torch.bfloat16, "cuda")
    quantize_model(params, BaseQuantizeConfig(nbits=4, group_size=64))
    t, steps = 128, 4
    toks = torch.randint(0, cfg.vocab_size, (4, t + steps), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(3))

    def prefill(backend_params):
        return forward(backend_params, cfg, toks[:, :t],
                       init_cache(cfg, 4, 256, torch.bfloat16, "cuda"), 0)

    def containers(tree):
        # new dicts and lists over the same leaves: prepare_for_inference
        # swaps layers in place, and the xla tree must stay as it is
        if isinstance(tree, dict):
            return {k: containers(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [containers(v) for v in tree]
        return tree

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    def wrong(field):
        # a control: each group takes its neighbour's scale (or zs)
        def fn(x8, sx, kqt, out_dtype):
            bad = dataclasses.replace(kqt, **{field: getattr(kqt, field).roll(1, dims=1)})
            return fm.w4a8_matmul_plain(x8, sx, bad, out_dtype)
        return fn

    controls = {"scale": wrong("scale"), "zs": wrong("zs")}
    per_call = {"kernel": [], "scale": [], "zs": []}
    kernel = fm.w4a8_matmul  # the wrapper, taken before decode() patches its name

    def checked(x8, sx, kqt, out_dtype):
        """The kernel, held on the spot to its plain version on the same
        inputs (the activations the path really produces), and the controls
        likewise; returns the kernel's output, so the path runs on it."""
        y = kernel(x8, sx, kqt, out_dtype)
        ref = fm.w4a8_matmul_plain(x8, sx, kqt, out_dtype)
        per_call["kernel"].append(rel(y, ref))
        for f, fn in controls.items():
            per_call[f].append(rel(fn(x8, sx, kqt, out_dtype), ref))
        return y

    # the wrapper counts its launches on whatever its module name holds,
    # here this function (phase c has read the counts already)
    checked.launches = 0

    with torch.inference_mode():
        # prefill (M = 512): the pallas backend against xla
        xla_pre, _ = prefill(params)
        pal_pre, _ = prefill(prepare_for_inference(containers(params), "pallas"))

        # decode steps of M = 4 rows (the w4a8 route) from one w4a8 prefill
        a8 = prepare_for_inference(params, "w4a8")
        _, cache = prefill(a8)

        def decode(w4a8_fn):
            """Logits of the decode steps from a copy of the cache, with
            ``w4a8_fn`` in place of the w4a8 kernel's wrapper."""
            c = KVCache(k=cache.k.clone(), v=cache.v.clone())
            out = []
            with mock.patch.object(fm, "w4a8_matmul", w4a8_fn):
                for i in range(steps):
                    logits, c = forward(a8, cfg, toks[:, t + i:t + i + 1], c, t + i)
                    out.append(logits)
            return torch.cat(out, dim=1)

        a8_dec = decode(checked)
        plain_dec = decode(fm.w4a8_matmul_plain)
        e2e = {"kernel": rel(a8_dec, plain_dec),
               **{f: rel(decode(fn), plain_dec) for f, fn in controls.items()}}

    r_pre = rel(pal_pre, xla_pre)
    call = {k: (min(v), max(v)) for k, v in per_call.items()}
    # pallas vs xla: the same bf16 weights; bf16 activations summed in
    # another order change some bf16 roundings, which two layers carry into
    # the logits. w4a8 kernel vs plain, call by call on the same inputs: the
    # group dots are exact, the fp32 epilogue sums in another order, then
    # one bf16 rounding of the output (2^-7 of max|y|, the bar of phase b).
    # The same, end to end: one bf16 step of an output near its row's max
    # is half an int8 step of the next layer's activations, so the paths
    # flip some roundings and then many; the bar lies between those
    # readings and the controls' (a wrong group scale or zs).
    tol_pre, tol_call, tol_e2e = 2e-2, 2.0**-7, 0.1
    log(f"[d] {n_layers}-layer 7B-width prefill logits, pallas vs xla: rel err {r_pre:.3e} "
        f"(tol {tol_pre})")
    log(f"[d] {steps} decode steps, {len(per_call['kernel'])} w4a8 calls, each vs its plain "
        f"version on the same inputs: rel err up to {call['kernel'][1]:.3e} (tol {tol_call:.3e}); "
        f"controls, neighbour's scale {call['scale'][0]:.3e} and neighbour's zs "
        f"{call['zs'][0]:.3e} at the least (must exceed it)")
    log(f"[d] {steps} decode steps, logits through the kernel vs through its plain version: "
        f"rel err {e2e['kernel']:.3e} (tol {tol_e2e}); controls, neighbour's scale "
        f"{e2e['scale']:.3e}, neighbour's zs {e2e['zs']:.3e} (must exceed it)")
    if not (torch.isfinite(pal_pre).all() and torch.isfinite(a8_dec).all()):
        raise AssertionError("non-finite logits")
    if not (r_pre < tol_pre and call["kernel"][1] <= tol_call and e2e["kernel"] < tol_e2e):
        raise AssertionError("the pallas or w4a8 path disagrees with its reference")
    if not (min(call["scale"][0], call["zs"][0]) > tol_call
            and min(e2e["scale"], e2e["zs"]) > tol_e2e):
        raise AssertionError("a bar does not catch a wrong group scale or zs")
    del params, a8, cache
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the GPU only")
        return 1
    import hqq_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev_tag = f"[{power}]"

    t_start = time.time()
    phase_a(name, power)
    rows = phase_b()
    launches = phase_c(dev_tag)
    phase_d()

    pick = {"w4a8_matmul": (4, 4096, 11008), "quant_matmul": (512, 4096, 4096),
            "dequant": (None, 11008, 4096)}
    kernels = []
    for kname, (m, k, n) in pick.items():
        row = next(r for r in rows[kname] if (r["m"], r["k"], r["n"]) == (m, k, n))
        entry = dict(name=kname, route="cuda", source=SRC + kname + ".cu",
                     replaces=REPLACES[kname],
                     launches=launches[kname],
                     max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
                     bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                     library_ms=row["library_ms"], shape=dict(m=row["m"], k=row["k"], n=row["n"]))
        if kname in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[kname]
        kernels.append(entry)
    log(f"[done] {time.time() - t_start:.1f} s")
    log(power)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
