# SPDX-License-Identifier: Apache-2.0
"""RMSNorm and LayerNorm as fixed-order fp32 kernels.

``rms_norm``: ``y = (x * rsqrt(mean(x^2) + eps)) * (w + offset)`` over the
last dim of x, every step in fp32 and y rounded to x's type: ``offset`` 0
for Llama-style norms (`hqq_tpu.models.llama.rms_norm`), 1 for Gemma's
``(1 + w)`` (`hqq_tpu.models.gemma._gemma_norm`).

``layer_norm``: ``y = ((x - mu) * rsqrt(var + eps)) * w [+ b]`` with ``mu =
mean(x)`` and ``var = mean((x - mu)^2)``, the two-pass form of `hqq_tpu`'s
three LayerNorms (`vit._layer_norm`, `phi.layer_norm`, and
`cohere.cohere_norm` with a weight only); w and b may be [d] or per head
[H, d] over x [..., H, d].

Both wrappers launch ``csrc/rms_norm.cu`` for CUDA tensors (one launch a
call, counted in ``rms_norm.launches`` and ``layer_norm.launches``) and run
their plain twins, `rms_norm_plain` and `layer_norm_plain`, for CPU
tensors. Every sum of a row runs in one order that `norm_launch_plan`
derives from the width and the element size alone: ``threads`` threads a
row (a power of two, at least a warp), thread t summing the vectors t, t +
threads, ... of ``vec`` elements one element at a time, then the threads'
sums combined by halving. So a row's output is bit-equal whether it is
normed alone or among 1024 rows, which a PyTorch reduction does not
promise (its order depends on how many rows one call reduces). The twins
repeat the kernel's every rounding: they are bit-equal to it, not merely
close.

`apply_rms_norm` and `apply_layer_norm` are what the models call: the
wrapper, or under autograd `RMSNormFunction` / `LayerNormFunction`, whose
backward is the plain formula in PyTorch (`hqq_tpu` differentiates XLA's
norms; there is no Pallas kernel to port).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .fused_matmul import _on_cpu, _ptr, _stream

__all__ = ["NormPlan", "norm_launch_plan", "rms_norm", "rms_norm_plain", "RMSNormFunction",
           "apply_rms_norm", "layer_norm", "layer_norm_plain", "LayerNormFunction",
           "apply_layer_norm"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# threads a block holds at least where a row takes fewer (several rows a block)
_BLOCK_THREADS = 256
_MAX_ROW_THREADS = 1024
# LayerNorm (csrc/rms_norm.cu `kLnRegFloats`, `kLnMaxBlock`): the values of x
# a thread holds in registers, the most threads of a row, the threads a
# block holds at least
_LN_REG_FLOATS = 40
_LN_MAX_ROW_THREADS = 512
_LN_BLOCK_THREADS = 128


@dataclasses.dataclass(frozen=True)
class NormPlan:
    """How a norm sums a row of ``d`` elements: ``threads`` threads a row,
    each summing ``steps`` vectors of ``vec`` elements (the vectors t, t +
    threads, ...; the last step may be short), ``rows_per_block`` rows a
    block of ``rows_per_block * threads`` threads."""

    vec: int
    threads: int
    steps: int
    rows_per_block: int

    @property
    def threads_log2(self) -> int:
        return self.threads.bit_length() - 1


@functools.lru_cache(maxsize=256)
def norm_launch_plan(d: int, dtype: torch.dtype, layer: bool = False) -> NormPlan:
    """The summation order and launch of a norm over rows of ``d`` elements
    of ``dtype``, by these two and the norm alone. A thread loads 16 bytes
    at a time (``vec`` = 16 / element size) where d is a multiple of that,
    else one element. RMSNorm: a row takes the largest power of two of threads that
    gives each about two vectors, at least 32 (a warp) and at most 1024;
    rows of fewer than 256 threads share a block. LayerNorm (``layer``):
    its kernel holds a row in registers, at most 40 values a thread, so a
    row takes the fewest threads (a power of two, at least a warp, at most
    512) whose vectors fit that, and rows of fewer than 128 threads share a
    block: one warp a row up to 1280 values of bf16 or fp32, 4 rows a
    block. Rows wider than 512 threads hold (20480 values) have a plan, the
    twin's order, but no kernel."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"the norms take fp32, bf16 or fp16 rows, not {dtype}")
    if d < 1:
        raise ValueError(f"the norms need rows of at least one element, got d={d}")
    v16 = 16 // torch.empty((), dtype=dtype).element_size()
    vec = v16 if d % v16 == 0 else 1
    nvec = d // vec
    if layer:
        threads = 32
        while threads < _LN_MAX_ROW_THREADS and -(-nvec // threads) * vec > _LN_REG_FLOATS:
            threads *= 2
        return NormPlan(vec=vec, threads=threads, steps=-(-nvec // threads),
                        rows_per_block=max(1, _LN_BLOCK_THREADS // threads))
    threads = 1 << max(0, (max(1, nvec // 2)).bit_length() - 1)
    threads = min(_MAX_ROW_THREADS, max(32, threads))
    return NormPlan(vec=vec, threads=threads, steps=-(-nvec // threads),
                    rows_per_block=max(1, _BLOCK_THREADS // threads))


def _plan_sum(v: torch.Tensor, plan: NormPlan) -> torch.Tensor:
    """The kernel's sum of each row of fp32 ``v`` [..., d], to the bit: the
    threads' strided partial sums by explicit elementwise adds (padding
    with -0.0, which adds nothing to any value), then the halving tree.
    Returns [..., 1]."""
    d = v.shape[-1]
    pad = plan.steps * plan.threads * plan.vec - d
    if pad:
        v = F.pad(v, (0, pad), value=-0.0)
    v = v.reshape(*v.shape[:-1], plan.steps, plan.threads, plan.vec)
    acc = torch.zeros(v.shape[:-3] + (plan.threads,), dtype=torch.float32, device=v.device)
    for k in range(plan.steps):
        for j in range(plan.vec):
            acc = acc + v[..., k, :, j]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc


def _mean(total: torch.Tensor, d: int) -> torch.Tensor:
    """total / d as a true division: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal instead, which parts from
    __fdiv_rn in the last bit."""
    return total / torch.full((), d, dtype=torch.float32, device=total.device)


def rms_norm_plain(x: torch.Tensor, w: torch.Tensor, eps: float,
                   offset: float = 0.0) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, to the bit: the squares summed
    in the plan's order (`_plan_sum`), then ms / d, 1 / sqrt(ms + eps) and
    (x * r) * (w + offset), each one correctly rounded fp32 operation.
    The route for CPU tensors, and the kernel's reference on the card."""
    xf = x.to(torch.float32)
    ms = _mean(_plan_sum(xf * xf, norm_launch_plan(x.shape[-1], x.dtype)), x.shape[-1])
    rinv = torch.reciprocal(torch.sqrt(ms + eps))
    return ((xf * rinv) * (w.to(torch.float32) + offset)).to(x.dtype)


def _rows_of(x: torch.Tensor, name: str):
    """(x as contiguous, 16-byte aligned rows [rows, d], an output like
    them) for a kernel of ``name``; fewer than 2^31 rows."""
    x2 = x.reshape(-1, x.shape[-1])
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.contiguous() if not x2.is_contiguous() else x2.clone()
    if x2.shape[0] >= 2**31:
        raise ValueError(f"{name} takes fewer than 2^31 rows, got {x2.shape[0]}")
    return x2, torch.empty_like(x2)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float, offset: float = 0.0) -> torch.Tensor:
    """RMSNorm of x [..., d] with weight w [d]: the kernel for a CUDA
    tensor (or an error), the plain twin for a CPU one. y has x's shape
    and type, laid out contiguously."""
    if _on_cpu(x):
        return rms_norm_plain(x, w, eps, offset)
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise ValueError(f"rms_norm takes fp32, bf16 or fp16 x and w, not {x.dtype}, {w.dtype}")
    if tuple(w.shape) != (d,) or w.device != x.device:
        raise ValueError(f"w must be [{d}] on {x.device}, got {tuple(w.shape)} on {w.device}")
    plan = norm_launch_plan(d, x.dtype)
    x2, out = _rows_of(x, "rms_norm")
    w = w.contiguous()
    rows = x2.shape[0]
    if rows == 0:
        return out.reshape(x.shape)
    lib = _build.library("rms_norm")
    with torch.cuda.device(x.device):
        code = lib.hqq_rms_norm(
            _ptr(x2, 16), _ptr(w, w.element_size()), _ptr(out, 16), rows, d, eps, offset,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], plan.vec, plan.threads_log2,
            plan.rows_per_block, _stream(x.device))
    _build.check("rms_norm", code)
    rms_norm.launches += 1
    return out.reshape(x.shape)


rms_norm.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """`rms_norm` with a gradient: the forward is the kernel (the twin on
    the CPU), the backward the plain formula in fp32,
    dx = r * g' - x * r^3 * mean(g' * x) with g' = g * (w + offset) and
    dw = sum over rows of g * x * r."""

    @staticmethod
    def forward(ctx, x, w, eps: float, offset: float):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.offset = eps, offset
        return rms_norm(x, w, eps, offset)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xf, gf = x.to(torch.float32), g.to(torch.float32)
        rinv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + ctx.eps)
        gw = gf * (w.to(torch.float32) + ctx.offset)
        dx = rinv * gw - xf * rinv.pow(3) * (gw * xf).mean(dim=-1, keepdim=True)
        dw = None
        if ctx.needs_input_grad[1]:
            dw = (gf * xf * rinv).reshape(-1, x.shape[-1]).sum(0).to(w.dtype)
        return dx.to(x.dtype), dw, None, None


def apply_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
                   offset: float = 0.0) -> torch.Tensor:
    """The norm as the models call it: `RMSNormFunction` where a gradient
    is wanted, else the wrapper itself."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNormFunction.apply(x, w, float(eps), float(offset))
    return rms_norm(x, w, float(eps), float(offset))


def layer_norm_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                     eps: float) -> torch.Tensor:
    """The LayerNorm kernel's arithmetic in PyTorch, to the bit: the sum of
    x in the plan's order, mu = sum / d, the sum of (x - mu)^2 in the same
    order, var = sum / d, 1 / sqrt(var + eps), then ((x - mu) * r) * w and
    + b where given, each one correctly rounded fp32 operation. w and b are
    [d] or [H, d] over x [..., H, d]. The route for CPU tensors, and the
    kernel's reference on the card."""
    d = x.shape[-1]
    plan = norm_launch_plan(d, x.dtype, layer=True)
    xf = x.to(torch.float32)
    c = xf - _mean(_plan_sum(xf, plan), d)
    rinv = torch.reciprocal(torch.sqrt(_mean(_plan_sum(c * c, plan), d) + eps))
    y = (c * rinv) * w.to(torch.float32)
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
               eps: float) -> torch.Tensor:
    """LayerNorm of x [..., d] with weight w and optional bias b, each [d]
    or per head [H, d] over x [..., H, d]: the kernel for a CUDA tensor (or
    an error), the plain twin for a CPU one. y has x's shape and type, laid
    out contiguously."""
    if _on_cpu(x):
        return layer_norm_plain(x, w, b, eps)
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise ValueError(f"layer_norm takes fp32, bf16 or fp16 x and w, not {x.dtype}, {w.dtype}")
    if w.ndim not in (1, 2) or tuple(w.shape) != tuple(x.shape[x.ndim - w.ndim:]) \
            or w.device != x.device:
        raise ValueError(f"w must be [{d}] or [H, {d}] matching x's last dims "
                         f"{tuple(x.shape)} on {x.device}, got {tuple(w.shape)} on {w.device}")
    if b is not None and (b.shape != w.shape or b.dtype != w.dtype or b.device != w.device):
        raise ValueError(f"b must match w ({tuple(w.shape)}, {w.dtype}), got {tuple(b.shape)}, "
                         f"{b.dtype}")
    plan = norm_launch_plan(d, x.dtype, layer=True)
    if plan.steps * plan.vec > _LN_REG_FLOATS:
        raise ValueError(f"layer_norm's kernel holds rows of at most "
                         f"{_LN_REG_FLOATS * _LN_MAX_ROW_THREADS} values, not {d}")
    x2, out = _rows_of(x, "layer_norm")
    w = w.contiguous()
    b = None if b is None else b.contiguous()
    rows = x2.shape[0]
    if rows == 0:
        return out.reshape(x.shape)
    lib = _build.library("layer_norm")
    with torch.cuda.device(x.device):
        code = lib.hqq_layer_norm(
            _ptr(x2, 16), _ptr(w, w.element_size()),
            None if b is None else _ptr(b, b.element_size()), _ptr(out, 16), rows, d,
            w.numel() // d, eps, _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], plan.vec,
            plan.threads_log2, plan.rows_per_block, _stream(x.device))
    _build.check("layer_norm", code)
    layer_norm.launches += 1
    return out.reshape(x.shape)


layer_norm.launches = 0


class LayerNormFunction(torch.autograd.Function):
    """`layer_norm` with a gradient: the forward is the kernel (the twin on
    the CPU), the backward the plain formula in fp32: with xh = (x - mu) * r
    and g' = g * w, dx = r * (g' - mean(g') - xh * mean(g' * xh)), dw the
    sum over rows of g * xh and db that of g (per head for [H, d])."""

    @staticmethod
    def forward(ctx, x, w, b, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.has_bias = eps, b is not None
        return layer_norm(x, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xf, gf = x.to(torch.float32), g.to(torch.float32)
        mu = xf.mean(dim=-1, keepdim=True)
        rinv = torch.rsqrt(((xf - mu) ** 2).mean(dim=-1, keepdim=True) + ctx.eps)
        xh = (xf - mu) * rinv
        gw = gf * w.to(torch.float32)
        dx = rinv * (gw - gw.mean(dim=-1, keepdim=True)
                     - xh * (gw * xh).mean(dim=-1, keepdim=True))

        def rows_sum(v):
            return v.reshape((-1,) + tuple(w.shape)).sum(0).to(w.dtype)

        dw = rows_sum(gf * xh) if ctx.needs_input_grad[1] else None
        db = rows_sum(gf) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx.to(x.dtype), dw, db, None


def apply_layer_norm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                     eps: float) -> torch.Tensor:
    """LayerNorm as the models call it: `LayerNormFunction` where a gradient
    is wanted, else the wrapper itself."""
    grads = x.requires_grad or w.requires_grad or (b is not None and b.requires_grad)
    if torch.is_grad_enabled() and grads:
        return LayerNormFunction.apply(x, w, b, float(eps))
    return layer_norm(x, w, b, float(eps))
