# SPDX-License-Identifier: Apache-2.0
"""RMSNorm as one fixed-order fp32 kernel.

``y = (x * rsqrt(mean(x^2) + eps)) * (w + offset)`` over the last dim of x,
every step in fp32 and y rounded to x's type: ``offset`` 0 for Llama-style
norms (`hqq_tpu.models.llama.rms_norm`), 1 for Gemma's ``(1 + w)``
(`hqq_tpu.models.gemma._gemma_norm`).

`rms_norm` launches ``csrc/rms_norm.cu`` for CUDA tensors (one launch a
call, counted in ``rms_norm.launches``) and runs its plain twin,
`rms_norm_plain`, for CPU tensors. Both sum a row's squares in one order
that `norm_launch_plan` derives from the width and the element size alone:
``threads`` threads a row (a power of two, at least a warp), thread t summing
the vectors t, t + threads, ... of ``vec`` elements one element at a time,
then the threads' sums combined by halving. So a row's output is bit-equal
whether it is normed alone or among 1024 rows, which a PyTorch reduction
does not promise (its order depends on how many rows one call reduces).
The twin repeats the kernel's every rounding: it is bit-equal to it, not
merely close.

`apply_rms_norm` is what the models call: the wrapper, or under autograd
the `RMSNormFunction`, whose backward is the plain formula in PyTorch
(`hqq_tpu` differentiates XLA's norm; there is no Pallas kernel to port).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import _build
from .fused_matmul import _on_cpu, _ptr, _stream

__all__ = ["NormPlan", "norm_launch_plan", "rms_norm", "rms_norm_plain", "RMSNormFunction",
           "apply_rms_norm"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# threads a block holds at least where a row takes fewer (several rows a block)
_BLOCK_THREADS = 256
_MAX_ROW_THREADS = 1024


@dataclasses.dataclass(frozen=True)
class NormPlan:
    """How `rms_norm` sums a row of ``d`` elements: ``threads`` threads a
    row, each summing ``steps`` vectors of ``vec`` elements (the vectors
    t, t + threads, ...; the last step may be short), ``rows_per_block``
    rows a block of ``rows_per_block * threads`` threads."""

    vec: int
    threads: int
    steps: int
    rows_per_block: int

    @property
    def threads_log2(self) -> int:
        return self.threads.bit_length() - 1


@functools.lru_cache(maxsize=256)
def norm_launch_plan(d: int, dtype: torch.dtype) -> NormPlan:
    """The summation order and launch of a norm over rows of ``d`` elements
    of ``dtype``, by these two alone. A thread loads 16 bytes at a time
    (``vec`` = 16 / element size) where d is a multiple of that, else one
    element. A row takes the largest power of two of threads that gives
    each about two vectors, at least 32 (a warp) and at most 1024; rows of
    fewer than 256 threads share a block."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"rms_norm takes fp32, bf16 or fp16 rows, not {dtype}")
    if d < 1:
        raise ValueError(f"rms_norm needs rows of at least one element, got d={d}")
    v16 = 16 // torch.empty((), dtype=dtype).element_size()
    vec = v16 if d % v16 == 0 else 1
    nvec = d // vec
    threads = 1 << max(0, (max(1, nvec // 2)).bit_length() - 1)
    threads = min(_MAX_ROW_THREADS, max(32, threads))
    return NormPlan(vec=vec, threads=threads, steps=-(-nvec // threads),
                    rows_per_block=max(1, _BLOCK_THREADS // threads))


def rms_norm_plain(x: torch.Tensor, w: torch.Tensor, eps: float,
                   offset: float = 0.0) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, to the bit: the squares summed
    in the plan's order by explicit elementwise adds (padding with zeros,
    which add nothing), the halving tree, then ms / d, 1 / sqrt(ms + eps)
    and (x * r) * (w + offset), each one correctly rounded fp32 operation.
    The route for CPU tensors, and the kernel's reference on the card."""
    d = x.shape[-1]
    plan = norm_launch_plan(d, x.dtype)
    xf = x.to(torch.float32)
    sq = xf * xf
    pad = plan.steps * plan.threads * plan.vec - d
    if pad:
        sq = F.pad(sq, (0, pad))
    sq = sq.reshape(*x.shape[:-1], plan.steps, plan.threads, plan.vec)
    acc = torch.zeros(sq.shape[:-3] + (plan.threads,), dtype=torch.float32, device=x.device)
    for k in range(plan.steps):
        for j in range(plan.vec):
            acc = acc + sq[..., k, :, j]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    # a true division: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal instead, which parts from __fdiv_rn in the last bit
    ms = acc / torch.full((), d, dtype=torch.float32, device=acc.device)
    rinv = torch.reciprocal(torch.sqrt(ms + eps))
    return ((xf * rinv) * (w.to(torch.float32) + offset)).to(x.dtype)


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
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.contiguous() if not x2.is_contiguous() else x2.clone()
    w = w.contiguous()
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    if rows == 0:
        return out.reshape(x.shape)
    if rows >= 2**31:
        raise ValueError(f"rms_norm takes fewer than 2^31 rows, got {rows}")
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
