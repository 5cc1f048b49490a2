# SPDX-License-Identifier: Apache-2.0
"""Fused dequant-matmul kernels for Hopper: their host side.

Mirrors `hqq_tpu.ops.fused_matmul` for axis=1 weights: the kernel layout
(`KernelQTensor`, `to_kernel_layout`), the per-row int8 activation
quantization, and the entry points `quant_matmul_pallas`,
`quant_matmul_pallas_a8` and `dequant_pallas`, whose names and routing are
kept so that a reader finds each counterpart.

The kernel layout is this card's own (see ``csrc/hqq_common.cuh``): the codes
of W [N, K] stay contiguous along K, 32/cb codes to a 32-bit word, and scale
and zs = zero*scale are fp32 [N, K/g]. None of the TPU layout's padding or
nibble orders carry over.

Three kernels, each behind a wrapper with a plain PyTorch twin and a launch
count (``<wrapper>.launches``):

    w4a8_matmul  -> csrc/w4a8_matmul.cu   (M <= 32, int8 activations)
    quant_matmul -> csrc/quant_matmul.cu  (any M, bf16/fp16 operands)
    dequant      -> csrc/dequant.cu

A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.quantize import QTensor, resolve_meta, unpack_codes
from . import _build

__all__ = [
    "KernelQTensor",
    "supports_kernel_layout",
    "to_kernel_layout",
    "quantize_activations_int8",
    "quant_matmul_pallas",
    "quant_matmul_pallas_a8",
    "dequant_pallas",
    "w4a8_matmul",
    "quant_matmul",
    "dequant",
    "w4a8_matmul_plain",
    "quant_matmul_plain",
    "dequant_plain",
    "reset_launch_counts",
]

# nbits (canonical) -> container bits of the kernel layout: 3-bit rides the
# 4-bit container, 1.58-bit the 2-bit one, 6/5-bit the 8-bit one
_KERNEL_CONTAINER_BITS = {8: 8, 6: 8, 5: 8, 4: 4, 3: 4, 2: 2, 1.58: 2, 1: 1}

# largest M that `quant_matmul_pallas_a8` sends to the int8 kernel
A8_MAX_M = 32

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@dataclasses.dataclass
class KernelQTensor:
    """Inference-prepared quantized weight in the kernel layout.

      wq:    uint8 [N, K*cb/8]  codes of W [N, K], 32/cb to a 32-bit word
      scale: fp32 [N, K/g]      dequant scale (multiplicative)
      zs:    fp32 [N, K/g]      zero * scale (W = c*scale - zs)
    """

    wq: torch.Tensor
    scale: torch.Tensor
    zs: torch.Tensor
    nbits: float = 4
    container_bits: int = 4
    group_size: int = 64
    shape: tuple = ()  # (K, N)
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def k(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def r(self) -> int:
        return 8 // self.container_bits


def supports_kernel_layout(qt: QTensor) -> bool:
    """Whether ``qt`` converts to the kernel layout: axis=1 groups that
    divide K, and (this layout's own rule) a group of whole 32-bit words."""
    if qt.axis != 1 or not qt.channel_wise or qt.group_size is None:
        return False
    g = qt.group_size
    k = qt.shape[1]
    cb = _KERNEL_CONTAINER_BITS[qt.nbits]
    return k % g == 0 and g % 8 == 0 and g % (32 // cb) == 0


def _pack_words(codes: torch.Tensor, cb: int) -> torch.Tensor:
    """Codes [N, K] -> uint8 [N, K*cb/8] in the word layout of
    ``csrc/hqq_common.cuh``: code k = 4r*w + 4f + b at bit 8b + cb*f of
    word w (r = 8/cb)."""
    n, k = codes.shape
    r = 8 // cb
    c = codes.to(torch.int32).reshape(n, k // (4 * r), r, 4)
    shifts = (torch.arange(r, device=codes.device, dtype=torch.int32) * cb).view(1, 1, r, 1)
    return (c << shifts).sum(dim=2).to(torch.uint8).reshape(n, k * cb // 8)


def _unpack_words(wq: torch.Tensor, cb: int) -> torch.Tensor:
    """Inverse of `_pack_words`: uint8 [N, K*cb/8] -> int32 codes [N, K]."""
    n, nbytes = wq.shape
    r = 8 // cb
    b = wq.to(torch.int32).reshape(n, nbytes // 4, 1, 4)
    shifts = (torch.arange(r, device=wq.device, dtype=torch.int32) * cb).view(1, 1, r, 1)
    return ((b >> shifts) & ((1 << cb) - 1)).reshape(n, nbytes * r)


def to_kernel_layout(qt: QTensor) -> KernelQTensor:
    """Convert a canonical axis=1 `QTensor` to the kernel layout, on its
    device (a one-time repack at `prepare_for_inference`)."""
    if not supports_kernel_layout(qt):
        raise ValueError(
            "kernel layout needs axis=1 groups dividing K, made of whole "
            f"32-bit words; got axis={qt.axis}, group_size={qt.group_size}, "
            f"nbits={qt.nbits}, shape={qt.shape}"
        )
    qt = resolve_meta(qt)
    n_out, k = qt.shape
    g = qt.group_size
    cb = _KERNEL_CONTAINER_BITS[qt.nbits]
    codes = unpack_codes(qt, torch.int32).reshape(n_out, k)
    scale = qt.scale.reshape(n_out, k // g).to(torch.float32)
    zero = qt.zero.reshape(n_out, k // g).to(torch.float32)
    return KernelQTensor(
        wq=_pack_words(codes, cb),
        scale=scale.contiguous(),
        zs=(zero * scale).contiguous(),
        nbits=qt.nbits,
        container_bits=cb,
        group_size=g,
        shape=(k, n_out),
        compute_dtype=qt.compute_dtype,
    )


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def _on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA one (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for tensors on {t.device}")
    return False


def _check_kqt(kqt: KernelQTensor, device: torch.device) -> None:
    k, n = kqt.shape
    g = kqt.group_size
    if kqt.wq.dtype != torch.uint8 or tuple(kqt.wq.shape) != (n, k * kqt.container_bits // 8):
        raise ValueError(f"wq must be uint8 [{n}, {k * kqt.container_bits // 8}]")
    for name in ("scale", "zs"):
        t = getattr(kqt, name)
        if t.dtype != torch.float32 or tuple(t.shape) != (n, k // g):
            raise ValueError(f"{name} must be fp32 [{n}, {k // g}]")
    for t in (kqt.wq, kqt.scale, kqt.zs):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"kernel operands must be contiguous on {device}")


def _ptr(t: torch.Tensor, align: int = 16) -> int:
    p = t.data_ptr()
    if p % align:
        raise ValueError(f"kernel operand not {align}-byte aligned")
    return p


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dequant_plain(kqt: KernelQTensor, dtype=torch.float32) -> torch.Tensor:
    """Plain version of the dequant kernel: W [N, K] = c*scale - zs in fp32,
    then cast to ``dtype``."""
    k, n = kqt.shape
    g = kqt.group_size
    c = _unpack_words(kqt.wq, kqt.container_bits).to(torch.float32).view(n, k // g, g)
    w = c * kqt.scale[:, :, None] - kqt.zs[:, :, None]
    return w.reshape(n, k).to(dtype)


def dequant(kqt: KernelQTensor, dtype=torch.float32) -> torch.Tensor:
    """W [N, K] in ``dtype`` (fp32, bf16 or fp16) from the kernel layout."""
    if _on_cpu(kqt.wq):
        return dequant_plain(kqt, dtype)
    dev = kqt.wq.device
    _check_kqt(kqt, dev)
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"dequant kernel writes fp32, bf16 or fp16, not {dtype}")
    k, n = kqt.shape
    out = torch.empty((n, k), dtype=dtype, device=dev)
    lib = _build.library("dequant")
    with torch.cuda.device(dev):
        code = lib.hqq_dequant(
            _ptr(kqt.wq, 4), _ptr(kqt.scale, 4), _ptr(kqt.zs, 4), _ptr(out, 4), n, k,
            kqt.group_size, kqt.container_bits, _DTYPE_CODE[dtype], _stream(dev),
        )
    _build.check("dequant", code)
    dequant.launches += 1
    return out


def quant_matmul_plain(x2: torch.Tensor, kqt: KernelQTensor) -> torch.Tensor:
    """Plain version of the quant_matmul kernel: x2 [M, K] @ W^T with W
    dequantized in fp32 and rounded to x2's dtype, summed in fp32."""
    w = dequant_plain(kqt, x2.dtype)
    return (x2.to(torch.float32) @ w.to(torch.float32).t()).to(x2.dtype)


def quant_matmul(x2: torch.Tensor, kqt: KernelQTensor) -> torch.Tensor:
    """x2 [M, K] @ W^T -> [M, N] in x2's dtype (bf16 or fp16 on the card)."""
    if _on_cpu(x2):
        return quant_matmul_plain(x2, kqt)
    dev = x2.device
    _check_kqt(kqt, dev)
    if x2.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"quant_matmul kernel takes bf16 or fp16 activations, not {x2.dtype}")
    m, k = x2.shape
    if k != kqt.k:
        raise ValueError(f"x has K={k}, weight has K={kqt.k}")
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    out = torch.empty((m, kqt.n), dtype=x2.dtype, device=dev)
    lib = _build.library("quant_matmul")
    with torch.cuda.device(dev):
        code = lib.hqq_quant_matmul(
            _ptr(x2), _ptr(kqt.wq, 4), _ptr(kqt.scale, 4), _ptr(kqt.zs, 4), _ptr(out, 2),
            m, kqt.n, k, kqt.group_size, kqt.container_bits, _DTYPE_CODE[x2.dtype],
            _stream(dev),
        )
    _build.check("quant_matmul", code)
    quant_matmul.launches += 1
    return out


def w4a8_matmul_plain(
    x8: torch.Tensor, sx: torch.Tensor, kqt: KernelQTensor, out_dtype=torch.float32
) -> torch.Tensor:
    """Plain version of the w4a8 kernel:
    y = sx * sum_g(s_g * dot_g(x8, c) - xsum_g * zs_g), with every group
    dot exact (integers below 2^24 are exact in fp32)."""
    k, n = kqt.shape
    g = kqt.group_size
    m = x8.shape[0]
    c = _unpack_words(kqt.wq, kqt.container_bits).to(torch.float32).view(n, k // g, g)
    xg = x8.to(torch.float32).view(m, k // g, g)
    dots = torch.einsum("mgk,ngk->mng", xg, c)
    xsum = xg.sum(dim=-1)  # [M, K/g]
    out = (dots * kqt.scale[None] - xsum[:, None, :] * kqt.zs[None]).sum(dim=-1)
    return (out * sx).to(out_dtype)


def w4a8_matmul(
    x8: torch.Tensor, sx: torch.Tensor, kqt: KernelQTensor, out_dtype=torch.float32
) -> torch.Tensor:
    """int8 activations x8 [M, K] (M <= 32) with row scales sx [M, 1]
    against a 1/2/4-bit (or 5/6-bit in the 8-bit container) weight ->
    [M, N] in ``out_dtype``."""
    if _on_cpu(x8):
        return w4a8_matmul_plain(x8, sx, kqt, out_dtype)
    dev = x8.device
    _check_kqt(kqt, dev)
    m, k = x8.shape
    if x8.dtype != torch.int8 or k != kqt.k or not 1 <= m <= A8_MAX_M:
        raise ValueError(f"w4a8 kernel takes int8 [M<= {A8_MAX_M}, {kqt.k}], got {x8.dtype} {tuple(x8.shape)}")
    if kqt.nbits == 8:
        raise ValueError("8-bit codes do not fit int8 operands")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"w4a8 kernel writes fp32, bf16 or fp16, not {out_dtype}")
    x8 = x8.contiguous()
    if x8.data_ptr() % 4:
        x8 = x8.clone()
    sx = sx.to(torch.float32).contiguous()
    if sx.numel() != m or sx.device != dev:
        raise ValueError("sx must hold one fp32 scale per row, on the device of x8")
    out = torch.empty((m, kqt.n), dtype=out_dtype, device=dev)
    lib = _build.library("w4a8_matmul")
    with torch.cuda.device(dev):
        code = lib.hqq_w4a8_matmul(
            _ptr(x8, 4), _ptr(sx, 4), _ptr(kqt.wq, 16), _ptr(kqt.scale, 4), _ptr(kqt.zs, 4),
            _ptr(out, 2), m, kqt.n, k, kqt.group_size, kqt.container_bits,
            _DTYPE_CODE[out_dtype], _stream(dev),
        )
    _build.check("w4a8_matmul", code)
    w4a8_matmul.launches += 1
    return out


for _wrapper in (dequant, quant_matmul, w4a8_matmul):
    _wrapper.launches = 0


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for w in (dequant, quant_matmul, w4a8_matmul):
        w.launches = 0


# ---------------------------------------------------------------------------
# Entry points (the names of `hqq_tpu.ops.fused_matmul`)
# ---------------------------------------------------------------------------


def quantize_activations_int8(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 activation quantization: x ~ x8 * sx, with
    sx = max(amax/127, 1e-8) and x8 = round(x/sx) (half to even) in fp32."""
    xf = x2.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp_min(amax / 127.0, 1e-8)
    x8 = torch.round(xf / sx).to(torch.int8)
    return x8, sx


def quant_matmul_pallas(x: torch.Tensor, kqt: KernelQTensor) -> torch.Tensor:
    """``x @ W_dq^T`` for a kernel-layout weight: x [..., K] -> [..., N] in
    x's dtype, fp32 accumulation (the `quant_matmul` kernel)."""
    lead = x.shape[:-1]
    out = quant_matmul(x.reshape(-1, kqt.k), kqt)
    return out.reshape(*lead, kqt.n)


def quant_matmul_pallas_a8(x: torch.Tensor, kqt: KernelQTensor) -> torch.Tensor:
    """``x @ W_dq^T`` with int8 activations at decode sizes.

    The routing of `hqq_tpu`'s `quant_matmul_pallas_a8`: 8-bit weights and
    M > 32 rows (M = the product of the leading dims, so a prefill of
    B*t_pad > 32) take the bf16-operand `quant_matmul` kernel with
    full-precision activations; M <= 32 quantizes the activations per row
    to int8 and takes the `w4a8_matmul` kernel. The weight side is exact;
    the output is in x's dtype."""
    if kqt.nbits == 8:
        return quant_matmul_pallas(x, kqt)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kqt.k)
    if x2.shape[0] > A8_MAX_M:
        return quant_matmul_pallas(x, kqt)
    x8, sx = quantize_activations_int8(x2)
    out = w4a8_matmul(x8, sx, kqt, x.dtype)
    return out.reshape(*lead, kqt.n)


def dequant_pallas(kqt: KernelQTensor, dtype=torch.float32) -> torch.Tensor:
    """W^T [K, N] in ``dtype`` (the `dequant` kernel writes W [N, K]; this
    returns its transposed view, the reference's orientation)."""
    return dequant(kqt, dtype).t()
