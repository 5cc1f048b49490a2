# SPDX-License-Identifier: Apache-2.0
from .fused_matmul import (  # noqa: F401
    KernelQTensor,
    dequant_pallas,
    quant_matmul_pallas,
    quant_matmul_pallas_a8,
    quantize_activations_int8,
    supports_kernel_layout,
    to_kernel_layout,
)


def kernel_wrappers() -> tuple:
    """Every kernel wrapper of the package, each with its ``launches``
    count: the nine of `fused_matmul` (the grouped expert kernel among
    them), `paged.paged_attention`, the six of `attention`
    (the flash forward, its fp32 route, the dK/dV and the dQ kernels and
    their fp32 routes), `norm.rms_norm` and `norm.layer_norm`."""
    from .attention import (flash_attention, flash_attention_backward_dkv,
                            flash_attention_backward_dkv_fp32, flash_attention_backward_dq,
                            flash_attention_backward_dq_fp32, flash_attention_fp32)
    from .fused_matmul import _WRAPPERS
    from .norm import layer_norm, rms_norm
    from .paged import paged_attention

    return (*_WRAPPERS, paged_attention, flash_attention,
            flash_attention_fp32, flash_attention_backward_dkv, flash_attention_backward_dq,
            flash_attention_backward_dkv_fp32, flash_attention_backward_dq_fp32, rms_norm,
            layer_norm)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0, and the w4a8 routes'
    (`fused_matmul.W4A8_ROUTE_LAUNCHES`)."""
    from .fused_matmul import W4A8_ROUTE_LAUNCHES

    for w in kernel_wrappers():
        w.launches = 0
    for route in W4A8_ROUTE_LAUNCHES:
        W4A8_ROUTE_LAUNCHES[route] = 0
