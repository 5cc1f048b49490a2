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
