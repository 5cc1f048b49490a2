# SPDX-License-Identifier: Apache-2.0
from . import bitpack  # noqa: F401
from .optimize import optimize_weights_proximal, shrink_lp  # noqa: F401
from .quantize import (  # noqa: F401
    SUPPORTED_BITS,
    BaseQuantizeConfig,
    QTensor,
    dequantize,
    quantize,
    resolve_meta,
    unpack_codes,
)
