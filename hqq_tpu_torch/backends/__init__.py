# SPDX-License-Identifier: Apache-2.0
from .pallas_backend import (  # noqa: F401
    A8QuantLinear,
    PallasQuantLinear,
    patch_quantlinear_to_pallas,
    patch_quantlinear_to_w4a8,
)
