# SPDX-License-Identifier: Apache-2.0
from .linear import Linear, QuantLinear  # noqa: F401
