# SPDX-License-Identifier: Apache-2.0
from .hf import HQQModel, register_arch  # noqa: F401
