# SPDX-License-Identifier: Apache-2.0
from .hf import AutoHQQHFModel, HQQModel, HQQModelForCausalLM, register_arch  # noqa: F401
from .vision import AutoHQQVisionModel, HQQtimm, HQQVisionModel  # noqa: F401
from .vl import AutoHQQVLModel, HQQVLModel  # noqa: F401
