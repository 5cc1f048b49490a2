# SPDX-License-Identifier: Apache-2.0
from .linear import Linear, QuantLinear  # noqa: F401
from .moe import GroupedLinear, GroupedQuantLinear, moe_dispatch, quantize_grouped  # noqa: F401
from .multilora import MultiLoRALinear, adapter_context, stack_adapters  # noqa: F401
