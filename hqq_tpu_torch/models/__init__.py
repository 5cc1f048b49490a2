# SPDX-License-Identifier: Apache-2.0
from . import llama  # noqa: F401
from .base import (  # noqa: F401
    get_linear_tags,
    iter_linears,
    name_to_linear_tag,
    patch_linears,
    quantize_model,
)
from .llama import KVCache, LlamaConfig, forward, init_cache, init_params  # noqa: F401
