# SPDX-License-Identifier: Apache-2.0
from . import llama, serialize  # noqa: F401
from .base import (  # noqa: F401
    from_quantized,
    get_linear_tags,
    iter_linears,
    name_to_linear_tag,
    patch_linears,
    quantize_model,
    save_quantized,
)
from .hf import load_hf_llama, params_from_hf_state_dict, read_hf_config  # noqa: F401
from .llama import KVCache, LlamaConfig, forward, init_cache, init_params  # noqa: F401
