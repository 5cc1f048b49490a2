# SPDX-License-Identifier: Apache-2.0
from . import gemma, gemma2, gemma3, granite, llama, mistral, olmo2, phi3, serialize  # noqa: F401
from .base import (  # noqa: F401
    from_quantized,
    get_linear_tags,
    iter_linears,
    name_to_linear_tag,
    patch_linears,
    quantize_model,
    save_quantized,
)
from .gemma import GemmaConfig  # noqa: F401
from .gemma2 import Gemma2Config  # noqa: F401
from .gemma3 import Gemma3Config  # noqa: F401
from .granite import GraniteConfig  # noqa: F401
from .hf import load_hf_llama, params_from_hf_state_dict, read_hf_config  # noqa: F401
from .llama import KVCache, LlamaConfig, forward, init_cache, init_params  # noqa: F401
from .mistral import MistralConfig  # noqa: F401
from .olmo2 import Olmo2Config  # noqa: F401
from .phi3 import Phi3Config  # noqa: F401
