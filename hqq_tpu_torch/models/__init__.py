# SPDX-License-Identifier: Apache-2.0
from . import (  # noqa: F401
    aria,
    bloom,
    cohere,
    deepseek3,
    falcon,
    gemma,
    gemma2,
    gemma3,
    gpt2,
    gpt_oss,
    granite,
    llama,
    llava,
    mistral,
    mixtral,
    olmo2,
    phi,
    phi3,
    qwen2_vl,
    qwen3_moe,
    serialize,
    starcoder2,
    vit,
)
from .base import (  # noqa: F401
    from_quantized,
    get_linear_tags,
    iter_linears,
    name_to_linear_tag,
    patch_linears,
    quantize_model,
    save_quantized,
)
from .aria import AriaConfig, AriaTextConfig, IdeficsVisionConfig  # noqa: F401
from .bloom import BloomConfig  # noqa: F401
from .cohere import CohereConfig  # noqa: F401
from .deepseek3 import DeepseekV3Config  # noqa: F401
from .falcon import FalconConfig  # noqa: F401
from .gemma import GemmaConfig  # noqa: F401
from .gemma2 import Gemma2Config  # noqa: F401
from .gemma3 import Gemma3Config  # noqa: F401
from .gpt2 import GPT2Config  # noqa: F401
from .gpt_oss import GptOssConfig  # noqa: F401
from .granite import GraniteConfig  # noqa: F401
from .hf import load_hf_llama, params_from_hf_state_dict, read_hf_config  # noqa: F401
from .llama import KVCache, LlamaConfig, forward, init_cache, init_params  # noqa: F401
from .llava import ClipVisionConfig, LlavaConfig  # noqa: F401
from .mistral import MistralConfig  # noqa: F401
from .mixtral import MixtralConfig  # noqa: F401
from .olmo2 import Olmo2Config  # noqa: F401
from .phi import PhiConfig  # noqa: F401
from .phi3 import Phi3Config  # noqa: F401
from .qwen2_vl import Qwen2VLConfig  # noqa: F401
from .qwen3_moe import Qwen3MoeConfig  # noqa: F401
from .starcoder2 import Starcoder2Config  # noqa: F401
from .vit import ViTConfig  # noqa: F401
