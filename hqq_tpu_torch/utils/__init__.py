# SPDX-License-Identifier: Apache-2.0
from .convert import paged_cache_from_numpy, params_from_numpy  # noqa: F401
from .patching import (  # noqa: F401
    auto_mix_plan,
    fuse_for_decode,
    merge_zeros_into_lora,
    prepare_for_inference,
)
from .training import causal_lm_loss, make_lora_train_step  # noqa: F401
