# SPDX-License-Identifier: Apache-2.0
from .convert import paged_cache_from_numpy, params_from_numpy  # noqa: F401
from .patching import fuse_for_decode, prepare_for_inference  # noqa: F401
from .training import causal_lm_loss, make_lora_train_step  # noqa: F401
