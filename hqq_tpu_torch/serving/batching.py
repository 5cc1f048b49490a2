# SPDX-License-Identifier: Apache-2.0
"""What the serving engines share: a request and its sampling parameters.

Mirrors the head of `hqq_tpu.serving.batching`. The dense-cache
`ContinuousBatchingEngine` of that module is not ported yet; the paged
engine (`serving.paged`) is.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["Request"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # [T] int32
    max_new_tokens: int
    output: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    adapter_id: int = 0  # multi-LoRA: which adapter serves this request
    # per-request sampling parameters (None = the engine's default)
    do_sample: Optional[bool] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    temperature: Optional[float] = None
    # stop token ids beyond the engine's eos (checked on the host)
    stop_token_ids: Optional[List[int]] = None


def _effective_sampling(req: Request, do_sample, top_k, temperature, top_p):
    """The request's parameters with the engine's defaults filled in."""
    return (
        do_sample if req.do_sample is None else bool(req.do_sample),
        top_k if req.top_k is None else int(req.top_k),
        temperature if req.temperature is None else float(req.temperature),
        top_p if req.top_p is None else float(req.top_p),
    )
