# SPDX-License-Identifier: Apache-2.0
from .generate import (  # noqa: F401
    Generator,
    next_power_of_2,
    sample_token,
    sample_token_batch,
)
from .batching import ContinuousBatchingEngine  # noqa: F401
from .paged import PagedBatchingEngine  # noqa: F401
from .speculative import (  # noqa: F401
    SpeculativeBatchingEngine,
    SpeculativeGenerator,
    SpeculativePagedEngine,
)
