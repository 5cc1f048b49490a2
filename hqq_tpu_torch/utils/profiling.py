# SPDX-License-Identifier: Apache-2.0
"""The event log of `hqq_tpu.utils.profiling`: an append-only JSONL record
of what the serving engines do (requests admitted and finished). Off unless
the environment names it: ``HQQ_TPU_LOG=path`` writes to a file,
``HQQ_TPU_LOG=1`` prints. The timing helpers of that module are not ported.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Optional

__all__ = ["EventLog", "default_log", "log_event"]


@dataclass
class EventLog:
    """Append-only JSONL event log. ``path=None`` prints only."""

    path: Optional[str] = None
    echo: bool = False

    def emit(self, event: str, **fields) -> None:
        rec = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(rec, default=str)
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo or not self.path:
            print(f"[hqq_tpu_torch] {line}", flush=True)


_env = os.environ.get("HQQ_TPU_LOG")
default_log = EventLog(path=None if _env in (None, "", "1") else _env) if _env else None


def log_event(event: str, **fields) -> None:
    if default_log is not None:
        default_log.emit(event, **fields)
