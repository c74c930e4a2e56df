"""Line-JSON event log; port of `JsonLogger` from the JAX package's
`utils/profiling.py` (its jax.profiler spans have no counterpart here)."""
from __future__ import annotations

import json
import sys
import time
from typing import Optional


class JsonLogger:
    """One JSON object per event: {"event", "time", **fields}, appended to
    `path` (stdout without one) and flushed per line."""

    def __init__(self, path: Optional[str] = None):
        self.f = open(path, "a") if path else sys.stdout

    def log(self, event: str, **fields):
        rec = {"event": event, "time": time.time(), **fields}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()

    def close(self):
        if self.f is not sys.stdout:
            self.f.close()
