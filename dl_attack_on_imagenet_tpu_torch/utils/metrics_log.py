"""Structured metric logging (JSONL).

Port of ``dl_attack_on_imagenet_tpu/utils/metrics_log.py``: an appendable
JSONL stream, with a no-op default so callers can log unconditionally.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricLogger:
    """Append {step, time, **metrics} records to a JSONL file."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, step: int, **metrics: Any) -> None:
        if not self.path:
            return
        record: Dict[str, Any] = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def read(self):
        if not self.path or not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
