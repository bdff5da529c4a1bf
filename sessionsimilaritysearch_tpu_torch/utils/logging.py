"""Structured run logging.

The reference logs free-text lines to a per-experiment file and snapshots
its config by copying ``config.py`` + the training script into the savedir
(pretrain_filtered_amazon.py:193-199). Here a run directory gets a JSON
config snapshot and an append-only JSONL metric stream (loss curves,
recall@k, QPS), plus a human-readable log file.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional


class RunDir:
    """Per-experiment directory with config snapshot + log wiring."""

    def __init__(self, path: str, config=None, name: str = "run"):
        self.path = path
        os.makedirs(path, exist_ok=True)
        if config is not None and hasattr(config, "to_json"):
            with open(os.path.join(path, "config.json"), "w") as f:
                f.write(config.to_json())
        self.logger = logging.getLogger(f"sss.{name}.{id(self)}")
        self.logger.setLevel(logging.INFO)
        if not self.logger.handlers:
            h = logging.FileHandler(os.path.join(path, f"{name}.log"))
            h.setFormatter(
                logging.Formatter("%(asctime)s:%(levelname)s:%(message)s")
            )
            self.logger.addHandler(h)

    def file(self, name: str) -> str:
        return os.path.join(self.path, name)


class MetricLogger:
    """Append-only JSONL metric stream with step/time stamping."""

    def __init__(self, path: str, echo: Optional[logging.Logger] = None):
        self.path = path
        self.echo = echo
        self._f = open(path, "a")
        self._t0 = time.time()

    def log(self, step: int, **metrics: Any) -> None:
        row = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self.echo is not None:
            self.echo.info(
                " ".join(f"{k}={v}" for k, v in row.items())
            )

    def close(self) -> None:
        self._f.close()


def read_metrics(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
