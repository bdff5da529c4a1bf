"""Structured run logging (a copy of ``sessionsimilaritysearch_tpu/utils/logging.py``
but for ``RunDir``'s logger, which the port keys on its log file's path).

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
        # The logger is keyed on the absolute path of its log file, not on
        # id(self): loggers are global and Python gives a freed object's id
        # to a new one, so an id-keyed logger of a new RunDir could still hold
        # a freed RunDir's handler and write to the other directory's file.
        # A handler left on this logger that writes elsewhere (or to a file
        # since deleted) is closed and replaced.
        log_file = os.path.abspath(os.path.join(path, f"{name}.log"))
        self.logger = logging.getLogger(f"sss.{name}.{log_file}")
        self.logger.setLevel(logging.INFO)
        for h in list(self.logger.handlers):
            if getattr(h, "baseFilename", None) != log_file or not os.path.exists(log_file):
                self.logger.removeHandler(h)
                h.close()
        if not self.logger.handlers:
            h = logging.FileHandler(log_file)
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
