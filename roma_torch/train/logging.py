"""Training telemetry: a JSONL metrics log. Losses return metric dicts;
this logger is their one sink, written every `every` steps (counted in
samples), by the first process only when torch.distributed runs."""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

import torch


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "train", every: int = 50):
        dist = torch.distributed
        self.enabled = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
        self.every = every
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._file = None
        if self.enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Mapping[str, object], force: bool = False) -> None:
        if not self.enabled or (step % self.every and not force):
            return
        row = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self._file.write(json.dumps(row) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
