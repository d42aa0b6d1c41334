"""Smoothed metric logging, the port of ``sipmask_tpu/utils/logging.py``
(the benchmark fork's MetricLogger) with the same JSON lines, which the
reference's analyze_logs tooling reads. Under a process group only rank 0
prints and writes the log (each rank's metrics are the global batch's)."""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Optional

from ..parallel import process_shard_args


class SmoothedValue:
    def __init__(self, window: int = 20):
        self.deque = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(value)
        self.total += value
        self.count += 1

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, log_file: Optional[str] = None, delimiter: str = "  "):
        self.meters = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.quiet = process_shard_args()[0] != 0
        self.log_file = None if self.quiet else log_file
        self._t0 = time.time()
        if log_file:
            os.makedirs(os.path.dirname(os.path.abspath(log_file)),
                        exist_ok=True)

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def log(self, step: int, total_steps: Optional[int] = None,
            lr: Optional[float] = None, prefix: str = ""):
        if self.quiet:
            return
        parts = [f"{prefix}step {step}"]
        if total_steps:
            rate = (time.time() - self._t0) / max(step, 1)
            eta = rate * (total_steps - step)
            parts.append(f"eta {eta / 60:.1f}m")
        if lr is not None:
            parts.append(f"lr {lr:.5f}")
        parts += [f"{k} {m.median:.4f}" for k, m in self.meters.items()]
        line = self.delimiter.join(parts)
        print(line, flush=True)
        if self.log_file:
            rec = dict(step=step, lr=lr,
                       **{k: m.median for k, m in self.meters.items()})
            with open(self.log_file, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def log_record(self, **record):
        """Append an arbitrary record (e.g. eval stats) to the log json."""
        if self.log_file:
            with open(self.log_file, "a") as f:
                f.write(json.dumps(record) + "\n")
