"""Structured per-epoch metrics (SURVEY.md §5 observability): the port's
copy of ``ycnr_tpu/train/metrics.py``, whose package imports JAX.

The reference logs per-epoch RMSE and wall-clock to the console; here each
epoch appends one JSON record {epoch, rmse_test, epoch_s, ...} to a JSONL
file — exactly the BASELINE metric set (rmse, epoch_s, recs_per_s).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 append: bool = False):
        self.path = path
        self.echo = echo
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            if not append:  # truncate: one file per fresh run
                with open(path, "w"):
                    pass

    def log(self, **record):
        record.setdefault("t", round(time.time() - self._t0, 3))
        line = json.dumps(record)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, file=sys.stderr, flush=True)

    def read(self):
        if not self.path or not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(x) for x in f if x.strip()]
