"""Structured per-iteration metrics with a JSONL sink.

Port of record: ``sqlp_tpu/utils/metrics.py``. Every record is a stats
dict's scalars (non-finite values and non-scalars dropped) plus
``wall_s``, the seconds since the logger was made, appended to a JSONL
file. A tensor is read to the host only when its record is logged.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Dict, Optional

import numpy as np
import torch


def _to_scalar(v):
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    a = np.asarray(v)
    if a.ndim == 0:
        x = a.item()
        if isinstance(x, (np.bool_, bool)):
            return bool(x)
        if isinstance(x, float) and not np.isfinite(x):
            return None
        return x
    return None                       # non-scalars are dropped


class MetricsLogger:
    """Append-only JSONL metrics sink with wall-clock stamping (no file
    for ``path=None``: ``log`` then only returns the record)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh: Optional[IO] = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, stats: Dict, **extra) -> Dict:
        rec = {k: _to_scalar(v) for k, v in stats.items()}
        rec = {k: v for k, v in rec.items() if v is not None}
        rec.update(extra)
        rec["wall_s"] = round(time.time() - self._t0, 3)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
