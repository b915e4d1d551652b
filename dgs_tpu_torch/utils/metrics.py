"""Structured per-step metrics logging (JSONL).

The port's own copy of ``dgs_tpu/utils/metrics.py`` (the port imports
nothing of the JAX package): one JSON object a line, each with ``t``, the
seconds since the logger was made, unless the record sets it.
``models.pigs.train(logger=...)`` logs one record per chunk of steps.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional


class JsonlLogger:
    """Appends records to ``path`` (opened here and closed by ``close``) or
    writes them to ``stream`` (left open); with neither, drops them."""

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None):
        self._fh = open(path, "a") if path else stream
        self._owns = path is not None
        self._t0 = time.time()

    def log(self, record: dict) -> None:
        record = dict(record)
        record.setdefault("t", round(time.time() - self._t0, 3))
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._owns and self._fh is not None:
            self._fh.close()
