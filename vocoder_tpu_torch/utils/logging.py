"""Console logging and the ``metrics.jsonl`` stream.

Counterpart of ``log`` and ``MetricsLogger`` in ``vocoder_tpu/utils/logging.py``:
timestamped lines on stderr, and one JSON object a write in
``<workdir>/metrics.jsonl`` ({"step": ..., metric: value}).  One process, so
no rank filter.  TensorBoard, W&B and media logging are not yet ported
(ROADMAP.md).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def log(msg: str) -> None:
    print(f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


class MetricsLogger:
    def __init__(self, workdir: str | Path):
        workdir = Path(workdir)
        workdir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(workdir / "metrics.jsonl", "a")

    def write(self, step: int, metrics: dict) -> None:
        self.jsonl.write(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}) + "\n")
        self.jsonl.flush()

    def close(self) -> None:
        self.jsonl.close()
