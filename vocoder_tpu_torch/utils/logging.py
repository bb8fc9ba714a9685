"""Console logging, the ``metrics.jsonl`` stream, media and TensorBoard.

Counterpart of ``log`` and ``MetricsLogger`` in ``vocoder_tpu/utils/logging.py``:
timestamped lines on stderr, one JSON object a write in
``<workdir>/metrics.jsonl`` ({"step": ..., metric: value}), figures as PNGs
under ``<workdir>/media/``, and scalars, audio and figures in TensorBoard
(``<workdir>/tb``) when tensorboardX imports.  Under data parallelism only
rank 0 logs and writes (``parallel.dist.is_main``), as the JAX package's
process 0; on the other ranks ``log`` prints nothing and a ``MetricsLogger``
opens and writes nothing.  W&B is not ported (ROADMAP.md).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

from vocoder_tpu_torch.parallel import dist


def log(msg: str) -> None:
    if dist.is_main():
        print(f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


class MetricsLogger:
    def __init__(self, workdir: str | Path):
        self.main = dist.is_main()
        self.jsonl = self.tb = None
        if not self.main:
            return
        workdir = Path(workdir)
        workdir.mkdir(parents=True, exist_ok=True)
        self.workdir = workdir
        self.jsonl = open(workdir / "metrics.jsonl", "a")
        try:
            from tensorboardX import SummaryWriter

            self.tb = SummaryWriter(str(workdir / "tb"))
        except Exception:
            self.tb = None

    def write(self, step: int, metrics: dict) -> None:
        if not self.main:
            return
        scalars = {k: float(v) for k, v in metrics.items()}
        self.jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, v, step)

    def add_audio(self, step: int, tag: str, audio, sample_rate: int) -> None:
        """(T,) float audio to TensorBoard, when it is there."""
        if self.tb is not None:
            try:  # tensorboardX's audio encoding needs soundfile, which may be absent
                self.tb.add_audio(tag, audio.reshape(-1, 1), step, sample_rate=sample_rate)
            except Exception:
                pass

    def add_figure(self, step: int, tag: str, fig) -> None:
        """A matplotlib figure as ``media/<tag>_<step>.png`` (``/`` in the tag as ``_``) and to
        TensorBoard; closes the figure.  None (no matplotlib) logs nothing."""
        if fig is None:
            return
        try:
            if not self.main:
                return
            media = self.workdir / "media"
            media.mkdir(parents=True, exist_ok=True)
            fig.savefig(media / f"{tag.replace('/', '_')}_{step:08d}.png", dpi=110)
            if self.tb is not None:
                self.tb.add_figure(tag, fig, step)
        except Exception:
            pass
        finally:
            import matplotlib.pyplot as plt

            plt.close(fig)

    def close(self) -> None:
        if self.jsonl is not None:
            self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
