"""A tiny Vocos for CPU tests: the benchmark's ``configs/vocos-huge-44k.json`` at toy widths, and a benchmark
directory whose ``vocos-huge-44k`` configuration is that one (``tiny.tiny_config`` knows the upsampling
generators' keys only)."""

from __future__ import annotations

import json
from pathlib import Path

from portbench.tests import tiny

CELL = "vocos-huge-44k.synth-b16"
TINY_GEN = {"backbone": {"input_channels": 16, "depths": [1, 1, 3, 1], "dims": [8, 16, 24, 32]},
            "head": {"dim": 32, "n_fft": 64, "hop_length": 16, "win_length": 64}}


def config_file() -> dict:
    return json.loads((tiny.SRC / "configs" / "vocos-huge-44k.json").read_text())


def tiny_config() -> dict:
    """The configuration file with the tiny generator (dims (8, 16, 24, 32), depths (1, 1, 3, 1), n_fft 64,
    hop 16, 16 mels) and ``tiny.TINY_AUDIO``."""
    cfg = config_file()
    cfg["generator"] = {part: {**cfg["generator"][part], **TINY_GEN[part]} for part in ("backbone", "head")}
    cfg["audio"] = dict(tiny.TINY_AUDIO)
    return cfg


def make_root(dst: Path) -> Path:
    root = tiny.make_root(dst)
    (root / "configs" / "vocos-huge-44k.json").write_text(json.dumps(tiny_config()))
    return root
