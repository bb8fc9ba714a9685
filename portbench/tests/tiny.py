"""A tiny copy of the benchmark's data for CPU tests: the same files and names at toy widths and lengths."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

SRC = Path(__file__).resolve().parents[1]
TINY_GENERATOR = dict(hop_length=16, upsample_rates=[4, 2, 2], upsample_kernel_sizes=[8, 4, 4], num_mels=16,
                      upsample_initial_channel=64, resblock_kernel_sizes=[3, 5],
                      resblock_dilation_sizes=[[1, 3], [1, 3]])
TINY_AUDIO = {"sampling_rate": 8000, "n_fft": 64, "hop_length": 16, "win_length": 64, "num_mels": 16}


def tiny_config(name: str) -> dict:
    cfg = json.loads((SRC / "configs" / f"{name}.json").read_text())
    cfg["generator"].update(TINY_GENERATOR)
    cfg["audio"] = dict(TINY_AUDIO)
    train = cfg["train"]
    train["mpd"] = {"periods": [2, 3], "kernel_size": 5, "stride": 3, "channels": [1, 4, 8]}
    train["mrd_resolutions"] = [[64, 16, 64], [32, 8, 32]]
    train.update(crop_length=256, num_frames=32)
    return cfg


def tiny_traffic(mix: str) -> dict:
    spec = json.loads((SRC / "traffic" / f"{mix}.json").read_text())
    if spec["kind"] == "train_steps":
        spec.update(batch=4, frames=32, pool=2)
    else:
        spec["lengths"].update(items=12, mean_s=0.1, min_s=0.02, max_s=0.3)
        spec["check"]["items"] = 3
        if spec["kind"] == "offline_batches":
            spec.update(batch=4, pool=2)
        else:
            spec["block"] = 4
    spec["trace_seconds"] = 0.5
    return spec


def make_root(dst: Path) -> Path:
    """A benchmark directory at ``dst``: tiny configs and mixes, the real counts, metrics and limits, and a
    ``BENCHMARK.json`` with the real entries."""
    for sub in ("configs", "traffic", "flops", "metrics", "limits"):
        (dst / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("flops", "metrics", "limits"):
        for f in (SRC / sub).iterdir():
            if f.is_file():
                shutil.copy(f, dst / sub / f.name)
    for f in (SRC / "configs").glob("*.json"):
        (dst / "configs" / f.name).write_text(json.dumps(tiny_config(f.stem)))
    for f in (SRC / "traffic").glob("*.json"):
        (dst / "traffic" / f.name).write_text(json.dumps(tiny_traffic(f.stem)))
    shutil.copy(SRC.parent / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst
