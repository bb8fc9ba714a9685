"""The port's training-side bench CLIs on the CPU, on the tiny task of ``tests/test_torch_trainer.py``:
``cli.bench_train`` prints the JAX package's ``gan_train_step`` keys (and times the trainer's own
phases), ``cli.bench_input`` its ``input_pipeline_batches_per_s`` keys, with ``--prefetch`` through
``DevicePrefetcher``."""

import json

import pytest

from tests.test_torch_trainer import TINY
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu_torch.cli import bench_input, bench_train

TRAIN_KEYS = {"metric", "model", "backend", "batch", "compute_dtype", "total_ms", "g_ms", "audio_s_per_s"}
INPUT_KEYS = {"metric", "format", "num_workers", "batch_size", "value", "audio_s_per_s", "unit"}
TASK = [o for o in TINY if o.startswith("task.")]


def _lines(capsys) -> list[dict]:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("dtype,flags", [("bfloat16", ["--gen-checkpointing"]), ("float32", ["--g-only"])])
def test_bench_train_prints_jax_keys(capsys, dtype, flags):
    rec = bench_train.main(["--model", "bigvgan", "--batch", "2", "--iters", "2", "--device", "cpu",
                            "--compute-dtype", dtype, *flags, *TASK])
    (line,) = _lines(capsys)
    assert line == rec and TRAIN_KEYS <= set(line)
    assert line["metric"] == "gan_train_step" and line["backend"] == "cpu" and line["compute_dtype"] == dtype
    assert line["gen_checkpointing"] == ("--gen-checkpointing" in flags) and line["g_only"] == ("--g-only" in flags)
    assert line["total_ms"] > 0 and line["g_ms"] > 0 and line["audio_s_per_s"] > 0


def test_bench_train_refuses_checkpointing_without_the_flag():
    with pytest.raises(SystemExit, match="no checkpointing flag"):
        bench_train.main(["--model", "vocos", "--device", "cpu", "--gen-checkpointing", "--iters", "1"])


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_bench_input_prints_jax_keys(capsys, fmt):
    recs = bench_input.main(["--workers", "1,2", "--batch", "4", "--batches", "3", "--num-frames", "16", "--hop", "16",
                             "--sr", "8000", "--format", fmt, "--prefetch", "--device", "cpu",
                             "--step-ms", "2"])
    lines = _lines(capsys)
    assert lines == recs and [r["num_workers"] for r in lines] == [1, 2]
    for r in lines:
        assert INPUT_KEYS <= set(r) and r["metric"] == "input_pipeline_batches_per_s" and r["format"] == fmt
        assert r["value"] > 0 and r["prefetch"] and r["batch_on_device"] == "cpu" and r["wait_s_per_batch"] >= 0
