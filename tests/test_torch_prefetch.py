"""The port's ``DevicePrefetcher`` and the trainer's use of it and of ``run.profile_steps``, on the CPU.

The prefetcher is held to the synchronous ``batch_iterator`` it wraps (the same batches, bit for bit,
from the same seed), to the JAX package's error and shutdown behaviour (an exception in its thread is
raised in the consumer; ``close`` leaves no thread behind), and the trainer to taking every batch from
it and logging its wait as ``perf/input_wait_s``.  The card's path (pinned memory, a side stream) is
checked in ``tests/test_torch_cuda.py``.
"""

import json
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_trainer import TINY, _wavs
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu_torch.cli import train as train_cli
from vocoder_tpu_torch.data.dataset import DevicePrefetcher, batch_iterator
from vocoder_tpu_torch.train import trainer


def _sample(rng: np.random.Generator) -> np.ndarray:
    """A clip of 30 to 200 samples of noise, as a dataset's sample_fn returns one."""
    return rng.standard_normal((1, int(rng.integers(30, 200)))).astype(np.float32)


def _iterator(**kw):
    return batch_iterator(_sample, batch_size=3, target_length=128, seed=7, **kw)


def _prefetch_threads() -> list:
    return [t for t in threading.enumerate() if t.name == "device-prefetch"]


@pytest.mark.parametrize("num_workers", [1, 3])
def test_prefetcher_yields_the_synchronous_batches(num_workers):
    want = _iterator(num_workers=num_workers)
    pf = DevicePrefetcher(_iterator(num_workers=num_workers), "cpu")
    try:
        for _ in range(5):
            got, ref = next(pf), next(want)
            assert set(got) == set(ref) == {"audio", "lengths"}
            for k in ref:
                assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
                assert got[k].dtype == torch.from_numpy(ref[k]).dtype
                assert np.array_equal(got[k].numpy(), ref[k]), k
        assert pf.wait_seconds() >= 0.0 and pf.wait_seconds(reset=True) >= pf.wait_seconds() == 0.0
    finally:
        pf.close()
        want.close()
    assert not _prefetch_threads()


def test_prefetcher_raises_the_thread_error_in_the_consumer_and_closes():
    def failing():
        yield {"audio": np.zeros((1, 1, 4), np.float32)}
        raise OSError("corrupt file in the corpus")

    pf = DevicePrefetcher(failing(), "cpu")
    assert next(pf)["audio"].shape == (1, 1, 4)
    with pytest.raises(OSError, match="corrupt file"):
        next(pf)
    pf.close()
    assert not pf._thread.is_alive() and not _prefetch_threads()


def test_prefetcher_close_stops_a_thread_blocked_on_a_full_queue():
    pf = DevicePrefetcher(_iterator(num_workers=1), "cpu", depth=1)
    next(pf)
    pf.close()  # the thread has filled the queue and waits on it
    assert not pf._thread.is_alive() and not _prefetch_threads()


def test_prefetcher_refuses_cuda_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher(iter([]), "cuda")


def test_trainer_takes_every_batch_from_the_prefetcher_and_profiles(tmp_path, monkeypatch, capsys):
    """cli.train on the CPU, 3 steps: each batch (the first included) through ``DevicePrefetcher``, whose
    waits are the logged ``perf/input_wait_s``; ``run.profile_steps=(1,3)`` writes a Chrome trace of steps
    1 and 2 under ``<workdir>/profile`` and names it in the log."""
    made, waits = [], []

    class Recording(DevicePrefetcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.taken = 0
            made.append(self)

        def __next__(self):
            self.taken += 1
            return super().__next__()

        def wait_seconds(self, reset=False):
            w = super().wait_seconds(reset)
            if reset:
                waits.append(w)
            return w

    monkeypatch.setattr(trainer, "DevicePrefetcher", Recording)
    rng = np.random.default_rng(0)
    _wavs(tmp_path / "train", 3, rng)
    work = tmp_path / "run"
    state = train_cli.main(["--model", "hifigan", "--device", "cpu", f"data.train_roots=('{tmp_path / 'train'}',)",
                            f"run.workdir={work}", *TINY, "run.max_steps=3", "run.profile_steps=(1,3)"])
    assert state.step == 3
    assert len(made) == 1 and made[0].taken == 3 and not made[0]._thread.is_alive()
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    assert [r["perf/input_wait_s"] for r in records] == waits and len(waits) == 2
    trace = work / "profile" / "trace_1_3.json"
    assert trace.is_file() and json.loads(trace.read_text())["traceEvents"]
    assert f"profiler trace written to {trace}" in capsys.readouterr().err


def test_profile_steps_are_checked():
    with pytest.raises(ValueError, match="run.profile_steps"):
        trainer.ProfileWindow((3, 3), None, torch.device("cpu"))
