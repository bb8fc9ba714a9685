"""Datasets and the batch iterator: audio files -> fixed-shape host batches, numpy.

A copy of ``vocoder_tpu/data/dataset.py`` (the reference's datasets/vocoder.py,
mix.py and datamodules/naive.py): file lists from a directory walk or a
filelist, per-item transforms with peak normalisation, a weighted infinite
mix, and ``batch_iterator``'s fixed-shape {audio (B, 1, T), lengths (B,)}
batches, with the f0 template (B, 1, T) of each element's final audio when
a ``template_fn`` is given.  Each batch element draws from its own rng
keyed (seed, host, step, slot), so for the same files and seed the stream
is the JAX package's, and it resumes at any step.  ``DevicePrefetcher``, the
JAX package's counterpart, moves host batches onto the device in a background
thread, two ahead of the consumer, and counts the time the consumer waits for
one (the trainer's ``perf/input_wait_s``).  A corpus with a file whose suffix is not in
``audio_io.DECODABLE_EXTENSIONS`` (WAV, FLAC, Ogg, and MP3 where libmpg123
loads) fails at construction, as the JAX package's does.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from vocoder_tpu_torch.data.audio_io import DECODABLE_EXTENSIONS, list_audio_files


@dataclass
class VocoderDataset:
    """Map-style dataset over audio paths: a directory (walked) or a filelist."""

    root: str | Path
    transform: Callable  # (rng, path) -> (C, T) float32

    def __post_init__(self):
        root = Path(self.root)
        if not root.exists():
            raise FileNotFoundError(f"Path {root} does not exist.")
        if root.is_dir():
            self.paths = [str(p) for p in list_audio_files(root)]
        else:
            self.paths = [line for line in root.read_text().splitlines() if line.strip()]
        bad = sorted({Path(p).suffix.lower() for p in self.paths} - DECODABLE_EXTENSIONS)
        if bad:
            examples = [p for p in self.paths if Path(p).suffix.lower() in bad][:5]
            raise ValueError(
                f"{root}: {bad} files are not decodable (supported: {sorted(DECODABLE_EXTENSIONS)}); "
                f"e.g. {examples}. Convert the corpus or filter the filelist."
            )

    def __len__(self) -> int:
        return len(self.paths)

    def get(self, rng: np.random.Generator, idx: int) -> np.ndarray:
        audio = self.transform(rng, self.paths[idx])
        peak = float(np.max(np.abs(audio))) if audio.size else 0.0
        if peak >= 1.0:
            audio = audio / (peak / 0.99)
        return audio


@dataclass
class MixDataset:
    """Weighted infinite mix of datasets."""

    datasets: Sequence[VocoderDataset]
    probs: Sequence[float]

    def __post_init__(self):
        total = float(sum(self.probs))
        self.probs = [p / total for p in self.probs]

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        ds = self.datasets[int(rng.choice(len(self.datasets), p=self.probs))]
        return ds.get(rng, int(rng.integers(0, len(ds))))


def _fix_length(audio: np.ndarray, target: int) -> tuple[np.ndarray, int]:
    t = audio.shape[-1]
    if t >= target:
        return audio[..., :target], target
    return np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(0, target - t)]), t


def batch_iterator(
    sample_fn: Callable[[np.random.Generator], np.ndarray],
    *,
    batch_size: int,
    target_length: int,
    seed: int = 594461,
    host_index: int = 0,
    start_step: int = 0,
    num_workers: int = 1,
    template_fn: Callable[[np.ndarray], np.ndarray] | None = None,
) -> Iterator[dict]:
    """Infinite {audio (B, 1, T) float32, lengths (B,) int64[, template (B, 1, T) float32]} batches of
    fixed shape.

    Element ``slot`` of batch ``step`` draws from ``np.random.default_rng((seed, host_index,
    step, slot))``, so the stream is the same for any ``num_workers``; a thread pool (decode
    and resample release the interpreter lock in numpy) only changes the wall clock.
    ``template_fn`` (audio (T,) -> template (T,)) runs on each element's final (cropped, fixed-length)
    audio, so that the f0 is that of what the generator must reconstruct.  It runs in this thread, one
    element after another, once the pool has made the batch: ``data/f0.py``'s loop releases and takes
    back the interpreter lock at each of its small numpy calls, and in a pool of threads that hand-off,
    not the work, sets the pace (several times slower than one thread)."""

    def element(step: int, slot: int) -> tuple[np.ndarray, int]:
        a = sample_fn(np.random.default_rng((seed, host_index, step, slot)))
        if a.ndim == 1:
            a = a[None, :]
        return _fix_length(a[:1], target_length)

    pool = ThreadPoolExecutor(max_workers=num_workers, thread_name_prefix="data-worker") if num_workers > 1 else None
    try:
        step = start_step
        while True:
            if pool is None:
                items = [element(step, i) for i in range(batch_size)]
            else:
                items = list(pool.map(lambda i: element(step, i), range(batch_size)))
            batch = {"audio": np.stack([a for a, _ in items]).astype(np.float32),
                     "lengths": np.asarray([n for _, n in items], np.int64)}
            if template_fn is not None:
                batch["template"] = np.stack([template_fn(a[0]) for a, _ in items])[:, None, :].astype(np.float32)
            yield batch
            step += 1
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)


class DevicePrefetcher:
    """Host batches (dicts of numpy arrays) -> dicts of tensors on ``device``, made ``depth`` ahead of the
    consumer by a background thread, as the JAX package's ``DevicePrefetcher`` puts them on its devices.

    On a CUDA device the thread copies each array into pinned host memory and from there to the card on a
    side stream, and records an event after the copies; ``__next__`` makes the consumer's current stream
    wait on that event and ties each tensor to that stream (``record_stream``), so the copies overlap the
    step and no tensor's memory is reused while the step may still read it.  With ``device="cpu``"
    (asked for by the caller) it is the same thread and queue, without pinning or streams; a CUDA device
    without CUDA raises.  ``wait_seconds`` is the time the consumer blocked on the queue.  An exception
    raised in the thread (a decode error, the iterator's own) is raised in the consumer, and ``close``
    stops and joins the thread, then closes the iterator."""

    def __init__(self, iterator: Iterator[dict], device, depth: int = 2):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DevicePrefetcher: no CUDA device is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"DevicePrefetcher: no path to device {self.device}")
        self._iterator = iterator
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._wait_seconds = 0.0
        self._thread = threading.Thread(target=self._worker, daemon=True, name="device-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless the prefetcher is closing (then False)."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _transfer(self, batch: dict):
        """(tensors on the device, the event after their copies or None)."""
        if self._stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}, None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _worker(self) -> None:
        try:
            for batch in self._iterator:
                if self._stop.is_set() or not self._put(self._transfer(batch)):
                    return
        except BaseException as e:  # surfaced to the consumer by __next__
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        t0 = time.perf_counter()
        item = self._queue.get()
        self._wait_seconds += time.perf_counter() - t0
        if isinstance(item, BaseException):
            raise item
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for v in batch.values():
                v.record_stream(stream)
        return batch

    def wait_seconds(self, reset: bool = False) -> float:
        """Seconds the consumer blocked on the queue since the last reset: the input pipeline's starvation
        of the step."""
        w = self._wait_seconds
        if reset:
            self._wait_seconds = 0.0
        return w

    def close(self) -> None:
        """Stop the thread (after the batch it is making), join it and close the iterator."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        close = getattr(self._iterator, "close", None)
        if close is not None:
            close()
