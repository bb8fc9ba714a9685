"""Datasets and the batch iterator: audio files -> fixed-shape host batches, numpy.

A copy of ``vocoder_tpu/data/dataset.py`` (the reference's datasets/vocoder.py,
mix.py and datamodules/naive.py): file lists from a directory walk or a
filelist, per-item transforms with peak normalisation, a weighted infinite
mix, and ``batch_iterator``'s fixed-shape {audio (B, 1, T), lengths (B,)}
batches, with the f0 template (B, 1, T) of each element's final audio when
a ``template_fn`` is given.  Each batch element draws from its own rng
keyed (seed, host, step, slot), so for the same files and seed the stream
is the JAX package's, and it resumes at any step.  The JAX package's ``DevicePrefetcher`` is not
ported: the trainer copies each batch to the card itself and times the wait
(``perf/input_wait_s``).  A corpus with a file whose suffix is not in
``audio_io.DECODABLE_EXTENSIONS`` (WAV, FLAC, Ogg, and MP3 where libmpg123
loads) fails at construction, as the JAX package's does.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, Sequence

import numpy as np

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
