"""Input-pipeline throughput: host decode, crop and batch, and with ``--prefetch`` the copy to the card.

Counterpart of ``vocoder_tpu/cli/bench_input.py``:

    python -m vocoder_tpu_torch.cli.bench_input --workers 1,4,8 --batch 16 [--format wav|flac|mp3|ogg]
    python -m vocoder_tpu_torch.cli.bench_input --corpus flacs/ --workers 1,4 --prefetch --step-ms 1580

Without ``--corpus`` it writes a synthetic corpus (24 tones with noise of 4 s at ``--sr``,
through the port's own writers: ``write_wav``, ``flac.write_flac``, ``mp3.write_mp3``, ``ogg.write_ogg``)
to a temporary directory.  For each worker count it runs ``data/dataset.py::batch_iterator`` (the
trainer's sampler: a file drawn per item, decoded, cropped to ``--num-frames`` hops) for ``--batches``
batches after one warm-up batch and prints one JSON line: batches/s and the audio seconds a second it
delivers (``metric: input_pipeline_batches_per_s``, the JAX package's keys), to compare against
``cli.bench_train``'s audio-s/s.  Host only.

``--prefetch`` times the same pipeline through ``DevicePrefetcher`` onto ``--device`` (cuda unless cpu
is asked for), as the trainer takes it: the consumer holds each batch for ``--step-ms`` (a stand-in for
the training step, on the host) before asking for the next, and the line adds the time it then waited
for a batch (``wait_s_per_batch``, the trainer's ``perf/input_wait_s`` a step) and the host seconds a
batch takes to make in the pool alone (``host_s_per_batch``, from the run without the prefetcher).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np


def make_corpus(root: Path, n_files: int, seconds: float, sr: int, fmt: str = "wav") -> None:
    """``n_files`` tones with noise of ``seconds`` at ``sr`` in ``fmt``, numpy seed 0."""
    from vocoder_tpu_torch.data import flac, mp3, ogg
    from vocoder_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(0)
    for i in range(n_files):
        t = np.arange(int(sr * seconds)) / sr
        wave = (0.4 * np.sin(2 * np.pi * (120 + 17 * i) * t) + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
        path = root / f"clip{i:03d}.{fmt}"
        if fmt == "flac":
            flac.write_flac(path, wave, sr)
        elif fmt == "mp3":
            mp3.write_mp3(path, wave, sr)
        elif fmt == "ogg":
            ogg.write_ogg(path, wave, sr)
        else:
            write_wav(path, wave, sr)


def main(argv=None):
    ap = argparse.ArgumentParser(description="host input-pipeline throughput (PyTorch port)")
    ap.add_argument("--corpus", default=None, help="audio dir; synthetic clips if omitted")
    ap.add_argument("--workers", default="1,2,4,8")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--num-frames", type=int, default=128)
    ap.add_argument("--hop", type=int, default=512)
    ap.add_argument("--sr", type=int, default=44100)
    ap.add_argument("--batches", type=int, default=30)
    ap.add_argument("--format", default="wav", choices=("wav", "flac", "mp3", "ogg"),
                    help="synthetic-corpus codec (flac: the host library's decoder; mp3/ogg: the system libraries)")
    ap.add_argument("--prefetch", action="store_true", help="also time the pipeline through DevicePrefetcher")
    ap.add_argument("--device", default="cuda", help="the prefetcher's device: cuda (default) or cpu")
    ap.add_argument("--step-ms", type=float, default=0.0, help="with --prefetch: how long the consumer holds a batch")
    args = ap.parse_args(argv)

    from vocoder_tpu_torch.data import transforms as T
    from vocoder_tpu_torch.data.dataset import MixDataset, VocoderDataset, batch_iterator

    tmp = None
    corpus = args.corpus
    if corpus is None:
        tmp = tempfile.TemporaryDirectory()
        corpus = Path(tmp.name)
        make_corpus(corpus, n_files=24, seconds=4.0, sr=args.sr, fmt=args.format)

    ds = VocoderDataset(root=corpus, transform=T.train_transform(args.sr, args.hop, args.num_frames))
    sample_fn = MixDataset(datasets=[ds], probs=[1.0]).sample
    target_len = args.hop * args.num_frames
    audio_s_per_batch = args.batch * target_len / args.sr

    results = []
    try:
        for workers in [int(w) for w in args.workers.split(",")]:
            it = batch_iterator(sample_fn, batch_size=args.batch, target_length=target_len, num_workers=workers)
            next(it)  # warm: the pool's threads, the file cache
            t0 = time.perf_counter()
            for _ in range(args.batches):
                next(it)
            dt = time.perf_counter() - t0
            it.close()
            rec = {"metric": "input_pipeline_batches_per_s", "format": args.format if args.corpus is None else "corpus",
                   "num_workers": workers, "batch_size": args.batch,
                   "value": args.batches / dt, "audio_s_per_s": args.batches * audio_s_per_batch / dt,
                   "unit": "batches/s"}
            if args.prefetch:
                rec.update(prefetch(batch_iterator(sample_fn, batch_size=args.batch, target_length=target_len,
                                                   num_workers=workers), args))
                rec["host_s_per_batch"] = dt / args.batches
            results.append(rec)
            print(json.dumps(rec), flush=True)
    finally:
        if tmp is not None:
            tmp.cleanup()
    return results


def prefetch(host_it, args) -> dict:
    """The batches through ``DevicePrefetcher`` onto ``args.device``, the consumer holding each for
    ``args.step_ms``: batches/s and the wait a batch (after one warm-up batch and its step)."""
    import torch

    from vocoder_tpu_torch.data.dataset import DevicePrefetcher

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--prefetch: no CUDA device is available; pass --device cpu")
    pf = DevicePrefetcher(host_it, device, depth=2)

    def step(batch) -> None:
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()  # the copy has landed before the "step"
        time.sleep(args.step_ms / 1e3)

    try:
        step(next(pf))  # warm: the first batch and step, as the trainer's first step is taken apart
        pf.wait_seconds(reset=True)
        t0 = time.perf_counter()
        for _ in range(args.batches):
            batch = next(pf)
            step(batch)
        dt = time.perf_counter() - t0
        wait = pf.wait_seconds(reset=True)
    finally:
        pf.close()
    return {"prefetch": True, "device": str(device), "step_ms": args.step_ms,
            "prefetch_batches_per_s": args.batches / dt, "wait_s_per_batch": wait / args.batches,
            "batch_on_device": str(batch["audio"].device)}


if __name__ == "__main__":
    main()
