"""Offline evaluation CLI: pairwise metrics between a source and a generated directory.

Counterpart of ``vocoder_tpu/cli/evaluate.py`` (the reference's eval.py:44-97):
mel-L1 ("spec_diff") with the 1024-fft / 256-hop / 128-mel analyzer at
``--sr``, PESQ-NB (8 kHz) and PESQ-WB (16 kHz) for vocal material, SI-SDR and
MCD, averaged over the pairs:

    python -m vocoder_tpu_torch.cli.evaluate SOURCE_DIR GENERATED_DIR --sr 44100 \\
        [--glob-pattern '*.flac'] [--workers N] [--device cuda|cpu]

The spectral metrics (spec_diff, MCD) run on ``--device``, ``cuda`` unless
``cpu`` is given, with TF32 off; it never falls back to the CPU by itself.
PESQ, SI-SDR, decoding and resampling run on the host.  ``--workers N > 1``
scores the pairs in N spawn-context processes, each entirely on the CPU, as
the JAX CLI's workers are: it needs ``--device cpu``.  A pair that fails
prints its error; the run exits when every pair fails.
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from vocoder_tpu_torch.data.audio_io import read_audio
from vocoder_tpu_torch.data.resample import resample
from vocoder_tpu_torch.eval_metrics import eval_log_mel, mcd, si_sdr
from vocoder_tpu_torch.eval_metrics import pesq as _pesq
from vocoder_tpu_torch.nn import set_full_precision


def spec_difference(source: np.ndarray, generated: np.ndarray, sr: int, device: str | torch.device = "cpu") -> float:
    """mel-L1 with the eval.py:55 analyzer (sr, 1024 fft, 1024 win, 256 hop, 128 mel)."""
    a = eval_log_mel(source, sr, device)
    b = eval_log_mel(generated, sr, device)
    return float(np.mean(np.abs(a - b)))


def pesq_score(target: np.ndarray, preds: np.ndarray, sr: int, mode: str) -> float:
    rate = 8000 if mode == "nb" else 16000
    return _pesq(resample(target, sr, rate), resample(preds, sr, rate), rate, mode)


def _eval_pair(f: Path, g: Path, sr: int, is_vocal: bool, device: str = "cpu") -> dict:
    """All metrics for one (source, generated) pair; raises on failure."""
    s_audio, s_sr = read_audio(f)
    g_audio, g_sr = read_audio(g)
    s = resample(s_audio.mean(0), s_sr, sr)
    p = resample(g_audio.mean(0), g_sr, sr)
    n = min(len(s), len(p))
    assert max(len(s) - n, len(p) - n) < 1000, "length mismatch > 1000 samples"
    s, p = s[:n], p[:n]

    out = {}
    if is_vocal:
        out["pesq_nb"] = pesq_score(s, p, sr, "nb")
        out["pesq_wb"] = pesq_score(s, p, sr, "wb")
    out["spec_diff"] = spec_difference(s, p, sr, device)
    out["si_sdr"] = si_sdr(s, p)
    out["mcd"] = mcd(s, p, sr, device=device)
    return out


def _worker_init():
    # Metric workers stay on the CPU, one thread each: N of them share the host's cores.
    torch.set_num_threads(1)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Offline vocoder evaluation")
    ap.add_argument("source")
    ap.add_argument("generated")
    ap.add_argument("--sr", type=int, default=24000)
    ap.add_argument("--glob-pattern", default="*.wav")
    ap.add_argument("--is-vocal", action="store_true", default=True)
    ap.add_argument("--is-instrumental", dest="is_vocal", action="store_false")
    ap.add_argument("--workers", type=int, default=1,
                    help="parallel metric processes on the CPU (PESQ is CPU-bound); N > 1 needs --device cpu")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu: where spec_diff and MCD run")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and args.workers > 1:
        raise SystemExit("--workers N > 1 scores every pair on the CPU; pass --device cpu with it")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    set_full_precision()
    source, generated = Path(args.source), Path(args.generated)
    assert source.is_dir() and generated.is_dir()
    files = sorted(source.rglob(args.glob_pattern))
    if not files:
        raise SystemExit(
            f"no files in {source} match {args.glob_pattern!r} — pass "
            "--glob-pattern (e.g. '*.flac') for non-WAV corpora"
        )
    pairs = []
    for f in files:
        g = generated / f.relative_to(source)
        for suffix in (".flac", ".wav"):
            if not g.exists():
                g = g.with_suffix(suffix)
        if not g.exists():
            print(f"{g} does not exist")
            continue
        pairs.append((f, g))

    scores = defaultdict(list)
    errors = 0

    def record(f, result):
        nonlocal errors
        if isinstance(result, Exception):
            # Per-file tolerance for corrupt clips, but loud, and a failure when every pair fails.
            errors += 1
            print(f"Error processing {f}: {type(result).__name__}: {result}")
            return
        for k, v in result.items():
            scores[k].append(v)

    if args.workers > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
            max_workers=args.workers, mp_context=mp.get_context("spawn"), initializer=_worker_init
        ) as pool:
            futures = [(f, pool.submit(_eval_pair, f, g, args.sr, args.is_vocal, "cpu")) for f, g in pairs]
            for f, fut in futures:
                try:
                    record(f, fut.result())
                except Exception as e:
                    record(f, e)
    else:
        for f, g in pairs:
            try:
                record(f, _eval_pair(f, g, args.sr, args.is_vocal, str(device)))
            except Exception as e:
                record(f, e)

    if not pairs:
        raise SystemExit(
            f"no generated file matches any of the {len(files)} source files — "
            "check the generated dir layout / extensions"
        )
    if errors:
        print(f"warning: {errors}/{len(pairs)} file pairs failed to evaluate")
    if errors == len(pairs):
        raise SystemExit("every file pair failed — the metric pipeline is broken, not the data")
    print("Average scores:")
    for k, v in scores.items():
        print(f"    {k}: {np.mean(v):.4f}")
    return {k: float(np.mean(v)) for k, v in scores.items()}


if __name__ == "__main__":
    main()
