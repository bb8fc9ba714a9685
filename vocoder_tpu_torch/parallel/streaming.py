"""Long-utterance inference: overlap-chunked synthesis.

Counterpart of ``vocoder_tpu/parallel/streaming.py``.  The generator is
fully convolutional with a finite receptive field, so chunking the mel with
an overlap of at least that field and trimming the halo gives the full-pass
waveform in the interior, with device memory bounded by the chunk size.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


def chunked_synthesis(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    mel: torch.Tensor,
    *,
    hop_length: int,
    chunk_frames: int = 512,
    overlap_frames: int = 32,
) -> torch.Tensor:
    """mel (1, C, T) -> audio (1, 1, T*hop); all chunks go through apply_fn as one batch."""
    b, _, t = mel.shape
    if b != 1:
        raise ValueError("chunked_synthesis is per-utterance; batch full clips instead")
    if t <= chunk_frames:
        return apply_fn(mel)

    core = chunk_frames - 2 * overlap_frames
    if core <= 0:
        raise ValueError(f"chunk_frames {chunk_frames} must exceed 2 * overlap_frames {overlap_frames}")
    n_chunks = math.ceil(t / core)
    right = n_chunks * core + overlap_frames - t
    mel_p = F.pad(mel, (overlap_frames, right), mode="replicate")
    chunks = torch.cat([mel_p[:, :, i * core : i * core + chunk_frames] for i in range(n_chunks)])

    audio_chunks = apply_fn(chunks)  # (n_chunks, 1, chunk_frames*hop)
    lo = overlap_frames * hop_length
    hi = lo + core * hop_length
    core_audio = audio_chunks[:, 0, lo:hi].reshape(1, 1, -1)
    return core_audio[:, :, : t * hop_length]
