"""The one traffic generator: reads a mix's parameters (``traffic/<mix>.json``) and makes its inputs.

Utterance lengths (``lengths``): the ``items`` quantiles (i + 1/2) / items of
a log-normal with the stated mean and sigma, clipped to [min_s, max_s] and
rounded to mel frames.  Every seed gets that same set of lengths; the seed
draws their order and the mels' contents, so the work of a run does not move
with its seed and every shape that a run uses is known before it starts.
Mels are log-mel-like: normal draws of ``mel.std`` about ``mel.mean``.

- ``offline_jobs``: the jobs of an offline synthesis (each one utterance of
  every length, in the seed's order), their mels on the device.
- ``requests``: the same utterances as host arrays for a closed loop, and the
  order in which one client sends them: each cycle every utterance once, in
  blocks that each hold one utterance of every length stratum, spread so that
  every prefix holds nearly the same mix of lengths.
- ``train_batches``: batches of speech-like audio (harmonic tones on a random
  f0 with a slow envelope, plus noise) on the device, and the crop starts of
  the steps.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import numpy as np
import torch

from portbench import weights


def load(root: Path, mix: str) -> dict:
    return json.loads((root / "traffic" / f"{mix}.json").read_text())


def utterance_seconds(lengths: dict) -> np.ndarray:
    """The mix's utterance lengths in seconds, ascending."""
    n = lengths["items"]
    sigma = lengths["sigma"]
    mu = np.log(lengths["mean_s"]) - sigma**2 / 2
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.exp(mu + sigma * z), lengths["min_s"], lengths["max_s"])


def utterance_frames(lengths: dict, audio: dict) -> np.ndarray:
    fps = audio["sampling_rate"] / audio["hop_length"]
    return np.maximum(1, np.round(utterance_seconds(lengths) * fps)).astype(np.int64)


def _mels(frames: np.ndarray, mel: dict, num_mels: int, gen: torch.Generator, device) -> list[torch.Tensor]:
    """One (num_mels, F) log-mel-like tensor per entry of ``frames``, from one draw."""
    flat = torch.randn(int(frames.sum()) * num_mels, generator=gen, device=device) * mel["std"] + mel["mean"]
    return [c.view(num_mels, int(f)) for c, f in zip(torch.split(flat, [int(f) * num_mels for f in frames]), frames)]


def offline_jobs(spec: dict, cfg: dict, seed: int, device) -> list[list[torch.Tensor]]:
    """``spec["pool"]`` jobs, each the list of its utterances' mels (num_mels, F) on ``device``."""
    frames = utterance_frames(spec["lengths"], cfg["audio"])
    jobs = []
    for j in range(spec["pool"]):
        order = weights.rng(seed, f"job-order-{j}").permutation(len(frames))
        jobs.append(_mels(frames[order], spec["mel"], cfg["audio"]["num_mels"],
                          weights.generator(seed, f"job-mels-{j}", device), device))
    return jobs


def requests(spec: dict, cfg: dict, seed: int, device) -> tuple[list[np.ndarray], "RequestOrder"]:
    """(the utterances' mels as host fp32 arrays (num_mels, F), the order of requests)."""
    frames = utterance_frames(spec["lengths"], cfg["audio"])
    mels = _mels(frames, spec["mel"], cfg["audio"]["num_mels"], weights.generator(seed, "request-mels", device),
                 device)
    flat = torch.cat([m.reshape(-1) for m in mels]).cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(frames * cfg["audio"]["num_mels"])])
    host = [flat[a:b].reshape(cfg["audio"]["num_mels"], -1) for a, b in zip(offsets[:-1], offsets[1:])]
    return host, RequestOrder(frames, seed, spec["block"])


def spread_order(m: int) -> np.ndarray:
    """0..m-1 in van der Corput order (0, m/2, m/4, 3m/4, ... for m a power of two): every prefix of it is
    spread evenly over the range."""
    def radical_inverse(j: int) -> float:
        x, f = 0.0, 0.5
        while j:
            x, j, f = x + f * (j & 1), j >> 1, f / 2
        return x

    return np.argsort(np.argsort([radical_inverse(j) for j in range(m)], kind="stable"), kind="stable")


class RequestOrder:
    """Request i's utterance.  Cycle c = i // n sends each of the n utterances once, in blocks of ``block``
    requests: the utterances, taken in order of length, form ``block`` strata of n / block, and block j of
    every cycle takes from each stratum its utterance of rank ``spread_order[j]``, so that any run of whole
    blocks holds nearly the same mix of lengths and a window's tail does not move with the seed.  The seed
    draws the order of the requests inside each block (and the mels' contents)."""

    def __init__(self, lengths, seed: int, block: int):
        self.n, self.seed, self.block = len(lengths), seed, block
        if self.n % block:
            raise ValueError(f"{self.n} utterances do not split into blocks of {block}")
        strata = np.argsort(np.asarray(lengths), kind="stable").reshape(block, -1)  # row s: stratum s
        self.blocks = strata[:, spread_order(strata.shape[1])].T  # (blocks, block): block j's utterances
        self._cycles: dict[int, np.ndarray] = {}

    def cycle(self, c: int) -> np.ndarray:
        if c not in self._cycles:
            rng = weights.rng(self.seed, f"request-order-{c}")
            self._cycles[c] = np.concatenate([rng.permutation(row) for row in self.blocks])
        return self._cycles[c]

    def __getitem__(self, i: int) -> int:
        return int(self.cycle(i // self.n)[i % self.n])


def train_batches(spec: dict, cfg: dict, seed: int, device) -> list[dict]:
    """``spec["pool"]`` batches {"audio": (B, 1, T), "lengths": (B,)} of speech-like audio on ``device``,
    every row different."""
    audio_cfg, src = cfg["audio"], spec["audio"]
    b, t = spec["batch"], spec["frames"] * audio_cfg["hop_length"]
    n = spec["pool"] * b
    gen = weights.generator(seed, "train-audio", device)
    f0 = src["f0_min"] + (src["f0_max"] - src["f0_min"]) * torch.rand(n, 1, 1, generator=gen, device=device)
    h = torch.arange(1, src["harmonics"] + 1, device=device, dtype=torch.float32)[None, :, None]
    phase = 2 * torch.pi * torch.rand(n, src["harmonics"], 1, generator=gen, device=device)
    time = torch.arange(t, device=device, dtype=torch.float32)[None, None, :] / audio_cfg["sampling_rate"]
    tones = torch.sum(torch.sin(2 * torch.pi * f0 * h * time + phase) / h, dim=1)
    env_f = 0.5 + 3.0 * torch.rand(n, 1, generator=gen, device=device)
    env = 0.5 + 0.5 * torch.sin(2 * torch.pi * env_f * time[0] + 2 * torch.pi * torch.rand(n, 1, generator=gen,
                                                                                               device=device))
    noise = torch.randn(n, t, generator=gen, device=device)
    audio = (src["amplitude"] * env * tones / 2 + src["noise"] * noise).view(spec["pool"], b, 1, t)
    lengths = torch.full((b,), t, dtype=torch.int64, device=device)
    return [{"audio": audio[i].contiguous(), "lengths": lengths} for i in range(spec["pool"])]


def crop_starts(spec: dict, cfg: dict, seed: int, steps: int) -> list[int]:
    """The discriminators' crop start of each of ``steps`` steps."""
    t = spec["frames"] * cfg["audio"]["hop_length"]
    return [int(s) for s in weights.rng(seed, "crop-starts").integers(0, t - cfg["train"]["crop_length"], steps)]
