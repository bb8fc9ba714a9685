"""The ssl family's HuBERT front end: the frozen backbone as a feature extractor, and the trainable post-net.

Counterpart of ``vocoder_tpu/models/ssl_encoders.py`` (``HubertEncoderConfig``,
``HubertFeatureExtractor``, ``hubert_postnet_init`` / ``hubert_postnet_apply``).

``HubertFeatureExtractor(cfg, device)`` holds the port's own HuBERT
(``models/hubert.py``), frozen, in eval mode, on ``device``.  When
``cfg.model_name_or_path`` is a local directory it loads that snapshot
(``hubert.load_snapshot``: ``config.json`` and ``model.safetensors`` or
``pytorch_model.bin``); otherwise, as the JAX package does when
``from_pretrained`` fails, it logs one line and builds a random-weight backbone
of ``HubertConfig(hidden_size=cfg.hidden_size)``.  The port downloads nothing.
Its random weights come from seed ``RANDOM_SEED`` always (``hubert.random_state_dict``),
so a training run, its resume and the codec over its checkpoints all see one
backbone; the JAX package draws its random backbone from torch's global RNG, a
new one in each process.  A call maps audio (B, T) to the last hidden state
(B, T', hidden) under ``torch.no_grad``, always in fp32 with TF32 off
(``nn.full_fp32``, for the call only), whatever ``run.precision`` or
``task.compute_dtype`` say: the JAX package's backbone runs on the host in fp32
and sees neither.  Like the JAX extractor it takes the audio as given, at the
task's own rate, with no resample (only the ``16000_640_2048`` resolution feeds
HuBERT the 16 kHz it was trained at).

``HubertPostNet`` is the trainable post-net (the reference's ``hubert.py``):
Conv1d(hidden, out, k3, p1) -> SiLU -> Conv1d(out, out, k3, s2, p1) -> SiLU ->
Conv1d(out, out, k1), plain convs named ``post0`` / ``post1`` / ``post2`` as the
JAX tree's, from features (B, T', hidden) to the latent (B, out, (T' + 1) // 2)
channels-first (the JAX package's ``ssl_encode`` transposes to it).

The JAX package's ``MMSFeatureExtractor`` is not ported: its random-weight
fallback, ``Wav2Vec2Config(hidden_size=1024)``, cannot be built (1024 is not a
multiple of the default 12 heads), so no config of the JAX package can use it
without a local ``facebook/mms-300m`` snapshot, which the repository does not hold.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from vocoder_tpu_torch.models import hubert
from vocoder_tpu_torch.nn import full_fp32
from vocoder_tpu_torch.utils.logging import log

RANDOM_SEED = 0  # the random-weight backbone's seed


@dataclasses.dataclass(frozen=True)
class HubertEncoderConfig:
    model_name_or_path: str = "facebook/hubert-base-ls960"
    freeze_backbone: bool = True  # the backbone is always frozen, as in the JAX package
    output_size: int = 512
    hidden_size: int = 768  # the backbone's width: the post-net's input channels


class HubertFeatureExtractor:
    """Frozen HuBERT features on ``device``: audio (B, T) -> (B, T', hidden), fp32."""

    def __init__(self, cfg: HubertEncoderConfig, device: str | torch.device = "cuda"):
        path = Path(cfg.model_name_or_path)
        if path.is_dir():
            model = hubert.load_snapshot(path)
        else:
            log(f"hubert: {cfg.model_name_or_path!r} is not a local snapshot directory (the port downloads "
                f"nothing) — building a random-weight backbone from seed {RANDOM_SEED}")
            hcfg = hubert.HubertConfig(hidden_size=cfg.hidden_size)
            model = hubert.from_state_dict(hcfg, hubert.random_state_dict(hcfg, RANDOM_SEED))
        if model.cfg.hidden_size != cfg.hidden_size:
            raise ValueError(f"{cfg.model_name_or_path}: the backbone is {model.cfg.hidden_size} wide, the "
                             f"config's hidden_size (the post-net's input) {cfg.hidden_size}")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), full_fp32():
            return self.model(audio.to(self.device, torch.float32))


class HubertPostNet(nn.Module):
    """features (B, T', hidden) -> latent (B, output_size, (T' + 1) // 2)."""

    def __init__(self, cfg: HubertEncoderConfig, device=None):
        super().__init__()
        self.post0 = nn.Conv1d(cfg.hidden_size, cfg.output_size, 3, padding=1, device=device)
        self.post1 = nn.Conv1d(cfg.output_size, cfg.output_size, 3, stride=2, padding=1, device=device)
        self.post2 = nn.Conv1d(cfg.output_size, cfg.output_size, 1, device=device)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.post0(features.transpose(1, 2)))
        return self.post2(F.silu(self.post1(x)))
