"""VAE and VQ-VAE generators (encoder -> [EMA VQ] -> HiFiGAN decoder) as ``torch.nn.Module``\\ s.

Counterpart of ``vocoder_tpu/models/vae.py`` (the reference's VAEModel and
VQVAEModel with their encoder/decoder generators), over the linear
spectrogram (B, n_fft // 2 + 1, F):

- ``VAEGenerator``: a ConvNeXt encoder (or a WaveNet one in "vqvae" mode,
  which emits the raw latent) to 2 * latent channels, chunked into mean and
  logvar; z = mean + eps * exp(logvar / 2) in training (eps from the
  ``noise`` generator), z = mean in eval mode; a HiFiGAN decoder.  The JAX
  package runs this ConvNeXt without its training flag (``vae_encode``), so
  its ``drop_path_rate`` never drops a path there; nor does it here, where
  the encoder gets no noise generator.
- ``VQVAEGenerator``: a WaveNet posterior encoder ("vqvae" mode), the EMA
  vector quantiser (``models/vq.py``; its codebooks are buffers of this
  module), a HiFiGAN decoder.  ``encode_to_codes`` and ``decode_from_codes``
  are the codec's two halves.

The ssl family (a frozen HuBERT backbone, a post-net, the VQ and a HiFiGAN
decoder) is not ported: its backbone is ``transformers``' ``HubertModel``,
with weights the repository does not hold.  No kernel of their own: the
convs are cuDNN's, the VQ's distance product cuBLAS's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from vocoder_tpu_torch.models import convnext, hifigan, vq as vq_mod, wavenet
from vocoder_tpu_torch.nn import normal_like

SSL_NOT_PORTED = ("the ssl family is not ported: its frozen HuBERT backbone needs the transformers package "
                  "(HubertModel), which the port does not depend on, and HuBERT weights, which the repository does "
                  "not hold (ROADMAP.md Queue 1)")


@dataclasses.dataclass(frozen=True)
class VAEGeneratorConfig:
    """The encoder emits 2 * latent channels (mean | logvar); the decoder takes latent channels."""

    latent_size: int
    encoder_kind: str  # "convnext" | "wavenet"
    encoder: Any
    decoder: hifigan.HiFiGANConfig


@dataclasses.dataclass(frozen=True)
class VQVAEGeneratorConfig:
    """The encoder emits latent channels; the EMA VQ; the decoder takes latent channels."""

    latent_size: int
    encoder: wavenet.PosteriorEncoderConfig  # mode "vqvae"
    decoder: hifigan.HiFiGANConfig
    vq: vq_mod.VQConfig


def _decoder_weights(cfg: hifigan.HiFiGANConfig, seed: int) -> dict[str, torch.Tensor]:
    """``hifigan.random_state_dict`` with conv_pre's gain 1: its input is a latent of unit scale, not a
    log-mel near -5 (as Firefly-GAN's head)."""
    sd = hifigan.random_state_dict(cfg, seed)
    sd["conv_pre.parametrizations.weight.original0"] *= 5.0
    return {f"decoder.{k}": v for k, v in sd.items()}


class VAEGenerator(nn.Module):
    """spec (B, bins, F) -> (audio (B, 1, F * hop), mean (B, latent, F), logvar (B, latent, F))."""

    draws_noise = True  # forward takes ``noise``, the generator of eps in training

    def __init__(self, cfg: VAEGeneratorConfig, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.encoder_kind == "convnext":
            self.encoder = convnext.ConvNeXtEncoder(cfg.encoder, device)
        elif cfg.encoder_kind == "wavenet":
            if cfg.encoder.mode != "vqvae":
                raise ValueError("a wavenet vae encoder runs in 'vqvae' mode, which emits the raw latent")
            self.encoder = wavenet.PosteriorEncoder(cfg.encoder, device)
        else:
            raise ValueError(f"unknown encoder_kind {cfg.encoder_kind!r}")
        self.decoder = hifigan.HiFiGAN(cfg.decoder, device)

    def encode(self, spec: torch.Tensor) -> torch.Tensor:
        """spec (B, bins, F) -> the raw latent (B, 2 * latent, F)."""
        if self.cfg.encoder_kind == "convnext":
            return self.encoder(spec).transpose(1, 2)
        return self.encoder(spec)

    def forward(self, spec: torch.Tensor, noise: torch.Generator | None = None):
        latent = self.encode(spec.to(self.decoder.conv_post.bias.dtype))
        n = self.cfg.latent_size
        mean, logvar = latent[:, :n], latent[:, n:]
        if self.training:
            if noise is None:
                raise ValueError("the vae in training needs a noise generator for its eps draws")
            z = mean + normal_like(mean, noise) * torch.exp(0.5 * logvar)
        else:
            z = mean
        return self.decoder(z), mean, logvar


class VQVAEGenerator(nn.Module):
    """spec (B, bins, F) -> (audio (B, 1, F * hop), latent (B, latent, F), codes (Q, B, F), vq loss)."""

    def __init__(self, cfg: VQVAEGeneratorConfig, device=None):
        super().__init__()
        if cfg.encoder.mode != "vqvae":
            raise ValueError(f"the vqvae encoder runs in 'vqvae' mode, not {cfg.encoder.mode!r}")
        self.cfg = cfg
        self.encoder = wavenet.PosteriorEncoder(cfg.encoder, device)
        self.vq = vq_mod.VectorQuantizer(cfg.vq, device)
        self.decoder = hifigan.HiFiGAN(cfg.decoder, device)

    def forward(self, spec: torch.Tensor):
        latent = self.encoder(spec.to(self.decoder.conv_post.bias.dtype))
        quantized, codes, loss = self.vq(latent)
        return self.decoder(quantized), latent, codes, loss

    def encode_to_codes(self, spec: torch.Tensor) -> torch.Tensor:
        """spec (B, bins, F) -> codes (Q, B, F), int64."""
        return self.vq(self.encoder(spec.to(self.decoder.conv_post.bias.dtype)))[1]

    def decode_from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (Q, B, F) -> audio (B, 1, F * hop)."""
        return self.decoder(self.vq.from_codes(codes))


def vae_random_state_dict(cfg: VAEGeneratorConfig, seed: int) -> dict[str, torch.Tensor]:
    """fp32 CPU weights for ``VAEGenerator(cfg)`` from a numpy seed: the encoder's as its module's
    ``random_state_dict`` makes them, the decoder's as ``_decoder_weights`` (seed + 1)."""
    mod = convnext if cfg.encoder_kind == "convnext" else wavenet
    return {**mod.random_state_dict(cfg.encoder, seed, prefix="encoder."), **_decoder_weights(cfg.decoder, seed + 1)}


def vqvae_random_state_dict(cfg: VQVAEGeneratorConfig, seed: int) -> dict[str, torch.Tensor]:
    """fp32 CPU weights for ``VQVAEGenerator(cfg)`` from a numpy seed: the encoder's and decoder's as in
    ``vae_random_state_dict``, standard normal codebooks (seed + 2) with ``embed_avg`` equal to ``embed`` and
    zero cluster sizes, as a fresh quantiser has them."""
    sd = {**wavenet.random_state_dict(cfg.encoder, seed, prefix="encoder."), **_decoder_weights(cfg.decoder, seed + 1)}
    rng = np.random.default_rng(seed + 2)
    for i in range(cfg.vq.num_quantizers):
        embed = torch.from_numpy(rng.standard_normal((cfg.vq.codebook_size, cfg.vq.dim)).astype(np.float32))
        sd[f"vq.layers.{i}.embed"] = embed
        sd[f"vq.layers.{i}.embed_avg"] = embed.clone()
        sd[f"vq.layers.{i}.cluster_size"] = torch.zeros(cfg.vq.codebook_size)
    return sd
