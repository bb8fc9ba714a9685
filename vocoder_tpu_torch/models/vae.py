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

- ``SSLCodecGenerator``: the ssl family's semantic codec (the reference's
  hifigan-vae) over frozen HuBERT features (B, T', hidden), which the caller
  makes with ``ssl_encoders.HubertFeatureExtractor``: the trainable post-net
  (``ssl_encoders.HubertPostNet``, stride 2), the EMA VQ, a HiFiGAN decoder at
  hop 640 (two HuBERT frames).  Its ``encode_to_codes`` and
  ``decode_from_codes`` are the JAX package's ``ssl_encode_to_codes`` and
  ``ssl_decode_from_codes``.

No kernel of their own: the convs are cuDNN's, the VQ's distance product
cuBLAS's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from vocoder_tpu_torch.models import convnext, hifigan, vq as vq_mod, wavenet
from vocoder_tpu_torch.models.ssl_encoders import HubertEncoderConfig, HubertPostNet
from vocoder_tpu_torch.nn import normal_like


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


@dataclasses.dataclass(frozen=True)
class SSLCodecGeneratorConfig:
    """Frozen HuBERT -> the post-net to latent channels -> the EMA VQ -> the decoder at hop 640."""

    latent_size: int
    hubert: HubertEncoderConfig
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


class _QuantisedCodec(nn.Module):
    """An encoder's latent (``encode``, the subclass's) -> the EMA VQ (``vq``) -> the HiFiGAN ``decoder``:
    inputs -> (audio (B, 1, F * hop), latent (B, latent, F), codes (Q, B, F), vq loss)."""

    def forward(self, inputs: torch.Tensor):
        latent = self.encode(inputs)
        quantized, codes, loss = self.vq(latent)
        return self.decoder(quantized), latent, codes, loss

    def encode_to_codes(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs -> codes (Q, B, F), int64."""
        return self.vq(self.encode(inputs))[1]

    def decode_from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (Q, B, F) -> audio (B, 1, F * hop)."""
        return self.decoder(self.vq.from_codes(codes))


class VQVAEGenerator(_QuantisedCodec):
    """spec (B, bins, F) -> (audio (B, 1, F * hop), latent (B, latent, F), codes (Q, B, F), vq loss)."""

    def __init__(self, cfg: VQVAEGeneratorConfig, device=None):
        super().__init__()
        if cfg.encoder.mode != "vqvae":
            raise ValueError(f"the vqvae encoder runs in 'vqvae' mode, not {cfg.encoder.mode!r}")
        self.cfg = cfg
        self.encoder = wavenet.PosteriorEncoder(cfg.encoder, device)
        self.vq = vq_mod.VectorQuantizer(cfg.vq, device)
        self.decoder = hifigan.HiFiGAN(cfg.decoder, device)

    def encode(self, spec: torch.Tensor) -> torch.Tensor:
        """spec (B, bins, F) -> the latent (B, latent, F)."""
        return self.encoder(spec.to(self.decoder.conv_post.bias.dtype))


class SSLCodecGenerator(_QuantisedCodec):
    """features (B, T', hidden) -> (audio (B, 1, F * hop), latent (B, latent, F), codes (Q, B, F), vq loss),
    F = (T' + 1) // 2.  The frozen backbone is not part of it (nor of the JAX package's parameters).
    ``encode_to_codes`` and ``decode_from_codes`` are the JAX package's ``ssl_encode_to_codes`` and
    ``ssl_decode_from_codes``."""

    def __init__(self, cfg: SSLCodecGeneratorConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.postnet = HubertPostNet(cfg.hubert, device)
        self.vq = vq_mod.VectorQuantizer(cfg.vq, device)
        self.decoder = hifigan.HiFiGAN(cfg.decoder, device)

    def encode(self, features: torch.Tensor) -> torch.Tensor:
        """features (B, T', hidden) -> the latent (B, latent, F)."""
        return self.postnet(features.to(self.decoder.conv_post.bias.dtype))


def vae_random_state_dict(cfg: VAEGeneratorConfig, seed: int) -> dict[str, torch.Tensor]:
    """fp32 CPU weights for ``VAEGenerator(cfg)`` from a numpy seed: the encoder's as its module's
    ``random_state_dict`` makes them, the decoder's as ``_decoder_weights`` (seed + 1)."""
    mod = convnext if cfg.encoder_kind == "convnext" else wavenet
    return {**mod.random_state_dict(cfg.encoder, seed, prefix="encoder."), **_decoder_weights(cfg.decoder, seed + 1)}


def _codebooks(cfg: vq_mod.VQConfig, seed: int) -> dict[str, torch.Tensor]:
    """Standard normal codebooks from a numpy seed, ``embed_avg`` equal to ``embed`` and zero cluster sizes, as a
    fresh quantiser has them."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i in range(cfg.num_quantizers):
        embed = torch.from_numpy(rng.standard_normal((cfg.codebook_size, cfg.dim)).astype(np.float32))
        sd[f"vq.layers.{i}.embed"] = embed
        sd[f"vq.layers.{i}.embed_avg"] = embed.clone()
        sd[f"vq.layers.{i}.cluster_size"] = torch.zeros(cfg.codebook_size)
    return sd


def vqvae_random_state_dict(cfg: VQVAEGeneratorConfig, seed: int) -> dict[str, torch.Tensor]:
    """fp32 CPU weights for ``VQVAEGenerator(cfg)`` from a numpy seed: the encoder's and decoder's as in
    ``vae_random_state_dict``, the codebooks as ``_codebooks`` makes them (seed + 2)."""
    return {**wavenet.random_state_dict(cfg.encoder, seed, prefix="encoder."),
            **_decoder_weights(cfg.decoder, seed + 1), **_codebooks(cfg.vq, seed + 2)}


def ssl_random_state_dict(cfg: SSLCodecGeneratorConfig, seed: int) -> dict[str, torch.Tensor]:
    """fp32 CPU weights for ``SSLCodecGenerator(cfg)`` from a numpy seed: the post-net's weights normal with
    variance 1 / fan-in (HuBERT's features are layer-normed, of unit scale) and biases of 0.01, the decoder's
    as in ``vae_random_state_dict`` (seed + 1), the codebooks as ``_codebooks`` (seed + 2)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, val in HubertPostNet(cfg.hubert, device="meta").state_dict().items():
        shape = tuple(val.shape)
        scale = 1.0 / np.sqrt(shape[1] * shape[2]) if key.endswith("weight") else 0.01
        sd[f"postnet.{key}"] = torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))
    return {**sd, **_decoder_weights(cfg.decoder, seed + 1), **_codebooks(cfg.vq, seed + 2)}
