"""Generator registry: name -> (config class, module class).

The JAX package's registry's five names (bigvgan, hifigan, vocos, refinegan
and firefly_gan_base), and the vae, vqvae and ssl families' generators, which the
JAX package builds outside its registry (``train/gan.py::create_train_state``).
"""

from __future__ import annotations

import dataclasses

PORTED = ("bigvgan", "hifigan", "vocos", "refinegan", "firefly_gan_base")  # the JAX registry's


@dataclasses.dataclass(frozen=True)
class GeneratorDef:
    config_cls: type
    module_cls: type


def get_generator(name: str) -> GeneratorDef:
    if name == "bigvgan":
        from vocoder_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig

        return GeneratorDef(BigVGANConfig, BigVGAN)
    if name == "hifigan":
        from vocoder_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig

        return GeneratorDef(HiFiGANConfig, HiFiGAN)
    if name == "vocos":
        from vocoder_tpu_torch.models.vocos import Vocos, VocosConfig

        return GeneratorDef(VocosConfig, Vocos)
    if name == "refinegan":
        from vocoder_tpu_torch.models.refinegan import RefineGAN, RefineGANConfig

        return GeneratorDef(RefineGANConfig, RefineGAN)
    if name == "firefly_gan_base":
        from vocoder_tpu_torch.models.firefly import Firefly, FireflyConfig

        return GeneratorDef(FireflyConfig, Firefly)
    if name == "vae":
        from vocoder_tpu_torch.models.vae import VAEGenerator, VAEGeneratorConfig

        return GeneratorDef(VAEGeneratorConfig, VAEGenerator)
    if name == "vqvae":
        from vocoder_tpu_torch.models.vae import VQVAEGenerator, VQVAEGeneratorConfig

        return GeneratorDef(VQVAEGeneratorConfig, VQVAEGenerator)
    if name == "ssl":
        from vocoder_tpu_torch.models.vae import SSLCodecGenerator, SSLCodecGeneratorConfig

        return GeneratorDef(SSLCodecGeneratorConfig, SSLCodecGenerator)
    raise KeyError(f"unknown generator {name!r}; available: {[*PORTED, 'vae', 'vqvae', 'ssl']}")
