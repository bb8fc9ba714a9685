"""Generator registry: name -> (config class, module class).

The JAX package's registry's five names (bigvgan, hifigan, vocos, refinegan
and firefly_gan_base), and the vae, vqvae and ssl families' generators, which the
JAX package builds outside its registry (``train/gan.py::create_train_state``).

``param_specs`` (hifigan, bigvgan and vocos, as the JAX registry's) gives a
model's tensor-parallel specs (``parallel/tp_specs.py``).  The others, the
vae, vqvae and ssl generators and the discriminators are storage-sharded over
the model group by the JAX package's per-leaf rule
(``vocoder_tpu/parallel/mesh.py::infer_param_specs``; ``tp_specs.storage_dims``,
``tp.storage_shard``): each rank stores slices and computes whole.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

PORTED = ("bigvgan", "hifigan", "vocos", "refinegan", "firefly_gan_base")  # the JAX registry's


@dataclasses.dataclass(frozen=True)
class GeneratorDef:
    config_cls: type
    module_cls: type
    param_specs: Callable | None = None  # cfg -> {module name: tp_specs.Spec}; None: storage-sharded


def get_generator(name: str) -> GeneratorDef:
    if name == "bigvgan":
        from vocoder_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, param_specs

        return GeneratorDef(BigVGANConfig, BigVGAN, param_specs)
    if name == "hifigan":
        from vocoder_tpu_torch.models.hifigan import HiFiGAN, HiFiGANConfig, param_specs

        return GeneratorDef(HiFiGANConfig, HiFiGAN, param_specs)
    if name == "vocos":
        from vocoder_tpu_torch.models.vocos import Vocos, VocosConfig, param_specs

        return GeneratorDef(VocosConfig, Vocos, param_specs)
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
