"""Generator registry: name -> (config class, module class).

Only BigVGAN is ported; every other name of the JAX package's registry
raises "not yet ported".
"""

from __future__ import annotations

import dataclasses

_JAX_PACKAGE_GENERATORS = ("hifigan", "vocos", "refinegan", "firefly_gan_base")


@dataclasses.dataclass(frozen=True)
class GeneratorDef:
    config_cls: type
    module_cls: type


def get_generator(name: str) -> GeneratorDef:
    if name == "bigvgan":
        from vocoder_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig

        return GeneratorDef(BigVGANConfig, BigVGAN)
    if name in _JAX_PACKAGE_GENERATORS:
        raise NotImplementedError(f"generator {name!r} is not yet ported; available: ['bigvgan']")
    raise KeyError(f"unknown generator {name!r}; available: ['bigvgan']")
