"""Generator registry: name -> (config class, module class).

BigVGAN, HiFiGAN and Vocos are ported; every other name of the JAX
package's registry raises "not yet ported".
"""

from __future__ import annotations

import dataclasses

_JAX_PACKAGE_GENERATORS = ("refinegan", "firefly_gan_base")
PORTED = ("bigvgan", "hifigan", "vocos")


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
    if name in _JAX_PACKAGE_GENERATORS:
        raise NotImplementedError(f"generator {name!r} is not yet ported; available: {list(PORTED)}")
    raise KeyError(f"unknown generator {name!r}; available: {list(PORTED)}")
