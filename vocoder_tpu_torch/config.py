"""Presets, the training config tree and its dotted overrides.

A copy of what the port needs of ``vocoder_tpu/config.py`` (that module
imports the JAX models, so the port keeps its own): the resolution presets
and upsample factorizations, the generator presets (hifigan, vocos,
vocos_small, vocos_huge, bigvgan, refinegan and firefly_gan_base; refinegan
builds only at hop 256 and firefly_gan_base only at hop 512, and elsewhere
each raises ``ValueError`` where the JAX package's asserts), ``build_task_config``
(the "gan" family's ``GANTaskConfig``: MPD periods (3, 5, 7, 11, 17, 23,
37), the MRD and MR-STFT resolutions, 128-frame crops, hop * 32 for the
discriminators; the "vae" and "vqvae" families' generators over the linear
spectrogram, the vqvae's with MPD periods (2, 3, 5, 7, 11), the first four
MRD resolutions and 32-frame crops; the "ssl" family's HuBERT codec, with the
vqvae's discriminators and crops),
``DataConfig``, ``RunConfig``, ``TrainConfig``,
``build_train_config``, the dotted overrides (``run.max_steps=4``) and
``overlay_task_config``, which rebuilds a task config from a workdir's
``config.json``.  Each preset maps a resolution to the generator's registry
name and its config.  The tests hold them equal to the JAX package's field by
field.  ``RunConfig`` drops the JAX package's mesh fields, which the port does
not have yet (ROADMAP.md), and its split step (an XLA compile workaround).
"""

from __future__ import annotations

import ast
import dataclasses
import functools
from typing import Any

from vocoder_tpu_torch.models.mpd import MPDConfig
from vocoder_tpu_torch.models.mrd import MRDConfig
from vocoder_tpu_torch.models.registry import get_generator
from vocoder_tpu_torch.train.gan import GANTaskConfig
from vocoder_tpu_torch.train.schedule import WarmupCosineConfig
from vocoder_tpu_torch.utils.config_tree import tuplify

RESOLUTIONS: dict[str, dict] = {
    "44100_512_2048": dict(sampling_rate=44100, num_mels=128, n_fft=2048, hop_length=512, win_length=2048),
    "24000_256_1024": dict(sampling_rate=24000, num_mels=100, n_fft=1024, hop_length=256, win_length=1024),
    "24000_2048_3072": dict(sampling_rate=24000, num_mels=100, n_fft=3072, hop_length=2048, win_length=3072),
    "16000_640_2048": dict(sampling_rate=16000, num_mels=128, n_fft=2048, hop_length=640, win_length=2048),
}

# Upsample-rate factorizations per hop length (prod(rates) == hop).
_UPSAMPLE_PRESETS = {
    512: ((8, 8, 2, 2, 2), (16, 16, 8, 2, 2)),
    256: ((8, 8, 2, 2), (16, 16, 4, 4)),
    2048: ((8, 8, 4, 4, 2), (16, 16, 8, 8, 4)),
    640: ((8, 5, 4, 2, 2), (16, 10, 8, 4, 4)),
}


def upsample_rates_for_hop(hop: int) -> tuple[tuple, tuple]:
    if hop in _UPSAMPLE_PRESETS:
        return _UPSAMPLE_PRESETS[hop]
    # Greedy factorization fallback: rates of 8/5/4/3/2, kernel = 2*rate.
    rates = []
    rem = hop
    for f in (8, 5, 4, 3, 2):
        while rem % f == 0 and rem > 1:
            rates.append(f)
            rem //= f
    if rem != 1:
        raise ValueError(f"cannot factor hop {hop}")
    return tuple(rates), tuple(2 * r for r in rates)


def _gen_upsampler(name: str, res: dict):
    """hifigan and bigvgan: the hop's upsample factorization, no template (``task.generator.use_template=True``
    turns it on)."""
    rates, kernels = upsample_rates_for_hop(res["hop_length"])
    return name, get_generator(name).config_cls(
        hop_length=res["hop_length"],
        upsample_rates=rates,
        upsample_kernel_sizes=kernels,
        num_mels=res["num_mels"],
        use_template=False,
    )


def _gen_vocos(size: str, res: dict):
    from vocoder_tpu_torch.models.convnext import ConvNeXtConfig
    from vocoder_tpu_torch.models.vocos import ISTFTHeadConfig, VocosConfig

    stft = dict(n_fft=res["n_fft"], hop_length=res["hop_length"], win_length=res["win_length"])
    if size == "small":
        # The reference's vocos-small.yaml cannot instantiate; this is its intent, as the JAX
        # package builds it: one depth-8, dim-512 ConvNeXt stage and an iSTFT head.
        return "vocos", VocosConfig(
            backbone=ConvNeXtConfig(input_channels=res["num_mels"], depths=(8,), dims=(512,), drop_path_rate=0.1),
            head=ISTFTHeadConfig(dim=512, **stft),
        )
    return "vocos", getattr(VocosConfig, size)(num_mels=res["num_mels"], **stft)


def _gen_refinegan(res: dict):
    """The RefineGAN defaults, rates (2, 2, 8, 8) / (8, 8, 2, 2): hop 256 only."""
    from vocoder_tpu_torch.models.refinegan import RefineGANConfig

    return "refinegan", RefineGANConfig(sampling_rate=res["sampling_rate"], hop_length=res["hop_length"],
                                        num_mels=res["num_mels"])


def _gen_firefly(res: dict):
    """The reference's firefly-gan-base.yaml: a ConvNeXt backbone and a HiFiGAN head of rates
    (8, 8, 2, 2, 2), so hop 512 only."""
    from vocoder_tpu_torch.models.convnext import ConvNeXtConfig
    from vocoder_tpu_torch.models.firefly import FireflyConfig
    from vocoder_tpu_torch.models.hifigan import HiFiGANConfig

    return "firefly_gan_base", FireflyConfig(
        backbone=ConvNeXtConfig(input_channels=res["num_mels"], depths=(3, 3, 9, 3), dims=(128, 256, 384, 512),
                                drop_path_rate=0.2),
        head=HiFiGANConfig(hop_length=res["hop_length"], upsample_rates=(8, 8, 2, 2, 2),
                           upsample_kernel_sizes=(16, 16, 4, 4, 4), num_mels=512, upsample_initial_channel=512,
                           use_template=False, pre_conv_kernel_size=13, post_conv_kernel_size=13),
    )


GENERATOR_PRESETS = {
    "hifigan": functools.partial(_gen_upsampler, "hifigan"),
    "vocos": functools.partial(_gen_vocos, "base"),
    "vocos_small": functools.partial(_gen_vocos, "small"),
    "vocos_huge": functools.partial(_gen_vocos, "huge"),
    "bigvgan": functools.partial(_gen_upsampler, "bigvgan"),
    "refinegan": _gen_refinegan,
    "firefly_gan_base": _gen_firefly,
}


def _mrd_resolutions(res: dict) -> tuple:
    """The MRD's and the MR-STFT loss's resolutions: the model's first, then the fixed set (gan.yaml)."""
    return ((res["n_fft"], res["hop_length"], res["win_length"]),
            (1024, 120, 600), (2048, 240, 1200), (4096, 480, 2400), (512, 50, 240))


def _vae_generator(res: dict):
    """The reference's VAEModel (vae.yaml): a ConvNeXt encoder over the linear spectrogram emitting
    2 * 256 channels, a HiFiGAN decoder of 512 channels at the hop's upsample rates."""
    from vocoder_tpu_torch.models.convnext import ConvNeXtConfig
    from vocoder_tpu_torch.models.hifigan import HiFiGANConfig
    from vocoder_tpu_torch.models.vae import VAEGeneratorConfig

    latent = 256
    rates, kernels = upsample_rates_for_hop(res["hop_length"])
    return "vae", VAEGeneratorConfig(
        latent_size=latent, encoder_kind="convnext",
        encoder=ConvNeXtConfig(input_channels=res["n_fft"] // 2 + 1, depths=(3, 3, 9, 3),
                               dims=(128, 256, 384, 2 * latent), drop_path_rate=0.2),
        decoder=HiFiGANConfig(hop_length=res["hop_length"], upsample_rates=rates, upsample_kernel_sizes=kernels,
                              num_mels=latent, upsample_initial_channel=512, use_template=False),
    )


def _vqvae_generator(res: dict):
    """The reference's VQVAEModel (vqvae.yaml): a 16-layer WaveNet of width 256 over the linear spectrogram,
    an EMA codebook of 4096 x 512, a HiFiGAN decoder of 512 channels."""
    from vocoder_tpu_torch.models.hifigan import HiFiGANConfig
    from vocoder_tpu_torch.models.vae import VQVAEGeneratorConfig
    from vocoder_tpu_torch.models.vq import VQConfig
    from vocoder_tpu_torch.models.wavenet import PosteriorEncoderConfig

    latent = 512
    rates, kernels = upsample_rates_for_hop(res["hop_length"])
    return "vqvae", VQVAEGeneratorConfig(
        latent_size=latent,
        encoder=PosteriorEncoderConfig(in_channels=res["n_fft"] // 2 + 1, out_channels=latent, hidden_channels=256,
                                       n_layers=16, mode="vqvae"),
        decoder=HiFiGANConfig(hop_length=res["hop_length"], upsample_rates=rates, upsample_kernel_sizes=kernels,
                              num_mels=latent, upsample_initial_channel=512, use_template=False),
        vq=VQConfig(dim=latent, codebook_size=4096, num_quantizers=1),
    )


def _ssl_generator(res: dict):
    """The reference's hifigan-vae: frozen HuBERT (768 wide) -> the post-net to 512 latent channels -> an EMA
    codebook of 4096 x 512 (vqvae.yaml's bottleneck) -> a HiFiGAN decoder of 512 channels at the hop's rates."""
    from vocoder_tpu_torch.models.hifigan import HiFiGANConfig
    from vocoder_tpu_torch.models.ssl_encoders import HubertEncoderConfig
    from vocoder_tpu_torch.models.vae import SSLCodecGeneratorConfig
    from vocoder_tpu_torch.models.vq import VQConfig

    latent = 512
    rates, kernels = upsample_rates_for_hop(res["hop_length"])
    return "ssl", SSLCodecGeneratorConfig(
        latent_size=latent, hubert=HubertEncoderConfig(output_size=latent),
        decoder=HiFiGANConfig(hop_length=res["hop_length"], upsample_rates=rates, upsample_kernel_sizes=kernels,
                              num_mels=latent, upsample_initial_channel=512, use_template=False),
        vq=VQConfig(dim=latent, codebook_size=4096, num_quantizers=1),
    )


FAMILIES = ("gan", "vae", "vqvae", "ssl")


def build_task_config(model: str = "hifigan", resolution: str = "44100_512_2048", family: str = "gan") -> GANTaskConfig:
    """The task config of a family at a resolution: for "gan" that of a generator preset (``vocos-huge``
    reads as ``vocos_huge``); "vae", "vqvae" and "ssl" build their own generator and ignore ``model``."""
    model = model.replace("-", "_")
    if resolution not in RESOLUTIONS:
        raise KeyError(f"unknown resolution {resolution!r}; available: {sorted(RESOLUTIONS)}")
    res = RESOLUTIONS[resolution]
    mrd_res = _mrd_resolutions(res)
    kw: dict = {"mpd": MPDConfig(periods=(3, 5, 7, 11, 17, 23, 37)), "num_frames": 128}
    if family == "gan":
        if model not in GENERATOR_PRESETS:
            raise KeyError(f"unknown generator preset {model!r}; available: {sorted(GENERATOR_PRESETS)}")
        generator_name, generator = GENERATOR_PRESETS[model](res)
    elif family == "vae":
        generator_name, generator = _vae_generator(res)
    elif family in ("vqvae", "ssl"):
        generator_name, generator = (_vqvae_generator if family == "vqvae" else _ssl_generator)(res)
        mrd_res = mrd_res[:4]  # vqvae.yaml: smaller crops and discriminators (the ssl task trains through it)
        kw = {"mpd": MPDConfig(periods=(2, 3, 5, 7, 11)), "num_frames": 32}
    else:
        raise ValueError(f"unknown family {family!r}; one of {FAMILIES}")
    return GANTaskConfig(
        sampling_rate=res["sampling_rate"],
        n_fft=res["n_fft"],
        hop_length=res["hop_length"],
        win_length=res["win_length"],
        num_mels=res["num_mels"],
        generator_name=generator_name,
        generator=generator,
        mrd=MRDConfig(resolutions=mrd_res),
        stft_resolutions=mrd_res,
        crop_length=res["hop_length"] * 32,
        input_transform="mel" if family == "gan" else "linear",
        family=family,
        schedule=WarmupCosineConfig(val_base=1e-4, val_final=0.0, max_decay_steps=5_000_000),
        **kw,
    )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The reference's data/vocoder.yaml."""

    train_roots: tuple = ()  # directories or filelists
    train_probs: tuple = ()
    val_root: str | None = None
    batch_size: int = 16
    val_batch_size: int = 2
    val_crop_frames: int = 1000
    num_workers: int = 4  # decode/augment worker threads


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The reference's trainer/default.yaml and callbacks/default.yaml."""

    max_steps: int = 10_000_000
    val_interval: int = 5000
    ckpt_interval: int = 20_000
    log_interval: int = 100
    seed: int = 594461
    model_parallel: int = 1  # tensor parallelism: the processes of a model group (parallel/tp.py)
    data_parallel: int | None = None  # None: the number of processes (torchrun's WORLD_SIZE) // model_parallel
    precision: str = "highest"  # "highest": fp32, TF32 off; "default": TF32 on
    ckpt_path: str | None = None
    resume_weights_only: bool = False
    workdir: str = "logs/train"
    profile_steps: tuple | None = None  # (start, stop): torch.profiler over steps [start, stop) into workdir/profile
    early_stop_patience: int | None = None  # validations without a val mel-L1 improvement
    val_pesq: bool = True  # host-side val PESQ-WB at 16 kHz (eval_metrics.pesq), as the JAX package's


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    task: GANTaskConfig
    data: DataConfig = DataConfig()
    run: RunConfig = RunConfig()


def build_train_config(model: str = "hifigan", resolution: str = "44100_512_2048", family: str = "gan",
                       overrides=()) -> TrainConfig:
    return apply_overrides(TrainConfig(task=build_task_config(model, resolution, family)), overrides)


class _Leaf:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def _parse_value(s: str) -> Any:
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def _apply_tree(obj, tree: dict):
    """Apply a nested override tree with one replace per dataclass, so sibling fields change
    together and invariants across fields (prod(upsample_rates) == hop_length) stay satisfiable."""
    changes = {}
    for key, node in tree.items():
        if isinstance(node, _Leaf):
            changes[key] = node.value
        elif dataclasses.is_dataclass(obj):
            changes[key] = _apply_tree(getattr(obj, key), node)
        elif isinstance(obj, dict):
            changes[key] = _apply_tree(obj[key], node)
        else:
            raise TypeError(f"cannot descend into {type(obj)} at {key!r}")
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **changes)
    if isinstance(obj, dict):
        return {**obj, **changes}
    raise TypeError(f"cannot apply overrides {list(tree)} to {type(obj)}")


def apply_overrides(cfg, overrides) -> Any:
    """Dotted ``key.sub=value`` overrides; values parse as Python literals, else stay strings."""
    tree: dict = {}
    for ov in overrides:
        key, eq, raw = ov.partition("=")
        if eq != "=":
            raise ValueError(f"override must be key=value, got {ov!r}")
        parts = key.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"override {key!r} conflicts with an earlier leaf")
        if isinstance(node.get(parts[-1]), dict):
            raise ValueError(f"override {key!r} conflicts with an earlier deeper override")
        node[parts[-1]] = _Leaf(_parse_value(raw))
    return _apply_tree(cfg, tree) if tree else cfg


def overlay_task_config(template, d: dict):
    """``template`` with the values of a ``config.json`` asdict() tree: nested dataclasses recovered by
    the template's types, lists back to tuples, keys the template does not know ignored."""
    kw = {}
    for f in dataclasses.fields(type(template)):
        if f.name not in d:
            continue
        v, cur = d[f.name], getattr(template, f.name)
        kw[f.name] = overlay_task_config(cur, v) if dataclasses.is_dataclass(cur) and isinstance(v, dict) else tuplify(v)
    return dataclasses.replace(template, **kw)
