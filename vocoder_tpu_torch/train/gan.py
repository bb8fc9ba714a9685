"""The GAN training step: generator, then discriminators, on one random crop.

Counterpart of ``vocoder_tpu/train/gan.py`` (the "gan", "vae", "vqvae" and
"ssl" families) and the reference's GANModel with manual optimization: per step
the generator loss

    base + 2.5 * (spectral convergence + log-mag MR-STFT) + 45 * mel-L1
        + mean over {mpd, mrd} of (LSGAN adversarial + feature matching)

is computed on the masked audio, with the input (``input_transform``: the
log-mel of the "gan" family, the linear spectrogram of the others) made on the card and
a random crop of ``crop_length`` samples before the discriminators; the
generator takes an AdamW(0.8, 0.99, eps 1e-6, weight decay 0.01) step on the
warmup-cosine lr, then the discriminators take theirs on the same crop, with
the pre-update generator's fake detached.  Metrics carry the JAX package's
names (``train/generator/*``, ``train/discriminator/*``, ``grad_norm*``,
``lr``) and stay on the card as 0-d tensors until the caller reads them.

The families (``generator_forward``): "gan" feeds the generator the log-mel,
base 0; "vae" (the reference's VAEModel) decodes z = mean + eps * exp(logvar
/ 2) and takes the KL divergence 0.5 * mean(mean^2 + e^logvar - logvar - 1)
as base, logged as ``train/generator/kl``; "vqvae" decodes the quantised
latent, fixed to the audio's length within one hop, base 0 and the VQ's
commitment loss logged as ``train/generator/vq`` (the reference keeps it out
of the total); "ssl" does the same from the frozen HuBERT's features
(``batch["ssl_features"]`` (B, T', hidden), which the trainer makes on the
card), the post-net taking the place of the encoder.  The EMA codebook update
of a vqvae or ssl step is written after the
generator's backward, from the forward's codes and latent, as the JAX step
writes its new state at the end: the discriminators see the fake of the
codebook before the update.

Where PyTorch differs from the JAX program, each handled here:
- The generator's backward would also fill the discriminators' ``.grad``
  (JAX differentiates the generator loss w.r.t. the generator's parameters
  only).  The generator phase runs the discriminators with
  ``requires_grad`` off, so no gradient reaches them and the discriminator
  step sees its own gradients alone.
- The crop start comes from the state's ``torch.Generator`` (``rng``, on the
  CPU), which cannot reproduce ``jax.random``; ``make_train_step``'s step
  takes an optional ``crop_start`` so that a parity test can pass the JAX
  program's start.  The generator's own draws (RefineGAN's AdaIN noise,
  ConvNeXt's drop_path masks in Vocos and Firefly-GAN, the vae's eps) come
  from a second generator (``noise``, on the model's device, seeded from the
  same seed and saved in the checkpoint beside ``rng``); validation draws
  RefineGAN's from the seeded-0 default, as the JAX package's eval step does,
  and the others draw nothing in eval mode.
- Generators that consume an f0 template (``needs_template``: RefineGAN, and
  HiFiGAN or BigVGAN with ``use_template``) take ``batch["template"]``
  (B, 1, T), which the data pipeline builds from each element's final audio.
- Adam's first step moves each parameter by about lr * sign(g): where a
  gradient is near 0, a rounding difference flips the sign of the update.
  Compare gradients tightly and updated parameters with that in mind.

Mixed precision, as the JAX package's: ``compute_dtype="bfloat16"`` runs the
generator ("gan" family only: the vae, vqvae and ssl generators, and the ssl
family's features, stay fp32, as in the JAX package) and the discriminators
(every family) on bf16
copies of their floating parameters (``nn.cast_parameters``: the weight-norm
originals too, so the norms run in bf16; buffers such as the EMA codebooks
stay as they are), with the input spectrum, the template and the
discriminators' audio cast to bf16 and their outputs cast back to fp32 before
the losses.  The gradients flow back through the casts to the fp32 masters,
and AdamW's state stays fp32.  No ``torch.autocast``: it keeps some
operations in fp32 and would compute another function than JAX's all-bf16
forward.  The eval step runs the "gan" family's generator as a bf16 copy
(``nn.cast_copy``), made anew when the weights changed and shared by the
batches of one validation (``utils/weight_cache.py``), so that BigVGAN's
validation takes K2's bf16 route.  ``loss_stft_dtype="bfloat16"`` rounds the masked waveforms to
bf16 before the MR-STFT and mel losses; the port transforms them in fp32 and
rounds the magnitudes and the loss mels to bf16 (``ops/spectral.py``), where
the JAX package's magnitudes come out of a bf16 DFT; the norms and logs
accumulate in fp32.  The MRD's STFT of bf16 audio follows the same rule.

Data parallelism (``make_train_step(cfg, group=...)``, the trainer's under
torchrun): each rank runs both phases on its share of the global batch inside
``parallel.dist.data_parallel``, so that the step is one process's step on the
ranks' batches concatenated (the JAX step under GSPMD is the global batch's).
Each loss term is the rank's share of the global term (a batch mean over the
ranks; the MRD's adversarial terms, sums over batch rows, as they are; the
spectral convergence from all-reduced sums), so that after each phase's
backward the gradients are summed over the ranks (one flat all-reduce) and
are the global loss's; only then come the grad norms and AdamW, the same on
every rank.  The logged losses are the shares summed over the ranks.  The crop
start is one draw a step from ``state.rng``, alike on every rank; the
generator's draws take the global batch's shape (``dist.batch_draw``); bnvae's
statistics and the EMA codebook sums are all-reduced in their modules.  No
``DistributedDataParallel``: its hooks and its buffer broadcast at each forward
fit neither the two backward passes and optimizers a step, nor the
discriminators run with ``requires_grad`` off in the generator phase, nor the
EMA buffers written after the backward.

Tensor parallelism (``create_train_state(..., model_group=...)``, the trainer's
``run.model_parallel``; ``parallel/tp.py``), the JAX package's
``train_state_specs``: the generator of a model with ``param_specs`` (hifigan,
bigvgan, vocos; the "gan" family, as the JAX package's ``model_param_specs``)
is built whole from the seed, then each rank keeps its shard; its forward runs
the model group's collectives, so the fake, the losses and the discriminators'
work are whole and alike on every rank of the group.  Everything else is
storage-sharded (``tp.storage_shard``, the JAX package's per-leaf fallback):
the discriminators always, and the whole generator of refinegan, firefly and
the vae, vqvae and ssl families with its vq codebooks; each rank stores a
slice of every tensor of at least ``min_size`` elements and each module call
gathers them, so those modules compute whole on every rank.  The frozen
HuBERT backbone is not part of the state and stays whole.  The gradients come
out as the shards of the whole gradient (a replicated gain used on a shard
gets the group's sum in its backward; a storage shard its slice of the whole
gradient), ``train/generator/grad_norm`` and the discriminators' are the whole
gradients' norms (``tp.grad_norm``), and AdamW updates each shard, its moments
sharded alike.  The vq's EMA update runs on the gathered codebooks and writes
this rank's slice (``tp.gathered``).  The gradient of every parameter the
ranks hold whole (small discriminator and generator tensors, the replicated
generator layers) is averaged over the model group
(``tp.average_replicated_grads``), so the copies stay equal where the
backward is not bitwise deterministic (cuDNN's).  With data parallelism beside it, ``group`` is the data group
of the grid: the ranks that hold the same shard.  ``TrainState.state_dict``
holds whole tensors (every shard and its moments gathered over the model
group, as Orbax saves global arrays) and ``load_state_dict`` takes this rank's
shard of them.

While a profiler records, each phase is split into spans (``utils/spans.py``):
``train.g.forward`` (the generator), ``train.g.loss`` (the losses, with
``mr_stft_loss`` and ``discriminators`` inside), ``train.g.backward``,
``train.g.update`` (all-reduce, global values, grad norm, lr, AdamW, EMA),
then ``train.d.loss``, ``train.d.backward`` and ``train.d.update``.

Not ported: ``spectral_precision`` (a TPU MXU pass count) and the split step
(an XLA compile workaround) are TPU machinery.  ``run.precision`` sets TF32
in the trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.nn.utils import parametrize

from vocoder_tpu_torch.losses import (
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
    multi_resolution_stft_loss,
)
from vocoder_tpu_torch.models.mpd import MPDConfig, MultiPeriodDiscriminator
from vocoder_tpu_torch.models.mrd import MRDConfig, MultiResolutionDiscriminator
from vocoder_tpu_torch.models.registry import get_generator
from vocoder_tpu_torch.nn import cast_copy, cast_parameters
from vocoder_tpu_torch.ops.spectral import linear_spectrogram, log_mel_spectrogram
from vocoder_tpu_torch.parallel import dist, tp
from vocoder_tpu_torch.train.schedule import WarmupCosineConfig, warmup_cosine
from vocoder_tpu_torch.utils.spans import span
from vocoder_tpu_torch.utils.weight_cache import WeightCache

DEFAULT_RESOLUTIONS = ((2048, 512, 2048), (1024, 120, 600), (2048, 240, 1200), (4096, 480, 2400), (512, 50, 240))
TRAINABLE = ("bigvgan", "hifigan", "refinegan", "vocos", "firefly_gan_base", "vae", "vqvae", "ssl")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}  # compute_dtype and loss_stft_dtype


@dataclasses.dataclass(frozen=True)
class GANTaskConfig:
    """The reference's gan.yaml composed with a resolution preset."""

    sampling_rate: int = 44100
    n_fft: int = 2048
    hop_length: int = 512
    win_length: int = 2048
    num_mels: int = 128

    generator_name: str = "hifigan"
    generator: Any = None  # generator config dataclass

    mpd: MPDConfig = MPDConfig(periods=(3, 5, 7, 11, 17, 23, 37))
    mrd: MRDConfig = MRDConfig(resolutions=DEFAULT_RESOLUTIONS)
    stft_resolutions: tuple = DEFAULT_RESOLUTIONS  # tied to the MRD's (gan.yaml)

    num_frames: int = 128
    crop_length: int | None = 512 * 32  # hop * 32
    input_transform: str = "mel"  # "mel" | "linear" (the vae and vqvae families'; ssl reads HuBERT features)
    family: str = "gan"  # "gan" | "vae" | "vqvae" | "ssl"

    schedule: WarmupCosineConfig = WarmupCosineConfig()
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    adam_eps: float = 1e-6
    weight_decay: float = 0.01

    stft_weight: float = 2.5
    mel_weight: float = 45.0
    # Mixed precision: the generator's ("gan" family) and the discriminators' forwards and backwards in
    # bf16 on bf16 copies of the fp32 master parameters; the losses and AdamW in fp32.
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    # The waveforms' dtype entering the MR-STFT and mel losses (the generator's input transform stays fp32).
    loss_stft_dtype: str = "float32"  # "float32" | "bfloat16"

    def replace(self, **kw) -> "GANTaskConfig":
        return dataclasses.replace(self, **kw)


def check_trainable(cfg: GANTaskConfig) -> None:
    """Raise for what the port does not train."""
    if cfg.family not in ("gan", "vae", "vqvae", "ssl"):
        raise ValueError(f"unknown task family {cfg.family!r}")
    for field in ("compute_dtype", "loss_stft_dtype"):
        if getattr(cfg, field) not in DTYPES:
            raise ValueError(f"{field} {getattr(cfg, field)!r}: one of {' or '.join(map(repr, DTYPES))}")
    if cfg.generator_name not in TRAINABLE:
        raise NotImplementedError(f"training {cfg.generator_name!r} is not ported; trainable: {list(TRAINABLE)}")


def needs_template(cfg: GANTaskConfig) -> bool:
    """Whether the generator consumes an f0 template waveform: its config's ``use_template`` (a field of
    HiFiGAN's and BigVGAN's, always true for RefineGAN's)."""
    return bool(getattr(cfg.generator, "use_template", False))


@dataclasses.dataclass
class TrainState:
    """Generator, discriminators {mpd, mrd}, their AdamW optimizers, the step, the crop generator
    (``rng``, CPU), the generator's noise generator (``noise``, on the model's device) and, under tensor
    parallelism, the model group over which the modules are sharded."""

    step: int
    generator: nn.Module
    discriminators: nn.ModuleDict
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    rng: torch.Generator
    noise: torch.Generator
    model_group: tp.ModelGroup | None = None

    def state_dict(self) -> dict:
        """Whole tensors: sharded modules' and their moments gathered over the model group, so every rank
        of the group must call."""
        return {"step": self.step, "generator": tp.whole_state_dict(self.generator),
                "discriminators": tp.whole_state_dict(self.discriminators),
                "opt_g": tp.whole_optimizer_state(self.opt_g, self.generator),
                "opt_d": tp.whole_optimizer_state(self.opt_d, self.discriminators),
                "rng": self.rng.get_state(), "noise": self.noise.get_state()}

    def load_state_dict(self, sd: dict, weights_only: bool = False) -> None:
        """Everything, or with ``weights_only`` the generator's and discriminators' weights alone; a
        sharded module takes this rank's shard of them.  A checkpoint without ``noise`` (written
        before the noise generator existed, for a generator that draws none) leaves it as it was seeded."""
        self.generator.load_state_dict(tp.shard_state(self.generator, sd["generator"]))
        self.discriminators.load_state_dict(tp.shard_state(self.discriminators, sd["discriminators"]))
        if not weights_only:
            self.opt_g.load_state_dict(tp.shard_optimizer_state(sd["opt_g"], self.generator))
            self.opt_d.load_state_dict(tp.shard_optimizer_state(sd["opt_d"], self.discriminators))
            self.rng.set_state(sd["rng"])
            if "noise" in sd:
                self.noise.set_state(sd["noise"])
            self.step = int(sd["step"])


def make_optimizer(cfg: GANTaskConfig, params) -> torch.optim.AdamW:
    """AdamW; the step sets its lr from ``warmup_cosine`` before each update."""
    return torch.optim.AdamW(params, lr=warmup_cosine(0, cfg.schedule), betas=(cfg.adam_b1, cfg.adam_b2),
                             eps=cfg.adam_eps, weight_decay=cfg.weight_decay)


def reference_init(generator: nn.Module) -> nn.Module:
    """The reference's ``init_weights`` on the generator, or on its HiFiGAN ``decoder`` or ``head``: the
    upsample, resblock and post convs' directions drawn from normal(0, 0.01), each gain the norm of its
    direction (what weight norm gives a freshly wrapped conv).  conv_pre and the biases keep PyTorch's
    default init."""
    with torch.no_grad():
        for name, m in generator.named_modules():
            parts = name.split(".")
            top = parts[1] if parts[0] in ("decoder", "head") and len(parts) > 1 else parts[0]
            if top in ("ups", "resblocks", "conv_post") and parametrize.is_parametrized(m, "weight"):
                wn = m.parametrizations.weight
                wn.original1.normal_(0.0, 0.01)
                v = wn.original1
                wn.original0.copy_(torch.linalg.vector_norm(v, dim=tuple(range(1, v.dim())), keepdim=True))
    return generator


def model_param_specs(cfg: GANTaskConfig) -> dict | None:
    """The generator's tensor-parallel specs (``parallel/tp_specs.py``; {} where no layer is wide enough to
    shard), or None, and then the storage rule covers it: the "gan" family's models with ``param_specs``, as
    the JAX package's ``model_param_specs``."""
    if cfg.family != "gan":
        return None
    specs = get_generator(cfg.generator_name).param_specs
    return None if specs is None else specs(cfg.generator)


def create_train_state(cfg: GANTaskConfig, seed: int, device, model_group: tp.ModelGroup | None = None,
                       min_size: int = tp.MIN_SIZE) -> TrainState:
    """Modules initialised on the CPU from ``seed`` (the same weights on any device), then moved to
    ``device``; the crop generator (CPU) and the noise generator (on ``device``) seeded with ``seed``.
    ``model_group``: tensor parallelism, this rank's shard of the generator (``model_param_specs``) and its
    storage shards of the rest (tensors of at least ``min_size`` elements, the JAX package's
    ``infer_param_specs`` argument)."""
    check_trainable(cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        generator = reference_init(get_generator(cfg.generator_name).module_cls(cfg.generator))
        discriminators = nn.ModuleDict(
            {"mpd": MultiPeriodDiscriminator(cfg.mpd), "mrd": MultiResolutionDiscriminator(cfg.mrd)})
    specs = model_param_specs(cfg)
    if specs is None:
        tp.storage_shard(generator, model_group, min_size)
    else:
        tp.shard_module(generator, specs, model_group)
    tp.storage_shard(discriminators, model_group, min_size)
    generator.to(device).train()
    discriminators.to(device).train()
    return TrainState(step=0, generator=generator, discriminators=discriminators,
                      opt_g=make_optimizer(cfg, generator.parameters()),
                      opt_d=make_optimizer(cfg, discriminators.parameters()),
                      rng=torch.Generator().manual_seed(seed),
                      noise=torch.Generator(device=device).manual_seed(seed), model_group=model_group)


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) -> (B, 1, T) float mask."""
    idx = torch.arange(max_length, device=lengths.device)[None, :]
    return (idx < lengths[:, None]).float()[:, None, :]


def loss_mel_transform(cfg: GANTaskConfig, audio: torch.Tensor) -> torch.Tensor:
    return log_mel_spectrogram(audio, sample_rate=cfg.sampling_rate, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                               win_length=cfg.win_length, n_mels=cfg.num_mels, f_max=cfg.sampling_rate // 2)


def input_transform(cfg: GANTaskConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, T) -> the generator's input (B, C, frames): the log-mel ("mel") or the linear spectrogram."""
    if cfg.input_transform == "mel":
        return loss_mel_transform(cfg, audio)
    if cfg.input_transform == "linear":
        return linear_spectrogram(audio, n_fft=cfg.n_fft, hop_length=cfg.hop_length, win_length=cfg.win_length)
    raise ValueError(f"unknown input transform {cfg.input_transform!r}")


def _length_fix(fake: torch.Tensor, t_audio: int, hop: int) -> torch.Tensor:
    """A codec's output, within one hop of the audio's length, cut or zero-padded to it."""
    t_f = fake.shape[2]
    if abs(t_f - t_audio) > hop:
        raise ValueError(f"the generator's {t_f} samples are more than a hop ({hop}) from the audio's {t_audio}")
    return fake[:, :, :t_audio] if t_f >= t_audio else torch.nn.functional.pad(fake, (0, t_audio - t_f))


def compute_dtype(cfg: GANTaskConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def _to_float(tree):
    """Every tensor of a nested list/tuple of discriminator outputs, cast to fp32."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_float(t) for t in tree)
    return tree.float()


def generator_forward(generator: nn.Module, audio: torch.Tensor, cfg: GANTaskConfig, plain: bool = False,
                      template: torch.Tensor | None = None, noise: torch.Generator | None = None,
                      features: torch.Tensor | None = None):
    """audio (B, 1, T) [+ template (B, 1, T)] [+ the ssl family's HuBERT features (B, T', hidden)] -> (fake
    (B, 1, T) fp32, base loss, the family's metrics, the EMA update to call after the backward or None).
    Training or not is the generator's mode.  ``plain``: through the kernels' plain versions
    (``forward_plain``, where the generator has kernels), as the card checks compare.  ``noise``: the noise
    generator of a generator that ``draws_noise`` (RefineGAN's AdaIN, None: the seeded-0 default;
    ConvNeXt's drop_path and the vae's eps in training).  Under
    ``compute_dtype="bfloat16"`` the "gan" family's generator runs on bf16 copies of its parameters with
    the spectrum and template in bf16 (the vae, vqvae and ssl generators stay fp32, as the JAX package's)."""
    zero = torch.zeros((), device=audio.device)
    if cfg.family == "ssl" and features is None:
        raise ValueError("the ssl family needs the frozen backbone's features in the batch (batch['ssl_features'], "
                         "which the trainer makes with a HubertFeatureExtractor)")
    spec = features if cfg.family == "ssl" else input_transform(cfg, audio[:, 0, :])
    if cfg.family == "vae":
        fake, mean, logvar = generator(spec, noise=noise)
        kl = 0.5 * dist.mean_share(torch.square(mean) + torch.exp(logvar) - logvar - 1.0)
        return fake.float(), kl, {"train/generator/kl": kl}, None
    if cfg.family in ("vqvae", "ssl"):
        fake, latent, codes, vq_loss = generator(spec)

        def ema():
            with tp.gathered(generator, "vq."):  # storage shards: the whole codebooks, this rank's slice written
                generator.vq.ema_update(latent, codes)

        ema = ema if generator.training else None
        return _length_fix(fake, audio.shape[2], cfg.hop_length).float(), zero, {"train/generator/vq": vq_loss}, ema
    forward = generator.forward_plain if plain and hasattr(generator, "forward_plain") else generator
    dtype = compute_dtype(cfg)
    kw = {}
    if needs_template(cfg):
        if template is None:
            raise ValueError(f"{cfg.generator_name} needs an f0 template waveform in the batch "
                             "(batch['template'], which the trainer builds when needs_template(cfg))")
        kw["template"] = template.to(dtype)
    if getattr(generator, "draws_noise", False):
        kw["noise"] = noise
    with cast_parameters(generator, dtype):
        return forward(spec.to(dtype), **kw).float(), zero, {}, None


def _discriminators(discriminators: nn.ModuleDict, audio: torch.Tensor, cfg: GANTaskConfig) -> dict:
    """{key: (scores, feature maps)} of each discriminator, fp32; in ``compute_dtype`` inside."""
    dtype = compute_dtype(cfg)
    with span("discriminators"), cast_parameters(discriminators, dtype):
        outs = {key: d(audio.to(dtype)) for key, d in discriminators.items()}
    return outs if dtype == torch.float32 else {key: _to_float(o) for key, o in outs.items()}


def draw_crop_start(state: TrainState, cfg: GANTaskConfig, t: int) -> int | None:
    """The discriminators' random crop start for T-sample audio, from the state's generator; None
    when the audio is not longer than the crop."""
    if cfg.crop_length is None or t <= cfg.crop_length:
        return None
    return int(torch.randint(0, t - cfg.crop_length, (), generator=state.rng))


def _generator_loss(generator, discriminators, audio, mask, cfg: GANTaskConfig, start: int | None,
                    plain: bool = False, template=None, noise=None, features=None):
    """(loss, metrics, audio_c, fake_c, ema): the generator loss, the crops the discriminators see, and
    the EMA update to call after the backward (or None)."""
    with span("train.g.forward"):
        fake, base, fwd_metrics, ema = generator_forward(generator, audio, cfg, plain, template, noise, features)
    if fake.shape != audio.shape:
        raise ValueError(f"generator output {tuple(fake.shape)} does not match the audio {tuple(audio.shape)}")
    with span("train.g.loss"):
        loss, metrics, audio_c, fake_c = _generator_loss_terms(discriminators, audio, fake, base, fwd_metrics, mask,
                                                               cfg, start)
    return loss, metrics, audio_c, fake_c, ema


def _generator_loss_terms(discriminators, audio, fake, base, fwd_metrics, mask, cfg: GANTaskConfig,
                          start: int | None):
    """(loss, metrics, audio_c, fake_c) of the generator's output: the MR-STFT and mel losses, the
    discriminators on the fake and real crops, and the adversarial and feature-matching losses."""
    audio_m, fake_m = audio * mask, fake * mask
    loss_dtype = DTYPES[cfg.loss_stft_dtype]
    audio_l, fake_l = audio_m[:, 0].to(loss_dtype), fake_m[:, 0].to(loss_dtype)
    with span("mr_stft_loss"):
        sc_loss, mag_loss = multi_resolution_stft_loss(fake_l, audio_l, cfg.stft_resolutions)
    loss_stft = sc_loss + mag_loss
    loss_mel = dist.mean_share(torch.abs(loss_mel_transform(cfg, audio_l).float()
                                         - loss_mel_transform(cfg, fake_l).float()))

    if start is None:
        audio_c, fake_c = audio_m, fake_m
    else:
        audio_c = audio_m[..., start : start + cfg.crop_length]
        fake_c = fake_m[..., start : start + cfg.crop_length]

    metrics = dict(fwd_metrics)
    loss_adv_all = 0.0
    discriminators.requires_grad_(False)  # no G-phase gradient reaches D's .grad
    try:
        fake_outs = _discriminators(discriminators, fake_c, cfg)
        with torch.no_grad():  # the real audio does not depend on G
            real_outs = _discriminators(discriminators, audio_c, cfg)
    finally:
        discriminators.requires_grad_(True)
    for key, (score_fakes, feat_fake) in fake_outs.items():
        loss_fake = generator_adversarial_loss(score_fakes)
        loss_fm = feature_matching_loss(real_outs[key][1], feat_fake)
        metrics[f"train/generator/adv_{key}"] = loss_fake
        metrics[f"train/generator/adv_fm_{key}"] = loss_fm
        loss_adv_all = loss_adv_all + loss_fake + loss_fm
    loss_adv_all = loss_adv_all / len(fake_outs)

    loss = base + loss_stft * cfg.stft_weight + loss_mel * cfg.mel_weight + loss_adv_all
    metrics.update({"train/generator/stft": loss_stft, "train/generator/mel": loss_mel,
                    "train/generator/base": base, "train/generator/all": loss})
    return loss, metrics, audio_c, fake_c


def _discriminator_loss(discriminators, audio_c, fake_c, cfg: GANTaskConfig):
    real_outs = _discriminators(discriminators, audio_c, cfg)
    fake_outs = _discriminators(discriminators, fake_c.detach(), cfg)
    metrics = {f"train/discriminator/{key}": discriminator_loss(real_outs[key][0], fake_outs[key][0])
               for key in real_outs}
    loss = sum(metrics.values()) / len(real_outs)
    metrics["train/discriminator/all"] = loss
    return loss, metrics


def _global_values(metrics: dict) -> dict:
    """The ranks' shares of each logged loss summed: the global batch's values (as they are, outside a
    data-parallel group).  One all-reduce."""
    if not dist.active():
        return metrics
    total = dist.all_reduce_sum(torch.stack([v.detach().float() for v in metrics.values()]))
    return dict(zip(metrics, total.unbind()))


def make_train_step(cfg: GANTaskConfig, plain: bool = False, group=None):
    """(state, batch, crop_start=None) -> metrics; updates ``state`` in place.

    ``batch``: {"audio": (B, 1, T), "lengths": (B,)[, "template": (B, 1, T)][, "ssl_features": (B, T',
    hidden)]} on the state's device.
    The generator
    step (``step.g_phase``), then the discriminator step (``step.d_phase``) on the pre-update
    generator's fake; the crop start is drawn from ``state.rng`` unless given.  The phases are
    exposed so that a measurement times the code the step runs.  ``plain`` runs the generator
    through its kernels' plain versions (what the card checks hold the kernel path against).
    ``group``: a process group whose ranks each pass their share of the global batch (equal shares, in
    rank order) and a state of the same weights (``dist.broadcast_modules``); the step is then the
    global batch's on every rank, metrics included.  None: one process.  Under tensor parallelism it is
    the data group of the grid, and the state's generator is sharded over the model group."""
    check_trainable(cfg)

    def g_phase(state: TrainState, batch: dict, crop_start: int | None = None):
        """The generator's loss, backward and AdamW update, then a vqvae's or ssl's EMA codebook update:
        (metrics, audio_c, fake_c)."""
        audio, lengths = batch["audio"], batch["lengths"]
        mask = sequence_mask(lengths, audio.shape[2])
        start = draw_crop_start(state, cfg, audio.shape[2]) if crop_start is None else crop_start
        state.opt_g.zero_grad(set_to_none=True)
        with dist.data_parallel(group):
            loss, metrics, audio_c, fake_c, ema = _generator_loss(
                state.generator, state.discriminators, audio, mask, cfg, start, plain, batch.get("template"),
                state.noise, batch.get("ssl_features"))
            with span("train.g.backward"):
                loss.backward()
            with span("train.g.update"):
                dist.all_reduce_grads(state.generator.parameters())
                tp.average_replicated_grads(state.generator, state.model_group)
                metrics = _global_values(metrics)
                metrics["train/generator/grad_norm"] = tp.grad_norm(state.generator)
                for param_group in state.opt_g.param_groups:
                    param_group["lr"] = warmup_cosine(state.step, cfg.schedule)
                state.opt_g.step()
                if ema is not None:
                    ema()
        return metrics, audio_c, fake_c

    def d_phase(state: TrainState, audio_c: torch.Tensor, fake_c: torch.Tensor) -> dict:
        """The discriminators' loss, backward and AdamW update on the crops; advances the step."""
        state.opt_d.zero_grad(set_to_none=True)
        with dist.data_parallel(group):
            with span("train.d.loss"):
                loss, metrics = _discriminator_loss(state.discriminators, audio_c, fake_c, cfg)
            with span("train.d.backward"):
                loss.backward()
            with span("train.d.update"):
                dist.all_reduce_grads(state.discriminators.parameters())
                tp.average_replicated_grads(state.discriminators, state.model_group)
                metrics = _global_values(metrics)
                for key, d in state.discriminators.items():
                    metrics[f"train/discriminator/grad_norm_{key}"] = tp.grad_norm(d)
                for param_group in state.opt_d.param_groups:
                    param_group["lr"] = warmup_cosine(state.step, cfg.schedule)
                state.opt_d.step()
        state.step += 1
        return metrics

    def step(state: TrainState, batch: dict, crop_start: int | None = None) -> dict:
        lr = warmup_cosine(state.step, cfg.schedule)
        metrics, audio_c, fake_c = g_phase(state, batch, crop_start)
        metrics.update(d_phase(state, audio_c, fake_c))
        return {**{k: v.detach() for k, v in metrics.items()}, "lr": lr}

    step.g_phase, step.d_phase = g_phase, d_phase
    return step


def _eval_dtype(cfg: GANTaskConfig) -> torch.dtype | None:
    """The dtype of the generator's eval copy: bf16 compute's for a "gan" family generator, else None (no copy)."""
    dtype = compute_dtype(cfg)
    return dtype if cfg.family == "gan" and dtype != torch.float32 else None


def eval_generator(generator: nn.Module, cfg: GANTaskConfig) -> nn.Module:
    """The module an eval forward runs: the generator itself, or under bf16 compute a fresh bf16 copy of
    a "gan" family generator (``nn.cast_copy``)."""
    dtype = _eval_dtype(cfg)
    return generator if dtype is None else cast_copy(generator, dtype)


eval_copies = WeightCache()  # the generator -> its bf16 eval copy


def make_eval_step(cfg: GANTaskConfig):
    """(state, batch) -> ({"val/metrics/mel": masked mel-L1 on the full clip}, masked fake): the
    generator in eval mode under ``torch.no_grad`` (BigVGAN: the inference path, K2 and K1; RefineGAN:
    the seeded-0 noise of inference; vae: z = mean; vqvae and ssl: the codebooks as they are), in bf16 under bf16
    compute (``eval_generator``).  The bf16 copy is kept in ``eval_copies`` by the rule of
    ``utils/weight_cache.py``, so the batches of one validation share one copy and K2 packs its weights once."""
    dtype = _eval_dtype(cfg)

    def eval_module(state: TrainState) -> nn.Module:
        gen = state.generator
        return gen if dtype is None else eval_copies.get(gen, (gen,), lambda: eval_generator(gen, cfg), dtype)

    def step(state: TrainState, batch: dict):
        audio, lengths = batch["audio"], batch["lengths"]
        mask = sequence_mask(lengths, audio.shape[2])
        generator = eval_module(state)
        generator.eval()
        try:
            with torch.no_grad():
                fake = generator_forward(generator, audio, cfg, template=batch.get("template"),
                                         features=batch.get("ssl_features"))[0]
                audio_m, fake_m = audio * mask, fake * mask
                loss_mel = torch.mean(torch.abs(loss_mel_transform(cfg, audio_m[:, 0])
                                                - loss_mel_transform(cfg, fake_m[:, 0])))
        finally:
            state.generator.train()
        return {"val/metrics/mel": loss_mel}, fake_m

    return step
