"""One training step of the vae, vqvae, Vocos and Firefly-GAN families against the JAX package's
``make_train_step``, on the CPU, and the eval step after it.

The tiny task of ``tests/test_torch_train.py`` (8 kHz, hop 4, n_fft 16, two MPD periods, two MRD and
MR-STFT resolutions, 128-sample clips, the second 17 samples short, a 32-sample crop whose start is the
JAX program's), each family's generator at widths of 16 or less, from the port's random weights
(``random_state_dict``: layer scales of 0.1, so every ConvNeXt block adds to its residual) bridged into
JAX by its own ``from_torch_state_dict``.  ``jax.random`` cannot be reproduced, so both packages' draws
are made the same numpy arrays inside the test: the JAX package's ``vocoder_tpu.nn.drop_path`` and the
port's (``models/convnext.py::drop_path``) multiply by one keep-mask per block, keyed by the block's
rate (the rates differ block to block), and the vae's ``jax.random.normal`` and the port's
``normal_like`` return one eps per shape.  Blocks of both samples kept and of one dropped both occur.
Compared as ``tests/test_torch_train.py`` compares (rtol 2e-4 / atol 2e-5, the JAX kernel tests'
tolerance; gradients within 2e-4 of each tensor's largest element; updated parameters under Adam's
sign caveat), plus the vqvae's EMA codebooks after the step, and the eval step on the weights and
codebooks the port step left.  One family a test keeps each JAX compile apart; Vocos and Firefly-GAN
run from ``tests/test_torch_drop_path_train.py``, so that each file stays within a minute on one worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import ATOL, COMMON, HOP, RES, RTOL, _assert_adam_updates_close, _assert_trees_close, _batch
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu import nn as jnn
from vocoder_tpu.models import convnext as jconvnext
from vocoder_tpu.models import firefly as jfirefly
from vocoder_tpu.models import hifigan as jhifigan
from vocoder_tpu.models import mpd as jmpd
from vocoder_tpu.models import mrd as jmrd
from vocoder_tpu.models import vae as jvae
from vocoder_tpu.models import vocos as jvocos
from vocoder_tpu.models import vq as jvq
from vocoder_tpu.models import wavenet as jwavenet
from vocoder_tpu.train import gan as jgan
from vocoder_tpu.train.schedule import WarmupCosineConfig as JWarmupCosine
from vocoder_tpu_torch.models import convnext, firefly, hifigan, mpd, mrd, vae, vocos, vq, wavenet
from vocoder_tpu_torch.train import gan
from vocoder_tpu_torch.train.schedule import WarmupCosineConfig

JAX_MODS = dict(convnext=jconvnext, hifigan=jhifigan, wavenet=jwavenet, vq=jvq, vae=jvae, vocos=jvocos,
                firefly=jfirefly)
PORT_MODS = dict(convnext=convnext, hifigan=hifigan, wavenet=wavenet, vq=vq, vae=vae, vocos=vocos, firefly=firefly)
BINS = COMMON["n_fft"] // 2 + 1
DEC = dict(hop_length=HOP, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 2),), upsample_initial_channel=16)
FAMILY = {"vae": "vae", "vqvae": "vqvae", "vocos": "gan", "firefly_gan_base": "gan"}


def generator_config(name: str, m: dict):
    """The tiny generator config of ``name`` from one package's modules ``m``."""
    if name == "vae":
        return m["vae"].VAEGeneratorConfig(
            latent_size=6, encoder_kind="convnext",
            encoder=m["convnext"].ConvNeXtConfig(input_channels=BINS, depths=(1, 1), dims=(8, 12), drop_path_rate=0.2),
            decoder=m["hifigan"].HiFiGANConfig(num_mels=6, **DEC))
    if name == "vqvae":
        return m["vae"].VQVAEGeneratorConfig(
            latent_size=6,
            encoder=m["wavenet"].PosteriorEncoderConfig(in_channels=BINS, out_channels=6, hidden_channels=8,
                                                        kernel_size=3, n_layers=2),
            decoder=m["hifigan"].HiFiGANConfig(num_mels=6, **DEC), vq=m["vq"].VQConfig(dim=6, codebook_size=16))
    backbone = m["convnext"].ConvNeXtConfig(input_channels=8, depths=(2, 2), dims=(8, 16), drop_path_rate=0.5)
    if name == "vocos":
        return m["vocos"].VocosConfig(backbone=backbone, head=m["vocos"].ISTFTHeadConfig(
            dim=16, n_fft=16, hop_length=HOP, win_length=16))
    return m["firefly"].FireflyConfig(backbone=backbone, head=m["hifigan"].HiFiGANConfig(
        num_mels=16, pre_conv_kernel_size=13, post_conv_kernel_size=13, **DEC))


def task_configs(name: str):
    family = FAMILY[name]
    kw = dict(COMMON, generator_name=name, crop_length=HOP * 8, family=family,
              input_transform="mel" if family == "gan" else "linear")
    jcfg = jgan.GANTaskConfig(generator=generator_config(name, JAX_MODS),
                              mpd=jmpd.MPDConfig(periods=(2, 3), channels=(1, 4, 8)),
                              mrd=jmrd.MRDConfig(resolutions=RES),
                              schedule=JWarmupCosine(val_base=2e-4, max_decay_steps=1000), **kw)
    tcfg = gan.GANTaskConfig(generator=generator_config(name, PORT_MODS),
                             mpd=mpd.MPDConfig(periods=(2, 3), channels=(1, 4, 8)), mrd=mrd.MRDConfig(resolutions=RES),
                             schedule=WarmupCosineConfig(val_base=2e-4, max_decay_steps=1000), **kw)
    return jcfg, tcfg


def random_weights(name: str, cfg) -> dict[str, torch.Tensor]:
    return {"vae": vae.vae_random_state_dict, "vqvae": vae.vqvae_random_state_dict,
            "vocos": vocos.random_state_dict, "firefly_gan_base": firefly.random_state_dict}[name](cfg, 0)


def generator_to_jax(name: str, jgen, sd: dict):
    """A port generator's state_dict (or its gradients by name) -> the JAX parameter tree."""
    if name in ("vae", "vqvae"):
        enc = (jconvnext.from_torch_state_dict(sd, jgen.encoder, "encoder.") if name == "vae"
               else jwavenet.from_torch_state_dict(sd, jgen.encoder, "encoder."))
        return {"encoder": enc, "decoder": jhifigan.from_torch_state_dict(sd, jgen.decoder, "decoder.")}
    return {"vocos": jvocos, "firefly_gan_base": jfirefly}[name].from_torch_state_dict(sd, jgen)


def vq_to_jax(sd: dict, n: int) -> dict:
    """The port's codebook buffers -> the JAX package's EMA VQ state."""
    keys = ("embed", "embed_avg", "cluster_size")
    return {"layers": [{k: jnp.asarray(sd[f"vq.layers.{i}.{k}"].numpy()) for k in keys} for i in range(n)]}


def discriminators_to_jax(jcfg, sd: dict) -> dict:
    return {"mpd": jmpd.from_torch_state_dict(sd, jcfg.mpd, prefix="mpd."),
            "mrd": jmrd.from_torch_state_dict(sd, jcfg.mrd, prefix="mrd.")}


@pytest.fixture
def equal_draws(monkeypatch):
    """Both packages' drop_path keep-masks (``draws["masks"]``, rate -> (B,) mask, filled by the test) and
    normal draws (one numpy array per shape, made on first use) the same."""
    draws = {"masks": {}, "eps": {}, "dropped": {"jax": 0, "port": 0}}

    def eps(shape: tuple) -> np.ndarray:
        if shape not in draws["eps"]:
            draws["eps"][shape] = np.random.default_rng(5 + len(draws["eps"])).standard_normal(shape).astype(np.float32)
        return draws["eps"][shape]

    def jax_drop(key, x, p, training):
        if p == 0.0 or not training:
            return x
        draws["dropped"]["jax"] += int((draws["masks"][p] == 0).sum())
        return x * jnp.asarray(draws["masks"][p]).reshape((-1,) + (1,) * (x.ndim - 1)) / (1.0 - p)

    def port_drop(x, p, training, generator):
        if p == 0.0 or not training:
            return x
        draws["dropped"]["port"] += int((draws["masks"][p] == 0).sum())
        return x * torch.from_numpy(draws["masks"][p]).reshape((-1,) + (1,) * (x.dim() - 1)) / (1.0 - p)

    monkeypatch.setattr(jnn, "drop_path", jax_drop)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(eps(tuple(shape)), dtype))
    monkeypatch.setattr(convnext, "drop_path", port_drop)
    monkeypatch.setattr(vae, "normal_like", lambda x, generator: torch.from_numpy(eps(tuple(x.shape))))
    return draws


def keep_masks(cfg, batch: int) -> dict[float, np.ndarray]:
    """A (batch,) keep-mask for each block of a ConvNeXt config with a nonzero rate; some block keeps every
    sample and some drops one."""
    rates = [r for stage in jconvnext._drop_rates(cfg) for r in stage if r > 0]
    masks = {r: np.ones(batch, np.float32) for r in rates}
    for i, r in enumerate(rates):
        if i % 2:
            masks[r][i % batch] = 0.0
    return masks


@pytest.mark.parametrize("name", ["vae", "vqvae"])
def test_family_train_step_matches_jax(name, equal_draws):
    """Vocos and Firefly-GAN: tests/test_torch_drop_path_train.py."""
    check_family_train_step(name, equal_draws)


def check_family_train_step(name: str, equal_draws: dict):
    jcfg, tcfg = task_configs(name)
    state = gan.create_train_state(tcfg, 0, "cpu")
    state.generator.load_state_dict(random_weights(name, tcfg.generator))
    if name in ("vocos", "firefly_gan_base"):
        equal_draws["masks"] = keep_masks(tcfg.generator.backbone, 2)
    gen0 = {k: v.clone() for k, v in state.generator.state_dict().items()}
    disc0 = {k: v.clone() for k, v in state.discriminators.state_dict().items()}
    gp, dp = generator_to_jax(name, jcfg.generator, gen0), discriminators_to_jax(jcfg, disc0)
    extra = {"vq": vq_to_jax(gen0, 1)} if name == "vqvae" else None
    tx = jgan.make_optimizer(jcfg)
    key = jax.random.key(3)
    jstate = jgan.TrainState(step=jnp.zeros((), jnp.int32), gen_params=gp, disc_params=dp, opt_g=tx.init(gp),
                             opt_d=tx.init(dp), rng=key, extra=extra)
    batch = _batch(tcfg)
    t = batch["audio"].shape[2]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, step_rng = jax.random.split(key)
    r_crop, _ = jax.random.split(step_rng)
    start = int(jax.random.randint(r_crop, (), 0, t - jcfg.crop_length))

    @jax.jit
    def jax_step(jstate, jbatch):
        mask = jgan.sequence_mask(jbatch["lengths"], t)
        (_, (_, audio_c, fake_c, _)), grads_g = jax.value_and_grad(jgan._generator_loss, has_aux=True)(
            jstate.gen_params, jstate.disc_params, jbatch["audio"], mask, jcfg, step_rng, jstate.extra)
        grads_d, _ = jax.grad(jgan._discriminator_loss_fn, has_aux=True)(jstate.disc_params, audio_c, fake_c, jcfg)
        return jgan.make_train_step(jcfg)(jstate, jbatch), grads_g, grads_d

    (new_jstate, jmetrics), jgrads_g, jgrads_d = jax_step(jstate, jbatch)
    metrics = gan.make_train_step(tcfg)(state, {k: torch.from_numpy(v) for k, v in batch.items()}, start)
    assert state.step == 1 and set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    # Vocos and Firefly-GAN dropped a sample in some block on both sides (JAX traced its step twice); the vae's
    # ConvNeXt drops none in either package (JAX's vae_encode runs it without its training flag).
    dropped = equal_draws["dropped"]
    assert (dropped["port"] > 0 and dropped["jax"] == 2 * dropped["port"]) if FAMILY[name] == "gan" else dropped == {
        "jax": 0, "port": 0}
    if name == "vae":
        assert float(metrics["train/generator/kl"]) > 0 and equal_draws["eps"]
    if name == "vqvae":
        assert float(metrics["train/generator/vq"]) > 0 and float(metrics["train/generator/base"]) == 0.0

    grads_g = generator_to_jax(name, jcfg.generator, {n: p.grad for n, p in state.generator.named_parameters()})
    grads_d = discriminators_to_jax(jcfg, {n: p.grad for n, p in state.discriminators.named_parameters()})
    _assert_trees_close(grads_g, jgrads_g, "generator gradient")
    _assert_trees_close(grads_d, jgrads_d, "discriminator gradient")

    new_sd = state.generator.state_dict()
    new_g = generator_to_jax(name, jcfg.generator, new_sd)
    new_d = discriminators_to_jax(jcfg, state.discriminators.state_dict())
    lr = float(jmetrics["lr"])
    for new, old, want, grads, jgrads in ((new_g, gp, new_jstate.gen_params, grads_g, jgrads_g),
                                          (new_d, dp, new_jstate.disc_params, grads_d, jgrads_d)):
        err = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()), grads, jgrads)
        _assert_adam_updates_close(new, old, want, jgrads, err, lr, tcfg.weight_decay)
    if name == "vqvae":
        got = vq_to_jax(new_sd, 1)
        assert not np.array_equal(np.asarray(got["layers"][0]["embed"]), np.asarray(extra["vq"]["layers"][0]["embed"]))
        _assert_trees_close(got, new_jstate.extra["vq"], "EMA codebook")

    # The eval step on what the port step left (vae: z = mean; vqvae: the updated codebooks, frozen).
    jeval = jgan.TrainState(step=jnp.ones((), jnp.int32), gen_params=new_g, disc_params=new_d, opt_g=None, opt_d=None,
                            rng=jax.random.key(0), extra={"vq": vq_to_jax(new_sd, 1)} if name == "vqvae" else None)
    jm, jfake = jax.jit(jgan.make_eval_step(jcfg))(jeval, jbatch)
    em, fake = gan.make_eval_step(tcfg)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(em["val/metrics/mel"]), float(jm["val/metrics/mel"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fake.numpy(), np.asarray(jfake), rtol=RTOL, atol=ATOL)
    assert all(torch.equal(new_sd[k], v) for k, v in state.generator.state_dict().items())  # eval moved nothing
