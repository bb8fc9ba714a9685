"""One port training step against the JAX package's ``make_train_step``, on the CPU.

``check_train_step`` is shared with ``tests/test_torch_train_bigvgan.py`` and
``tests/test_torch_template_train.py`` (RefineGAN, whose batch carries an f0 template; one file a
model keeps each file's JAX compiles within a minute on one worker).  The tiny HiFiGAN task of ``tests/test_gan_step.py`` and a tiny BigVGAN on the same task, from the
same weights (the port's, bridged into JAX by its ``from_torch_state_dict``) and the same batch, with
the JAX program's crop start passed to the port (drawn from ``state.rng`` as ``make_train_step``
splits it), and without a crop.  Compared: every metric (rtol 2e-4, atol 2e-5, the JAX kernel tests'
tolerance), every generator and discriminator gradient (the JAX gradients from ``jax.value_and_grad``
of the functions the JAX step differentiates; each tensor within 2e-4 of its largest element), and
the updated parameters.  ``check_eval_step``: the validation step on the weights a port train step
left (AdamW updates the weight-norm parameters in place), held to JAX's on the same weights.

Adam's first step moves each parameter by lr * g / (|g| + eps), about lr * sign(g): where a gradient
is near 0, a rounding difference can flip that sign.  So an updated parameter's step is held to rtol 2e-4
where its JAX gradient lies well clear of 0 (more than 100 times the larger of the tensor's gradient
difference and eps), and elsewhere only to the bound of any Adam step: 2 lr plus the weight decay's
lr * wd * |p|.  Both allow two fp32 ulps of the parameter, the rounding of p - step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu.models import bigvgan as jbigvgan
from vocoder_tpu.models import hifigan as jhifigan
from vocoder_tpu.models import mpd as jmpd
from vocoder_tpu.models import mrd as jmrd
from vocoder_tpu.models import refinegan as jrefinegan
from vocoder_tpu.train import gan as jgan
from vocoder_tpu.train.schedule import WarmupCosineConfig as JWarmupCosine
from vocoder_tpu_torch.data.f0 import template_from_f0
from vocoder_tpu_torch.models import bigvgan, hifigan, mpd, mrd, refinegan
from vocoder_tpu_torch.train import gan
from vocoder_tpu_torch.train.schedule import WarmupCosineConfig

RTOL, ATOL = 2e-4, 2e-5
HOP = 4
GEN = dict(hop_length=HOP, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 2),), num_mels=8, upsample_initial_channel=16)
RES = ((16, 4, 16), (32, 8, 32))
COMMON = dict(sampling_rate=8000, n_fft=16, hop_length=HOP, win_length=16, num_mels=8, stft_resolutions=RES,
              num_frames=32)
# RefineGAN (tests/test_torch_template_train.py): a two-stage UNet at the same hop, fed an f0 template.
REFINE = dict(sampling_rate=8000, hop_length=HOP, downsample_rates=(2, 2), upsample_rates=(2, 2), num_mels=8,
              start_channels=4)
MODELS = {"hifigan": (jhifigan, jhifigan.HiFiGANConfig, hifigan.HiFiGANConfig, GEN),
          "bigvgan": (jbigvgan, jbigvgan.BigVGANConfig, bigvgan.BigVGANConfig, GEN),
          "refinegan": (jrefinegan, jrefinegan.RefineGANConfig, refinegan.RefineGANConfig, REFINE)}


def _configs(name: str, crop: bool):
    jmod, jgen, tgen, kw = MODELS[name]
    crop_length = HOP * 8 if crop else None
    jcfg = jgan.GANTaskConfig(generator_name=name, generator=jgen(**kw), crop_length=crop_length,
                              mpd=jmpd.MPDConfig(periods=(2, 3), channels=(1, 4, 8)), mrd=jmrd.MRDConfig(resolutions=RES),
                              schedule=JWarmupCosine(val_base=2e-4, max_decay_steps=1000), **COMMON)
    tcfg = gan.GANTaskConfig(generator_name=name, generator=tgen(**kw), crop_length=crop_length,
                             mpd=mpd.MPDConfig(periods=(2, 3), channels=(1, 4, 8)), mrd=mrd.MRDConfig(resolutions=RES),
                             schedule=WarmupCosineConfig(val_base=2e-4, max_decay_steps=1000), **COMMON)
    return jmod, jcfg, tcfg


def _to_jax(jmod, jcfg, gen_sd: dict, disc_sd: dict):
    """A port (generator, discriminators) state_dict-like dict -> the JAX parameter trees."""
    return (jmod.from_torch_state_dict(gen_sd, jcfg.generator),
            {"mpd": jmpd.from_torch_state_dict(disc_sd, jcfg.mpd, prefix="mpd."),
             "mrd": jmrd.from_torch_state_dict(disc_sd, jcfg.mrd, prefix="mrd.")})


def _assert_trees_close(got, want, what: str):
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale, err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _assert_adam_updates_close(new, old, want_new, grads, grad_err, lr, wd):
    """Updated parameters under the Adam-sign caveat of the module docstring."""
    for (path, n), o, w, g, e in zip(jax.tree_util.tree_leaves_with_path(new), jax.tree.leaves(old),
                                     jax.tree.leaves(want_new), jax.tree.leaves(grads), jax.tree.leaves(grad_err)):
        n, o, w, g = (np.asarray(a, np.float64) for a in (n, o, w, g))
        clear = np.abs(g) > 100 * max(float(e), 1e-6)
        step_got, step_want = n - o, w - o
        key = jax.tree_util.keystr(path)
        diff = np.abs(step_got - step_want)
        ulps = 2 * np.spacing(np.abs(o).astype(np.float32)).astype(np.float64)  # fp32 rounding of p - lr * ...
        assert np.all(diff[clear] <= RTOL * np.abs(step_want[clear]) + ulps[clear]), key
        assert np.all(diff[~clear] <= 2 * lr + lr * wd * np.abs(o[~clear]) + ulps[~clear]), key


def _batch(tcfg) -> dict:
    """Two clips of noise, the second 17 samples shorter: {audio (2, 1, T), lengths (2,)}, and for a
    generator that consumes one, a template (2, 1, T) of two sines (300 and 410 Hz), numpy."""
    t = HOP * tcfg.num_frames
    audio = (0.3 * np.random.default_rng(0).standard_normal((2, 1, t))).astype(np.float32)
    batch = {"audio": audio, "lengths": np.asarray([t, t - 17])}
    if gan.needs_template(tcfg):
        batch["template"] = np.stack([template_from_f0(np.full(tcfg.num_frames, f), tcfg.sampling_rate, HOP)
                                      for f in (300.0, 410.0)])[:, None, :]
    return batch


@pytest.mark.parametrize("crop", [True, False])
def test_train_step_matches_jax(crop):
    """HiFiGAN, the JAX package's default generator (BigVGAN: tests/test_torch_train_bigvgan.py)."""
    check_train_step("hifigan", crop)


def check_train_step(name: str, crop: bool):
    jmod, jcfg, tcfg = _configs(name, crop)
    state = gan.create_train_state(tcfg, 0, "cpu")
    gen0 = {k: v.clone() for k, v in state.generator.state_dict().items()}
    disc0 = {k: v.clone() for k, v in state.discriminators.state_dict().items()}
    gp, dp = _to_jax(jmod, jcfg, gen0, disc0)
    tx = jgan.make_optimizer(jcfg)
    key = jax.random.key(3)
    jstate = jgan.TrainState(step=jnp.zeros((), jnp.int32), gen_params=gp, disc_params=dp, opt_g=tx.init(gp),
                             opt_d=tx.init(dp), rng=key)

    batch = _batch(tcfg)
    t = batch["audio"].shape[2]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # The JAX step's crop start: make_train_step splits state.rng, then _generator_loss splits the step key.
    _, step_rng = jax.random.split(key)
    r_crop, _ = jax.random.split(step_rng)
    start = int(jax.random.randint(r_crop, (), 0, t - jcfg.crop_length)) if crop else None

    @jax.jit
    def jax_step(jstate, jbatch):
        """The JAX step, and the gradients of the two functions it differentiates, in one program."""
        mask = jgan.sequence_mask(jbatch["lengths"], t)
        (_, (_, audio_c, fake_c, _)), grads_g = jax.value_and_grad(jgan._generator_loss, has_aux=True)(
            jstate.gen_params, jstate.disc_params, jbatch["audio"], mask, jcfg, step_rng, None, jbatch.get("template"))
        grads_d, _ = jax.grad(jgan._discriminator_loss_fn, has_aux=True)(jstate.disc_params, audio_c, fake_c, jcfg)
        return jgan.make_train_step(jcfg)(jstate, jbatch), grads_g, grads_d

    (new_jstate, jmetrics), jgrads_g, jgrads_d = jax_step(jstate, jbatch)

    metrics = gan.make_train_step(tcfg)(state, {k: torch.from_numpy(v) for k, v in batch.items()}, start)
    assert state.step == 1 and set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=RTOL, atol=ATOL, err_msg=k)

    grads_g, grads_d = _to_jax(jmod, jcfg, {n: p.grad for n, p in state.generator.named_parameters()},
                               {n: p.grad for n, p in state.discriminators.named_parameters()})
    _assert_trees_close(grads_g, jgrads_g, "generator gradient")
    _assert_trees_close(grads_d, jgrads_d, "discriminator gradient")

    new_g, new_d = _to_jax(jmod, jcfg, state.generator.state_dict(), state.discriminators.state_dict())
    lr = float(jmetrics["lr"])
    for new, old, want, grads, jgrads in ((new_g, gp, new_jstate.gen_params, grads_g, jgrads_g),
                                          (new_d, dp, new_jstate.disc_params, grads_d, jgrads_d)):
        err = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()), grads, jgrads)
        _assert_adam_updates_close(new, old, want, jgrads, err, lr, tcfg.weight_decay)


def test_eval_step_matches_jax():
    check_eval_step("hifigan")


def check_eval_step(name: str):
    """The port's ``make_eval_step`` after one port train step, against JAX's ``make_eval_step`` on the
    weights that step left, bridged: the val mel-L1 and the masked fake within rtol 2e-4 / atol 2e-5."""
    jmod, jcfg, tcfg = _configs(name, True)
    state = gan.create_train_state(tcfg, 0, "cpu")
    np_batch = _batch(tcfg)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    eval_step = gan.make_eval_step(tcfg)
    _, before = eval_step(state, batch)
    gan.make_train_step(tcfg)(state, batch)
    metrics, fake = eval_step(state, batch)
    assert state.generator.training and not torch.equal(fake, before)

    gp, dp = _to_jax(jmod, jcfg, state.generator.state_dict(), state.discriminators.state_dict())
    jstate = jgan.TrainState(step=jnp.ones((), jnp.int32), gen_params=gp, disc_params=dp, opt_g=None, opt_d=None,
                             rng=jax.random.key(0))
    jmetrics, jfake = jax.jit(jgan.make_eval_step(jcfg))(jstate, {k: jnp.asarray(v) for k, v in np_batch.items()})
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(fake.numpy(), np.asarray(jfake), rtol=RTOL, atol=ATOL)
