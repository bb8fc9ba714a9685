"""The port's spectral magnitude, losses, discriminators and lr schedule against the JAX package, on the CPU.

Inputs come from numpy seeds; the discriminators' weights are the port's, bridged into the JAX
package by its own ``from_torch_state_dict``.  Tolerances are the JAX kernel tests'
(rtol 2e-4, atol 2e-5, ``tests/test_amp_fused.py``) unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocoder_tpu.losses import gan_loss as jgan_loss
from vocoder_tpu.losses import stft_loss as jstft_loss
from vocoder_tpu.models import mpd as jmpd
from vocoder_tpu.models import mrd as jmrd
from vocoder_tpu.ops import spectral as jspectral
from vocoder_tpu.train import schedule as jschedule
from vocoder_tpu_torch.losses import gan_loss, stft_loss
from vocoder_tpu_torch.models import mpd, mrd
from vocoder_tpu_torch.ops.spectral import stft_magnitude
from vocoder_tpu_torch.train import schedule

RTOL, ATOL = 2e-4, 2e-5


def _audio(seed, shape=(2, 300)):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("window", ["hann", "boxcar"])
@pytest.mark.parametrize("mag_mode", ["eps_inside", "clamp_inside", "plain"])
@pytest.mark.parametrize("padding", ["same_win", "same_nfft", "center"])
def test_stft_magnitude_matches_jax(padding, mag_mode, window):
    """Every padding, magnitude and window mode; win_length < n_fft puts the window in the middle."""
    x = _audio(0)
    kw = dict(n_fft=64, hop_length=16, win_length=48, padding=padding, mag_mode=mag_mode, window=window)
    want = np.asarray(jspectral.stft_magnitude(jnp.asarray(x), **kw))
    got = stft_magnitude(torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plain_magnitude_has_zero_subgradient_at_zero_power():
    """Silent input: the plain magnitude is 0 and its gradient finite and 0, where a plain sqrt sends inf."""
    x = torch.zeros(1, 128, requires_grad=True)
    mag = stft_magnitude(x, n_fft=32, hop_length=8, win_length=32, padding="same_nfft", mag_mode="plain",
                         window="boxcar")
    assert float(mag.detach().abs().max()) == 0.0
    (grad,) = torch.autograd.grad(mag.sum(), x)
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) == 0.0


def test_multi_resolution_stft_loss_matches_jax():
    x, y = _audio(1), _audio(2)
    res = ((64, 16, 64), (32, 8, 24), (128, 30, 100))
    want = jstft_loss.multi_resolution_stft_loss(jnp.asarray(x), jnp.asarray(y), res)
    got = stft_loss.multi_resolution_stft_loss(torch.from_numpy(x), torch.from_numpy(y), res)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL, atol=ATOL)


def test_gan_losses_match_jax_with_list_and_array_scores():
    """MPD-style list scores and MRD-style (B, D) array scores, whose rows are the items."""
    rng = np.random.default_rng(3)
    lists = [[rng.standard_normal((2, n)).astype(np.float32) for n in (5, 7)] for _ in range(2)]
    arrays = [rng.standard_normal((3, 11)).astype(np.float32) for _ in range(2)]
    feats = [[[rng.standard_normal((2, 4, n)).astype(np.float32) for n in (9, 3)] for _ in range(2)]
             for _ in range(2)]
    for real, fake in (lists, arrays):
        tj = (lambda v: [jnp.asarray(a) for a in v]) if isinstance(real, list) else jnp.asarray
        tt = (lambda v: [torch.from_numpy(a) for a in v]) if isinstance(real, list) else torch.from_numpy
        np.testing.assert_allclose(float(gan_loss.generator_adversarial_loss(tt(fake))),
                                   float(jgan_loss.generator_adversarial_loss(tj(fake))), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(gan_loss.discriminator_loss(tt(real), tt(fake))),
                                   float(jgan_loss.discriminator_loss(tj(real), tj(fake))), rtol=RTOL, atol=ATOL)
    fr, ff = feats
    want = jgan_loss.feature_matching_loss(jax.tree.map(jnp.asarray, fr), jax.tree.map(jnp.asarray, ff))
    got = gan_loss.feature_matching_loss([[torch.from_numpy(a) for a in f] for f in fr],
                                         [[torch.from_numpy(a) for a in f] for f in ff])
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)


def _check_discriminator(port, jparams, japply, jcfg, audio):
    """Scores equal in order (one channel: NCHW and NHWC flatten alike); feature maps after NCHW -> NHWC."""
    with torch.no_grad():
        scores, fmaps = port(torch.from_numpy(audio))
    jscores, jfmaps = japply(jparams, jnp.asarray(audio), jcfg)
    if isinstance(scores, list):
        assert len(scores) == len(jscores)
        for s, js in zip(scores, jscores):
            np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=RTOL, atol=ATOL)
    for fm, jfm in zip(fmaps, jfmaps):
        for f, jf in zip(fm, jfm):
            np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), np.asarray(jf), rtol=RTOL, atol=ATOL)


def test_mpd_matches_jax_through_the_bridge():
    """Periods that pad (300 % 7 != 0) and that do not; JAX loads the port's state_dict as it is."""
    cfg = mpd.MPDConfig(periods=(2, 3, 7), channels=(1, 4, 8, 16))
    jcfg = jmpd.MPDConfig(periods=(2, 3, 7), channels=(1, 4, 8, 16))
    torch.manual_seed(0)
    port = mpd.MultiPeriodDiscriminator(cfg)
    jparams = jmpd.from_torch_state_dict(port.state_dict(), jcfg)
    _check_discriminator(port, jparams, jmpd.apply, jcfg, _audio(4, (2, 1, 300)))


def test_mrd_matches_jax_through_the_bridge():
    """Boxcar windows and plain magnitudes at two resolutions, scores concatenated."""
    res = ((64, 16, 64), (32, 8, 24))
    torch.manual_seed(1)
    port = mrd.MultiResolutionDiscriminator(mrd.MRDConfig(resolutions=res))
    jcfg = jmrd.MRDConfig(resolutions=res)
    jparams = jmrd.from_torch_state_dict(port.state_dict(), jcfg)
    _check_discriminator(port, jparams, jmrd.apply, jcfg, _audio(5, (2, 1, 300)))


@pytest.mark.parametrize("kw", [{}, dict(warm_up_steps=10, val_start=1e-6, max_decay_steps=100, val_final=1e-5)])
def test_warmup_cosine_matches_jax(kw):
    """The port computes in float64, the JAX package in float32: rtol 1e-6."""
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 5000):
        want = float(jschedule.warmup_cosine(jnp.asarray(step), jschedule.WarmupCosineConfig(**kw)))
        got = schedule.warmup_cosine(step, schedule.WarmupCosineConfig(**kw))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
