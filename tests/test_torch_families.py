"""The f0-template path, RefineGAN and Firefly-GAN of the port against the JAX package, on the CPU.

``data/f0.py`` is a copy: equal to the last bit.  The models take the port's random weights through
the JAX package's own ``from_torch_state_dict`` and the same numpy inputs through both packages,
fp32, at rtol 2e-4 / atol 2e-5 (the JAX kernel tests' tolerance).  RefineGAN's AdaIN noise cannot be
reproduced across the packages, so those comparisons make it zero on both sides (the JAX package's
``jax.random.normal`` and the port's ``adain_noise``, patched inside the test) and leave the AdaIN
weights nonzero.  The bridges back to the port are checked to the bit, and the presets' builds (or
refusals) against the JAX package's for every generator at every resolution.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu import config as jconfig
from vocoder_tpu.data import f0 as jf0
from vocoder_tpu.models import bigvgan as jbigvgan
from vocoder_tpu.models import convnext as jconvnext
from vocoder_tpu.models import firefly as jfirefly
from vocoder_tpu.models import hifigan as jhifigan
from vocoder_tpu.models import refinegan as jrefinegan
from vocoder_tpu.models import registry as jregistry
from vocoder_tpu_torch import config as tconfig
from vocoder_tpu_torch.cli import infer
from vocoder_tpu_torch.convert import (
    bigvgan_state_dict_from_jax,
    firefly_state_dict_from_jax,
    hifigan_state_dict_from_jax,
    refinegan_state_dict_from_jax,
)
from vocoder_tpu_torch.data import f0 as tf0
from vocoder_tpu_torch.data.audio_io import read_wav, write_wav
from vocoder_tpu_torch.models import bigvgan, firefly, hifigan, refinegan
from vocoder_tpu_torch.models.convnext import ConvNeXtConfig
from vocoder_tpu_torch.models.registry import PORTED, get_generator
from vocoder_tpu_torch.nn import fold_weight_norm

RTOL, ATOL = 2e-4, 2e-5
HOP = 16
# HiFiGAN over three stages (noise convs of kernel 16 / stride 8, kernel 4 / stride 2, then kernel 1);
# BigVGAN over two (kernel 8 / stride 4, kernel 1), fewer Pallas-interpreter shapes.
UPSAMPLERS = {  # name -> (port module class, port config class, JAX module, bridge, config)
    "hifigan": (hifigan.HiFiGAN, hifigan.HiFiGANConfig, jhifigan, hifigan_state_dict_from_jax,
                dict(hop_length=HOP, upsample_rates=(2, 4, 2), upsample_kernel_sizes=(4, 8, 4),
                     resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)), num_mels=8,
                     upsample_initial_channel=32, use_template=True)),
    "bigvgan": (bigvgan.BigVGAN, bigvgan.BigVGANConfig, jbigvgan, bigvgan_state_dict_from_jax,
                dict(hop_length=HOP, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                     resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3),) * 2, num_mels=8,
                     upsample_initial_channel=32, use_template=True)),
}
REFINE = dict(sampling_rate=8000, hop_length=HOP, downsample_rates=(2, 2, 2, 2), upsample_rates=(2, 2, 2, 2),
              num_mels=8, start_channels=4)
# Frames; the longest odd.  8 frames, BigVGAN's first stage's 32 samples, is the JAX masked aa-snake's floor.
LENGTHS = [21, 13, 8]


def _firefly_cfgs():
    bb = dict(input_channels=8, depths=(1, 1), dims=(16, 32))
    head = dict(hop_length=HOP, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
                resblock_dilation_sizes=((1, 3), (1, 3)), num_mels=32, upsample_initial_channel=32,
                pre_conv_kernel_size=13, post_conv_kernel_size=13)
    return (firefly.FireflyConfig(ConvNeXtConfig(**bb), hifigan.HiFiGANConfig(**head)),
            jfirefly.FireflyConfig(jconvnext.ConvNeXtConfig(**bb), jhifigan.HiFiGANConfig(**head)))


def _mel(rng, batch, frames):
    return (rng.standard_normal((batch, 8, frames)) - 5.0).astype(np.float32)  # a log-mel's scale


def _templates(rng, frames: int, n: int) -> np.ndarray:
    """(n, 1, frames * HOP) templates: each a phase-continuous sine of its own f0, unvoiced in a stretch."""
    f0 = rng.uniform(200.0, 800.0, (n, 1)) * np.ones((1, frames))
    f0[:, frames // 3 : frames // 2] = 0.0
    return np.stack([jf0.template_from_f0(f, 8000, HOP) for f in f0])[:, None, :].astype(np.float32)


@pytest.fixture
def zero_noise(monkeypatch):
    """RefineGAN's AdaIN noise 0 in both packages, the AdaIN weights kept."""
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(refinegan, "adain_noise", lambda x, generator: torch.zeros_like(x))


@pytest.mark.parametrize("signal", ["tone", "silence", "chirp"])
def test_f0_and_template_equal_jax(signal):
    sr, hop = 16000, 160
    t = np.arange(sr // 2) / sr
    rng = np.random.default_rng(0)
    audio = {"tone": 0.5 * np.sin(2 * np.pi * 220.0 * t),
             "silence": 1e-4 * rng.standard_normal(t.size),
             "chirp": 0.4 * np.sin(2 * np.pi * (100.0 * t + 400.0 * t * t))}[signal].astype(np.float32)
    want = jf0.estimate_f0(audio, sr, hop)
    got = tf0.estimate_f0(audio, sr, hop)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tf0.template_from_f0(got, sr, hop), jf0.template_from_f0(want, sr, hop))
    np.testing.assert_array_equal(tf0.f0_template(audio, sr, hop), jf0.template_from_f0(want, sr, hop))
    assert (want > 0).mean() > 0.8 if signal != "silence" else (want == 0).mean() > 0.8


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("family", ["hifigan", "bigvgan"])
def test_template_generators_match_jax_apply(family, masked):
    module, config, jmod, _, kw = UPSAMPLERS[family]
    cfg = config(**kw)
    sd = {"hifigan": hifigan, "bigvgan": bigvgan}[family].random_state_dict(cfg, 0)
    model = module(cfg)
    model.load_state_dict(sd)
    model = fold_weight_norm(model).eval()
    jcfg = getattr(jmod, config.__name__)(**kw)
    params = jmod.from_torch_state_dict(sd, jcfg)
    rng = np.random.default_rng(1)
    frames = max(LENGTHS)
    mel, tpl = _mel(rng, len(LENGTHS), frames), _templates(rng, frames, len(LENGTHS))
    lens = np.asarray(LENGTHS) if masked else None
    if masked:
        for i, n in enumerate(LENGTHS):
            mel[i, :, n:] = 0.0
    want = np.asarray(jmod.apply(params, jnp.asarray(mel), jcfg, jnp.asarray(tpl),
                                 frame_lengths=None if lens is None else jnp.asarray(lens)))
    with torch.inference_mode():
        got = model(torch.from_numpy(mel), None if lens is None else torch.from_numpy(lens),
                    template=torch.from_numpy(tpl)).numpy()
        without = model.noise_convs[0](torch.from_numpy(tpl))
    assert got.shape == want.shape == (3, 1, frames * HOP)
    assert float(without.abs().max()) > 0.05  # the template reaches the stream
    assert 0.05 < np.abs(want).max() < 0.99  # the comparison is not hidden by tanh saturation
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", ["hifigan", "bigvgan"])
def test_template_is_required_and_checked(family):
    module, config, _, _, kw = UPSAMPLERS[family]
    mel = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="use_template"):
        module(config(**kw))(mel)
    with pytest.raises(ValueError, match="without use_template"):
        module(config(**{**kw, "use_template": False}))(mel, template=torch.zeros(1, 1, 4 * HOP))


def test_noise_convs_stay_outside_k2_plans():
    """K2's packed weights (``stage_plan``, keyed on the stage's parameters) hold the stage's convs alone,
    with a template as without: the noise convs live outside the stages."""
    from vocoder_tpu_torch.ops.amp_block import stage_plan

    module, config, _, _, kw = UPSAMPLERS["bigvgan"]
    model = fold_weight_norm(module(config(**kw))).eval()
    noise_ptrs = {p.data_ptr() for p in model.noise_convs.parameters()}
    for i in range(2):
        blocks = list(model.resblocks[2 * i : 2 * i + 2])
        plan = stage_plan(blocks, True)
        assert len(plan.params) == 2 * 2 * 2
        assert not noise_ptrs & {p.data_ptr() for b in blocks for p in b.parameters()}


@pytest.mark.parametrize("scale", [0.5, 0.125, 2.0, 8.0])
@pytest.mark.parametrize("t", [8, 13, 16, 37])
def test_interp_linear_equals_jax(t, scale):
    """The port's linear resampler is the JAX package's, index math and rounding, bit for bit."""
    x = np.random.default_rng(t).standard_normal((2, t, 3)).astype(np.float32)  # JAX: (B, T, C)
    want = np.asarray(jrefinegan._interp_linear(jnp.asarray(x), scale))
    got = refinegan.interp_linear(torch.from_numpy(x).transpose(1, 2), scale).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, int(np.floor(t * scale)), 3)
    np.testing.assert_array_equal(got, want)


def _refinegan(seed=0):
    cfg = refinegan.RefineGANConfig(**REFINE)
    sd = refinegan.random_state_dict(cfg, seed)
    model = refinegan.RefineGAN(cfg)
    model.load_state_dict(sd)
    return fold_weight_norm(model).eval(), sd


def test_refinegan_matches_jax_apply_with_zero_noise(zero_noise):
    model, sd = _refinegan()
    jcfg = jrefinegan.RefineGANConfig(**REFINE)
    params = jrefinegan.from_torch_state_dict(sd, jcfg)
    assert all(float(np.abs(b[a]["weight"]).min()) > 0.05 for up in params["upsample_conv_blocks"]
               for b in up["blocks"] for a in ("adain1", "adain2"))
    rng = np.random.default_rng(2)
    mel, tpl = _mel(rng, 2, 12), _templates(rng, 12, 2)
    want = np.asarray(jax.jit(lambda m, t: jrefinegan.apply(params, m, jcfg, t))(jnp.asarray(mel), jnp.asarray(tpl)))
    with torch.inference_mode():
        got = model(torch.from_numpy(mel), torch.from_numpy(tpl)).numpy()
    assert got.shape == want.shape == (2, 1, 12 * HOP)
    assert 0.01 < np.abs(want).max() < 0.99
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_refinegan_noise_is_explicit():
    """The same generator gives the same audio, another generator other audio; no generator is a fresh
    one seeded 0 (deterministic inference); a template is required."""
    model, _ = _refinegan()
    rng = np.random.default_rng(3)
    mel, tpl = torch.from_numpy(_mel(rng, 1, 8)), torch.from_numpy(_templates(rng, 8, 1))
    with torch.inference_mode():
        a = model(mel, tpl, torch.Generator().manual_seed(5))
        b = model(mel, tpl, torch.Generator().manual_seed(5))
        c = model(mel, tpl, torch.Generator().manual_seed(6))
        d = model(mel, tpl)
        e = model(mel, tpl, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.equal(d, e) and torch.equal(model(mel, tpl), d)
    assert float((a - c).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="template"):
        model(mel)


def test_firefly_matches_jax_apply():
    tcfg, jcfg = _firefly_cfgs()
    sd = firefly.random_state_dict(tcfg, 4)
    model = firefly.Firefly(tcfg)
    model.load_state_dict(sd)
    model = fold_weight_norm(model).eval()
    params = jfirefly.from_torch_state_dict(sd, jcfg)
    mel = _mel(np.random.default_rng(4), 2, 10)
    want = np.asarray(jfirefly.apply(params, jnp.asarray(mel), jcfg))
    with torch.inference_mode():
        got = model(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 1, 10 * HOP)
    assert 0.05 < np.abs(want).max() < 0.99
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _bridge_case(name):
    """(port state_dict, JAX from_torch_state_dict of it, the port's bridge back, port module)."""
    if name in UPSAMPLERS:
        module, config, jmod, bridge, kw = UPSAMPLERS[name]
        cfg, jcfg = config(**kw), getattr(jmod, config.__name__)(**kw)
        sd = {"hifigan": hifigan, "bigvgan": bigvgan}[name].random_state_dict(cfg, 3)
        return sd, lambda sd: jmod.from_torch_state_dict(sd, jcfg), bridge, module(cfg)
    if name == "refinegan":
        cfg = refinegan.RefineGANConfig(**REFINE)
        return (refinegan.random_state_dict(cfg, 3),
                lambda sd: jrefinegan.from_torch_state_dict(sd, jrefinegan.RefineGANConfig(**REFINE)),
                refinegan_state_dict_from_jax, refinegan.RefineGAN(cfg))
    tcfg, jcfg = _firefly_cfgs()
    return (firefly.random_state_dict(tcfg, 3), lambda sd: jfirefly.from_torch_state_dict(sd, jcfg),
            firefly_state_dict_from_jax, firefly.Firefly(tcfg))


@pytest.mark.parametrize("name", ["hifigan", "bigvgan", "refinegan", "firefly_gan_base"])
def test_bridge_round_trip_is_bit_exact(name):
    """port -> JAX from_torch_state_dict -> the port's bridge -> port, noise convs included."""
    sd, to_jax, bridge, module = _bridge_case(name)
    back = bridge(jax.tree.map(np.asarray, to_jax(sd)))
    assert set(back) == set(sd)
    for key in sd:
        torch.testing.assert_close(back[key], sd[key], rtol=0, atol=0)
    module.load_state_dict(back)


@pytest.mark.parametrize("model,resolution,overrides", [
    ("bigvgan", "44100_512_2048", {"use_template": True}),
    ("hifigan", "24000_256_1024", {"use_template": True}),
    ("refinegan", "24000_256_1024", {}),
    ("firefly_gan_base", "44100_512_2048", {}),
])
def test_full_width_shapes_match_jax_init(model, resolution, overrides):
    """The presets at full width: the bridge of JAX's abstract init is the port's state_dict, shape for shape."""
    jcfg = jconfig.build_task_config(model, resolution).generator
    tcfg = tconfig.build_task_config(model, resolution).generator
    if overrides:
        jcfg, tcfg = dataclasses.replace(jcfg, **overrides), dataclasses.replace(tcfg, **overrides)
    jmod = {"bigvgan": jbigvgan, "hifigan": jhifigan, "refinegan": jrefinegan, "firefly_gan_base": jfirefly}[model]
    bridge = {"bigvgan": bigvgan_state_dict_from_jax, "hifigan": hifigan_state_dict_from_jax,
              "refinegan": refinegan_state_dict_from_jax, "firefly_gan_base": firefly_state_dict_from_jax}[model]
    shapes = jax.eval_shape(lambda key: jmod.init(key, jcfg), jax.random.key(0))
    bridged = bridge(jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), shapes))
    port = get_generator(model).module_cls(tcfg, device="meta").state_dict()
    assert {k: tuple(v.shape) for k, v in bridged.items()} == {k: tuple(v.shape) for k, v in port.items()}


def _asdict_without_checkpointing(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    for node in (d, d.get("head", {})):
        node.pop("checkpointing", None)
    return d


@pytest.mark.parametrize("resolution", sorted(jconfig.RESOLUTIONS))
@pytest.mark.parametrize("model", sorted(PORTED))
def test_presets_build_or_raise_as_jax(model, resolution):
    """Each of the JAX registry's five generators at each resolution: the port builds exactly where the
    JAX package builds (then field by field the same config), and raises where its asserts fire."""
    assert sorted(PORTED) == jregistry.available()
    try:
        want = jconfig.build_task_config(model, resolution)
    except AssertionError:
        with pytest.raises(ValueError):
            tconfig.build_task_config(model, resolution)
        return
    got = tconfig.build_task_config(model, resolution)
    assert got.generator_name == want.generator_name
    assert type(got.generator).__name__ == type(want.generator).__name__
    assert _asdict_without_checkpointing(got.generator) == _asdict_without_checkpointing(want.generator)


def test_infer_cli_refinegan_on_cpu_matches_jax(tmp_path, monkeypatch, zero_noise):
    """cli/infer.py --model refinegan --device cpu on a WAV and a stereo WAV, zero noise: the WAVs equal
    JAX's refinegan.apply on JAX's log-mel and template_from_f0(estimate_f0(...)) of the same audio; a
    precomputed mel is refused with the JAX CLI's message."""
    from vocoder_tpu.ops.spectral import log_mel_spectrogram as jlog_mel

    cfg = refinegan.RefineGANConfig(**REFINE)
    task = tconfig.GANTaskConfig(sampling_rate=8000, n_fft=64, hop_length=HOP, win_length=64, num_mels=8,
                                 generator_name="refinegan", generator=cfg)
    monkeypatch.setattr(infer, "build_task_config", lambda model, resolution: task)
    sd = refinegan.random_state_dict(cfg, 7)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in sd.items()}}, tmp_path / "g.ckpt")
    (tmp_path / "in").mkdir()
    t = np.arange(1200) / 8000  # 75 frames, past --chunk-frames: a template runs unchunked
    rng = np.random.default_rng(7)
    mono = 0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.005 * rng.standard_normal(t.size)
    stereo = np.stack([mono, 0.3 * np.sin(2 * np.pi * (150.0 * t + 300.0 * t * t))])
    write_wav(tmp_path / "in" / "a.wav", mono.astype(np.float32), 8000)
    write_wav(tmp_path / "in" / "s.wav", stereo.astype(np.float32), 8000)
    argv = ["--model", "refinegan", "--ckpt", str(tmp_path / "g.ckpt"), "--input", str(tmp_path / "in"),
            "--output", str(tmp_path / "out"), "--device", "cpu", "--batch", "4", "--chunk-frames", "65"]
    infer.main(argv)

    jcfg = jrefinegan.RefineGANConfig(**REFINE)
    params = jrefinegan.from_torch_state_dict(sd, jcfg)
    apply = jax.jit(lambda m, t: jrefinegan.apply(params, m, jcfg, t))  # one compile per shape, not per op
    for name in ("a.wav", "s.wav"):
        audio, _ = read_wav(tmp_path / "in" / name)
        audio = np.pad(audio, ((0, 0), (0, (-audio.shape[-1]) % HOP)))
        mel = jlog_mel(jnp.asarray(audio), sample_rate=8000, n_fft=64, hop_length=HOP, win_length=64, n_mels=8,
                       f_max=4000)
        tpl = np.stack([jf0.template_from_f0(jf0.estimate_f0(ch, 8000, HOP), 8000, HOP) for ch in audio])
        assert np.abs(tpl).max() > 0.05  # voiced: the template carries the f0
        want = np.asarray(apply(mel, jnp.asarray(tpl[:, None, :])))[:, 0]
        got, sr = read_wav(tmp_path / "out" / name)
        assert sr == 8000 and got.shape == want.shape == audio.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 32768 + 2e-4, err_msg=name)

    np.save(tmp_path / "in" / "m.npy", _mel(rng, 1, 10)[0])
    with pytest.raises(SystemExit, match="precomputed-mel input has none"):
        infer.main(argv)
