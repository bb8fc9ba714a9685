"""The port's HiFiGAN and Vocos (ConvNeXt backbone, iSTFT head) against the JAX package, on the CPU.

The port's random weights go through the JAX package's own
``from_torch_state_dict`` and the same numpy mels through both models, with
and without ``frame_lengths``; the bridge back to the port is checked to the
bit, and the presets field by field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu import config as jconfig
from vocoder_tpu.models import convnext as jconvnext
from vocoder_tpu.models import hifigan as jhifigan
from vocoder_tpu.models import vocos as jvocos
from vocoder_tpu.ops import spectral as jspectral
from vocoder_tpu_torch import config as tconfig
from vocoder_tpu_torch.cli import infer
from vocoder_tpu_torch.convert import (
    hifigan_state_dict_from_jax,
    load_reference_state_dict,
    vocos_state_dict_from_jax,
)
from vocoder_tpu_torch.data.audio_io import read_wav, write_wav
from vocoder_tpu_torch.models import hifigan as thifigan
from vocoder_tpu_torch.models import vocos as tvocos
from vocoder_tpu_torch.models.convnext import ConvNeXtConfig
from vocoder_tpu_torch.models.registry import get_generator
from vocoder_tpu_torch.nn import fold_weight_norm
from vocoder_tpu_torch.ops.spectral import hann_window, istft_same

HIFI = dict(hop_length=16, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 3), (1, 3)), num_mels=8, upsample_initial_channel=32)
LENGTHS = [20, 13, 1]


def _vocos_cfgs():
    """A two-stage ConvNeXt and a 64-point iSTFT head, in both packages' config classes."""
    bb = dict(input_channels=8, depths=(2, 1), dims=(16, 32))
    head = dict(dim=32, n_fft=64, hop_length=16, win_length=64)
    return (tvocos.VocosConfig(ConvNeXtConfig(**bb), tvocos.ISTFTHeadConfig(**head)),
            jvocos.VocosConfig(jconvnext.ConvNeXtConfig(**bb), jvocos.ISTFTHeadConfig(**head)))


def _mel(rng, lengths, frames=20, zero_pad=True):
    mel = (rng.standard_normal((len(lengths), 8, frames)) - 5.0).astype(np.float32)  # a log-mel's scale
    if zero_pad:
        for i, n in enumerate(lengths):
            mel[i, :, n:] = 0.0
    return mel


def _hifigan(seed):
    cfg = thifigan.HiFiGANConfig(**HIFI)
    sd = thifigan.random_state_dict(cfg, seed)
    model = thifigan.HiFiGAN(cfg)
    model.load_state_dict(sd)
    return fold_weight_norm(model).eval(), sd


def _vocos(seed):
    tcfg, _ = _vocos_cfgs()
    sd = tvocos.random_state_dict(tcfg, seed)
    model = tvocos.Vocos(tcfg)
    model.load_state_dict(sd)
    return model.eval(), sd


@pytest.mark.parametrize("masked", [False, True])
def test_hifigan_matches_jax_apply(masked):
    model, sd = _hifigan(0)
    jcfg = jhifigan.HiFiGANConfig(**HIFI)
    params = jhifigan.from_torch_state_dict(sd, jcfg)
    mel = _mel(np.random.default_rng(0), LENGTHS, zero_pad=masked)
    lens = np.asarray(LENGTHS) if masked else None
    want = np.asarray(jhifigan.apply(params, jnp.asarray(mel), jcfg,
                                     frame_lengths=None if lens is None else jnp.asarray(lens)))
    with torch.inference_mode():
        got = model(torch.from_numpy(mel), None if lens is None else torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape == (3, 1, 20 * 16)
    assert 0.05 < np.abs(want).max() < 0.99  # the comparison is not hidden by tanh saturation
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_vocos_matches_jax_apply(masked):
    model, sd = _vocos(1)
    _, jcfg = _vocos_cfgs()
    params = jvocos.from_torch_state_dict(sd, jcfg)
    mel = _mel(np.random.default_rng(1), LENGTHS, zero_pad=masked)
    lens = np.asarray(LENGTHS) if masked else None
    want = np.array(jvocos.apply(params, jnp.asarray(mel), jcfg,
                                   frame_lengths=None if lens is None else jnp.asarray(lens)))
    with torch.inference_mode():
        got = model(torch.from_numpy(mel), None if lens is None else torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape == (3, 1, 20 * 16)
    if masked:  # past each item's samples the envelope is ~0: those samples are the caller's to cut
        for i, n in enumerate(LENGTHS):
            got[i, :, n * 16 :] = want[i, :, n * 16 :] = 0.0
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("family", ["hifigan", "vocos"])
def test_padded_batch_equals_per_item_runs(family):
    """Row i of a padded batch, cut to its frames, is item i's own forward (HiFiGAN also 0 after)."""
    model, _ = _hifigan(2) if family == "hifigan" else _vocos(2)
    lengths = [20, 0, 1, 7]
    mel = torch.from_numpy(_mel(np.random.default_rng(2), lengths))
    with torch.inference_mode():
        out = model(mel, torch.tensor(lengths))
        for i, n in enumerate(lengths):
            if n:
                torch.testing.assert_close(out[i : i + 1, :, : n * 16], model(mel[i : i + 1, :, :n]),
                                           rtol=1e-5, atol=1e-6)
            if family == "hifigan":
                assert not out[i, :, n * 16 :].any()


@pytest.mark.parametrize("resolution", ["44100_512_2048", "24000_2048_3072"])
@pytest.mark.parametrize("masked", [False, True])
def test_istft_same_matches_jax(resolution, masked):
    """irfft + overlap-add against the JAX package's basis matmul, with each item's own envelope;
    n_fft 3072 at hop 2048 overlaps a frame with two neighbours at most."""
    r = jconfig.RESOLUTIONS[resolution]
    bins, frames = r["n_fft"] // 2 + 1, 9
    rng = np.random.default_rng(3)
    re, im = (rng.standard_normal((3, bins, frames)).astype(np.float32) for _ in range(2))
    lens = np.asarray([9, 4, 1]) if masked else None
    kw = dict(n_fft=r["n_fft"], hop_length=r["hop_length"], win_length=r["win_length"])
    want = np.array(jspectral.istft_same(jnp.asarray(re), jnp.asarray(im), **kw,
                                           frame_lengths=None if lens is None else jnp.asarray(lens)))
    window = torch.from_numpy(hann_window(r["win_length"]))
    got = istft_same(torch.from_numpy(re), torch.from_numpy(im), window, **kw,
                     frame_lengths=None if lens is None else torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape == (3, frames * r["hop_length"])
    if masked:
        for i, n in enumerate(lens):
            got[i, n * r["hop_length"] :] = want[i, n * r["hop_length"] :] = 0.0
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_hifigan_bridge_round_trip_is_bit_exact():
    """port -> JAX from_torch_state_dict -> hifigan_state_dict_from_jax -> port."""
    cfg = thifigan.HiFiGANConfig(**HIFI)
    sd = thifigan.random_state_dict(cfg, 3)
    back = hifigan_state_dict_from_jax(jax.tree.map(np.asarray, jhifigan.from_torch_state_dict(
        sd, jhifigan.HiFiGANConfig(**HIFI))))
    assert set(back) == set(sd)
    for key in sd:
        torch.testing.assert_close(back[key], sd[key], rtol=0, atol=0)
    thifigan.HiFiGAN(cfg).load_state_dict(back)


def test_vocos_bridge_round_trip_is_bit_exact():
    tcfg, jcfg = _vocos_cfgs()
    sd = tvocos.random_state_dict(tcfg, 4)
    back = vocos_state_dict_from_jax(jax.tree.map(np.asarray, jvocos.from_torch_state_dict(sd, jcfg)))
    assert set(back) == set(sd)
    for key in sd:
        torch.testing.assert_close(back[key], sd[key], rtol=0, atol=0)
    tvocos.Vocos(tcfg).load_state_dict(back)


@pytest.mark.parametrize("preset", ["hifigan", "vocos", "vocos_small", "vocos_huge"])
@pytest.mark.parametrize("resolution", sorted(jconfig.RESOLUTIONS))
def test_presets_equal_jax_package(preset, resolution):
    """Every field, nested configs included."""
    want = jconfig.build_task_config(preset, resolution)
    got = tconfig.build_task_config(preset.replace("_", "-"), resolution)
    for field in ("sampling_rate", "n_fft", "hop_length", "win_length", "num_mels", "generator_name"):
        assert getattr(got, field) == getattr(want, field), field
    jfields = dataclasses.asdict(want.generator)
    assert type(got.generator).__name__ == type(want.generator).__name__
    assert dataclasses.asdict(got.generator) == jfields


@pytest.mark.parametrize("name", ["hifigan", "vocos"])
def test_registry_serves_the_new_families(name):
    gen = get_generator(name)
    assert gen.module_cls.__name__ == {"hifigan": "HiFiGAN", "vocos": "Vocos"}[name]


def test_full_width_shapes_match_jax_init():
    """The 44.1 kHz presets: the port's state_dict shapes are the bridge of JAX's abstract init."""
    for preset, jmod, bridge, module in (("hifigan", jhifigan, hifigan_state_dict_from_jax, thifigan.HiFiGAN),
                                         ("vocos", jvocos, vocos_state_dict_from_jax, tvocos.Vocos)):
        jcfg = jconfig.build_task_config(preset).generator
        tcfg = tconfig.build_task_config(preset).generator
        shapes = jax.eval_shape(lambda key: jmod.init(key, jcfg), jax.random.key(0))
        bridged = bridge(jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), shapes))
        port = module(tcfg, device="meta").state_dict()
        assert {k: tuple(v.shape) for k, v in bridged.items()} == {k: tuple(v.shape) for k, v in port.items()}


def test_reference_checkpoints_load(tmp_path):
    """A Vocos checkpoint keeps its plain weights (and drops the iSTFT window buffer); a folded
    HiFiGAN checkpoint splits its weights back into weight norm."""
    vocos, vsd = _vocos(5)
    state = {f"generator.{k}": v for k, v in vsd.items()} | {"generator.head.istft.window": torch.ones(64)}
    torch.save({"state_dict": state}, tmp_path / "v.ckpt")
    loaded = load_reference_state_dict(tmp_path / "v.ckpt", keys=vocos.state_dict().keys())
    assert set(loaded) == set(vsd)
    for key in vsd:
        assert torch.equal(loaded[key], vsd[key]), key

    hifi, _ = _hifigan(6)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in hifi.state_dict().items()}}, tmp_path / "h.ckpt")
    fresh = thifigan.HiFiGAN(hifi.cfg)
    fresh.load_state_dict(load_reference_state_dict(tmp_path / "h.ckpt", keys=fresh.state_dict().keys()))
    mel = torch.from_numpy(_mel(np.random.default_rng(6), [9], 9))
    with torch.inference_mode():
        torch.testing.assert_close(fold_weight_norm(fresh).eval()(mel), hifi(mel), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family", ["hifigan", "vocos"])
def test_batched_cli_equals_per_file_and_jax(tmp_path, monkeypatch, family):
    """--model hifigan|vocos --device cpu --batch 3 over mels of different lengths: each WAV equals the
    port's --batch 1 WAV and JAX apply on that file alone."""
    model, sd = _hifigan(7) if family == "hifigan" else _vocos(7)
    jcfg = jhifigan.HiFiGANConfig(**HIFI) if family == "hifigan" else _vocos_cfgs()[1]
    jmod = jhifigan if family == "hifigan" else jvocos
    task = tconfig.GANTaskConfig(sampling_rate=8000, n_fft=64, hop_length=16, win_length=64, num_mels=8,
                                 generator_name=family, generator=model.cfg)
    monkeypatch.setattr(infer, "build_task_config", lambda model, resolution: task)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in sd.items()}}, tmp_path / "g.ckpt")
    (tmp_path / "in").mkdir()
    rng = np.random.default_rng(7)
    mels = {f"m{n}.npy": (rng.standard_normal((8, n)) - 5.0).astype(np.float32) for n in (5, 17, 11, 30)}
    for name, mel in mels.items():
        np.save(tmp_path / "in" / name, mel)
    audio = (0.3 * np.sin(np.arange(300) / 3.0)).astype(np.float32)
    write_wav(tmp_path / "in" / "a.wav", audio[None], 8000)
    outs = {}
    for batch in (3, 1):
        infer.main(["--model", family, "--resolution", "tiny", "--ckpt", str(tmp_path / "g.ckpt"), "--input",
                    str(tmp_path / "in"), "--output", str(tmp_path / f"o{batch}"), "--device", "cpu",
                    "--batch", str(batch), "--chunk-frames", "0"])
        outs[batch] = {p.name: read_wav(p)[0] for p in sorted((tmp_path / f"o{batch}").iterdir())}
    assert sorted(outs[3]) == sorted(["a.wav", *(n.replace(".npy", ".wav") for n in mels)])
    quantum = 1.0 / 32768
    for name, got in outs[3].items():
        np.testing.assert_allclose(got, outs[1][name], rtol=0, atol=quantum, err_msg=name)
    params = jmod.from_torch_state_dict(sd, jcfg)
    apply = jax.jit(lambda m: jmod.apply(params, m, jcfg))  # one compile per shape, not per op
    for name, mel in mels.items():
        want = np.asarray(apply(jnp.asarray(mel[None])))[:, 0]
        np.testing.assert_allclose(outs[3][name.replace(".npy", ".wav")], np.clip(want, -1, 1), rtol=0,
                                   atol=quantum + 2e-4, err_msg=name)
