"""The vae and vqvae families' modules and the codec CLI against the JAX package, on the CPU.

Every comparison takes the port's random weights (``random_state_dict``) through the JAX package's own
``from_torch_state_dict`` and the same numpy inputs through both packages, fp32, at rtol 2e-4 / atol 2e-5
(the JAX kernel tests' tolerance).  Draws cannot be reproduced across the packages, so the tests that
draw make them the same numpy arrays inside the test (``tests/test_torch_family_train.py::equal_draws``;
the WaveNet's eps, channels-last in JAX, through ``wavenet.normal_like`` here).

VQ codes: the two packages order the sums of |x|^2 - 2 x.E^T + |E|^2 differently, so a frame whose best
and second-best distances lie within rounding of each other may take either code.  Codes are held equal
on every frame whose margin (from a float64 recomputation) exceeds ``MARGIN``, 1e-3 against squared
distances of order 0.1 to 10 (fp32 rounding there is ~1e-6), and each test asserts that most frames are
such; a later quantiser's codes are compared where the earlier ones agree, and decoding on the same
codes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_family_train import equal_draws  # noqa: F401 (a fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu import config as jconfig
from vocoder_tpu import nn as jnn
from vocoder_tpu.data.resample import resample as jresample
from vocoder_tpu.models import convnext as jconvnext
from vocoder_tpu.models import hifigan as jhifigan
from vocoder_tpu.models import vae as jvae
from vocoder_tpu.models import vq as jvq
from vocoder_tpu.models import wavenet as jwavenet
from vocoder_tpu.ops.spectral import linear_spectrogram as jlinear
from vocoder_tpu.train import gan as jgan
from vocoder_tpu_torch import config as tconfig
from vocoder_tpu_torch import nn as tnn
from vocoder_tpu_torch.cli import codec
from vocoder_tpu_torch.config import TrainConfig
from vocoder_tpu_torch.convert import (
    vae_state_dict_from_jax,
    vq_state_dict_from_jax,
    vqvae_state_dict_from_jax,
    wavenet_state_dict_from_jax,
)
from vocoder_tpu_torch.data.audio_io import read_wav, write_wav
from vocoder_tpu_torch.models import convnext, hifigan, vae, vq, wavenet
from vocoder_tpu_torch.ops.spectral import linear_spectrogram
from vocoder_tpu_torch.train import gan

RTOL, ATOL = 2e-4, 2e-5
MARGIN = 1e-3
HOP, N_FFT, SR = 4, 16, 8000
BINS = N_FFT // 2 + 1
DEC = dict(hop_length=HOP, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 2),), upsample_initial_channel=16)
ENC = dict(in_channels=BINS, out_channels=6, hidden_channels=8, kernel_size=3, dilation_rate=2, dilation_cycle=2,
           n_layers=3)


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL, **kw)


def margins(x: np.ndarray, embed: np.ndarray) -> np.ndarray:
    """(N, D) frames, (K, D) codes -> each frame's second-best minus best squared distance, float64."""
    d = np.sort(((x[:, None, :].astype(np.float64) - embed[None].astype(np.float64)) ** 2).sum(-1), axis=1)
    return d[:, 1] - d[:, 0]


# -- drop_path and the per-block rates ---------------------------------------------------------------------


@pytest.mark.parametrize("depths,rate", [((3, 3, 9, 3), 0.2), ((3, 3, 27, 3), 0.4), ((8,), 0.1), ((1, 2), 0.0)])
def test_drop_rates_equal_jax(depths, rate):
    """linspace over every block of every stage, cut by stage (Firefly-GAN and the vae encoder 18 blocks
    at 0.2, Vocos base and huge 36 at 0.4, vocos_small 8 at 0.1); each block of the module takes its own."""
    kw = dict(depths=depths, dims=tuple(8 * (i + 1) for i in range(len(depths))), drop_path_rate=rate)
    want = jconvnext._drop_rates(jconvnext.ConvNeXtConfig(**kw))
    cfg = convnext.ConvNeXtConfig(**kw)
    assert convnext._drop_rates(cfg) == want
    enc = convnext.ConvNeXtEncoder(cfg, device="meta")
    assert [[b.drop_rate for b in stage] for stage in enc.stages] == want
    flat = [r for stage in want for r in stage]
    assert flat[0] == 0.0 and flat[-1] == rate and len(set(flat)) == (len(flat) if rate else 1)


def test_drop_path_equals_jax_given_the_mask(monkeypatch):
    """The same keep-mask gives the same output as JAX's drop_path (x * mask / keep, one draw per sample);
    the identity at p = 0 or out of training; a CPU generator gives a model the same draws on any device;
    about keep of the samples are kept; no generator in training raises."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5, 3)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(mask.reshape(shape)))
    want = jnn.drop_path(jax.random.key(0), jnp.asarray(x), 0.3, True)
    monkeypatch.setattr(torch, "rand", lambda shape, generator, device: torch.from_numpy(
        np.where(mask, 0.0, 0.9).astype(np.float32).reshape(shape)))
    got = tnn.drop_path(torch.from_numpy(x), 0.3, True, torch.Generator())
    monkeypatch.undo()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xt = torch.from_numpy(x)
    assert tnn.drop_path(xt, 0.0, True, None) is xt and tnn.drop_path(xt, 0.5, False, None) is xt
    with pytest.raises(ValueError, match="Generator"):
        tnn.drop_path(xt, 0.5, True, None)
    a = tnn.drop_path(torch.ones(4000, 2), 0.3, True, torch.Generator().manual_seed(1))
    b = tnn.drop_path(torch.ones(4000, 2), 0.3, True, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and set(a.unique().tolist()) == {0.0, float(torch.ones(()) / 0.7)}
    assert torch.equal(a[:, 0], a[:, 1]) and abs(float((a[:, 0] > 0).float().mean()) - 0.7) < 0.03


@pytest.mark.parametrize("masked", [False, True])
def test_convnext_training_forward_matches_jax(masked, equal_draws):  # noqa: F811
    """The ConvNeXt encoder in training mode with a noise generator against JAX's apply(training=True),
    the same keep-masks (one sample dropped in two of the three blocks that may drop), with and without
    frame lengths; without a generator, or in eval mode, nothing is dropped."""
    kw = dict(input_channels=8, depths=(2, 2), dims=(8, 16), drop_path_rate=0.5)
    cfg = convnext.ConvNeXtConfig(**kw)
    sd = convnext.random_state_dict(cfg, 0)
    model = convnext.ConvNeXtEncoder(cfg)
    model.load_state_dict(sd)
    jcfg = jconvnext.ConvNeXtConfig(**kw)
    params = jconvnext.from_torch_state_dict(sd, jcfg)
    equal_draws["masks"] = {r: np.array([1.0, 0.0] if i else [1.0, 1.0], np.float32)
                            for i, r in enumerate(r for s in jconvnext._drop_rates(jcfg) for r in s if r > 0)}
    equal_draws["masks"][0.5] = np.array([0.0, 1.0], np.float32)
    x = np.random.default_rng(1).standard_normal((2, 8, 11)).astype(np.float32)
    lens = np.array([11, 7]) if masked else None
    if masked:
        x[1, :, 7:] = 0.0
    want = jconvnext.apply(params, jnp.asarray(x.transpose(0, 2, 1)), jcfg, training=True, rng=jax.random.key(0),
                           frame_lengths=None if lens is None else jnp.asarray(lens))
    tl = None if lens is None else torch.from_numpy(lens)
    got = model.train()(torch.from_numpy(x), tl, torch.Generator())
    _close(got, want)
    assert equal_draws["dropped"]["port"] == 2
    plain = jconvnext.apply(params, jnp.asarray(x.transpose(0, 2, 1)), jcfg,
                            frame_lengths=None if lens is None else jnp.asarray(lens))
    _close(model(torch.from_numpy(x), tl), plain)
    _close(model.eval()(torch.from_numpy(x), tl, torch.Generator()), plain)
    assert float(np.abs(np.asarray(plain) - np.asarray(want)).max()) > 1e-2


# -- the WaveNet posterior encoder --------------------------------------------------------------------------


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["vqvae", "vae", "bnvae"])
def test_wavenet_matches_jax(mode, masked, training, monkeypatch):
    """Each mode (3 layers, dilations 1, 2, 1), with and without lengths, eval and training: the outputs
    (z with the same eps in training), and bnvae's running statistics after a training forward."""
    tcfg, jcfg = wavenet.PosteriorEncoderConfig(mode=mode, **ENC), jwavenet.PosteriorEncoderConfig(mode=mode, **ENC)
    sd = wavenet.random_state_dict(tcfg, 0)
    model = wavenet.PosteriorEncoder(tcfg)
    model.load_state_dict(sd)
    model.train(training)
    params = jwavenet.from_torch_state_dict(sd, jcfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, BINS, 13)).astype(np.float32)
    eps = rng.standard_normal((2, 13, 6)).astype(np.float32)  # JAX's layout (B, T, C)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
    monkeypatch.setattr(wavenet, "normal_like", lambda like, generator: torch.from_numpy(eps.transpose(0, 2, 1).copy()))
    lens = np.array([13, 8]) if masked else None
    kw = {"bn_state": jwavenet.bn_state_from_torch(sd)} if mode == "bnvae" else {}
    want = jwavenet.apply(params, jnp.asarray(x), jcfg, None if lens is None else jnp.asarray(lens),
                          training=training, rng=jax.random.key(0), **kw)
    got = model(torch.from_numpy(x), None if lens is None else torch.from_numpy(lens), torch.Generator())
    if mode == "vqvae":
        _close(got, want)
        return
    for g, w, what in zip(got, want, ("z", "mean", "logvar", "mask")):
        _close(g, w, err_msg=what)
    if mode == "bnvae":
        new_bn = want[4]
        _close(model.mu_bn.running_mean, new_bn["mean"])
        _close(model.mu_bn.running_var, new_bn["var"])
        assert training == (not np.allclose(_np(model.mu_bn.running_mean), _np(sd["mu_bn.running_mean"])))
    if masked:
        assert float(got[0][1, :, 8:].detach().abs().max()) == 0.0


# -- the EMA vector quantiser -------------------------------------------------------------------------------


@pytest.mark.parametrize("num_quantizers", [1, 2])
def test_vq_matches_jax(num_quantizers):
    """Codes (where the margin allows), quantized, the commitment loss, the straight-through gradient, the
    EMA update of every codebook, and from_codes, against JAX's apply(training=True) and from_codes."""
    cfg_kw = dict(dim=8, codebook_size=32, num_quantizers=num_quantizers)
    tcfg, jcfg = vq.VQConfig(**cfg_kw), jvq.VQConfig(**cfg_kw)
    rng = np.random.default_rng(3)
    model = vq.VectorQuantizer(tcfg)
    for layer in model.layers:
        embed = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
        layer.embed.copy_(embed)
        layer.embed_avg.copy_(embed * 0.9)
        layer.cluster_size.copy_(torch.from_numpy(rng.uniform(0, 2, 32).astype(np.float32)))
    # Copies: jnp.asarray of a CPU array may alias the buffer that ema_update writes in place.
    state = {"layers": [{k: jnp.array(getattr(layer, k).numpy().copy()) for k in ("embed", "embed_avg", "cluster_size")}
                        for layer in model.layers]}
    x = (1.5 * rng.standard_normal((2, 8, 20))).astype(np.float32)
    w = rng.standard_normal((2, 8, 20)).astype(np.float32)

    def jloss(xx):
        q, codes, loss, new = jvq.apply(state, xx, jcfg, training=True)
        return jnp.sum(q * w) + 3.0 * loss, (q, codes, loss, new)

    (_, (jq, jcodes, jl, jnew)), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    q, codes, loss = model(xt)
    (torch.sum(q * torch.from_numpy(w)) + 3.0 * loss).backward()
    assert codes.shape == (num_quantizers, 2, 20) and codes.dtype == torch.int64

    flat = x.transpose(0, 2, 1).reshape(-1, 8)
    clear = margins(flat, _np(model.layers[0].embed)) > MARGIN
    assert clear.sum() >= 0.9 * clear.size
    got_codes, want_codes = codes.numpy().reshape(num_quantizers, -1), np.asarray(jcodes).reshape(num_quantizers, -1)
    np.testing.assert_array_equal(got_codes[0][clear], want_codes[0][clear])
    same = (got_codes == want_codes).all(0)
    assert same.all(), "no frame of these inputs lies near a tie"
    _close(q, jq)
    _close(loss, jl)
    _close(xt.grad, jgrad)
    model.ema_update(xt, codes)
    for layer, want in zip(model.layers, jnew["layers"]):
        for k in ("embed", "embed_avg", "cluster_size"):
            _close(getattr(layer, k), want[k], err_msg=k)
    assert not np.allclose(_np(model.layers[0].embed), np.asarray(state["layers"][0]["embed"]))
    _close(model.from_codes(codes), jvq.from_codes(jnew, jcodes, jcfg))
    assert torch.equal(model.from_codes(codes[:1]), model.layers[0].embed[codes[0]].transpose(1, 2))


def test_vq_distance_product_is_full_fp32_whatever_the_flags():
    """The distance product and the EMA sums switch TF32 off for themselves and restore the flag."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        seen = []
        with vq.full_fp32_matmul():
            seen.append(torch.backends.cuda.matmul.allow_tf32)
        assert seen == [False] and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# -- the vae and vqvae generators and the codec API --------------------------------------------------------


def _family_cfgs(family: str):
    """(port config, JAX config) of a tiny vae (ConvNeXt encoder) or vqvae (2 quantisers of 24 codes)."""
    def build(m):
        if family == "vae":
            return m["vae"].VAEGeneratorConfig(
                latent_size=6, encoder_kind="convnext",
                encoder=m["convnext"].ConvNeXtConfig(input_channels=BINS, depths=(1, 1), dims=(8, 12),
                                                     drop_path_rate=0.2),
                decoder=m["hifigan"].HiFiGANConfig(num_mels=6, **DEC))
        return m["vae"].VQVAEGeneratorConfig(
            latent_size=6, encoder=m["wavenet"].PosteriorEncoderConfig(**ENC), decoder=m["hifigan"].HiFiGANConfig(
                num_mels=6, **DEC), vq=m["vq"].VQConfig(dim=6, codebook_size=24, num_quantizers=2))

    return (build(dict(vae=vae, convnext=convnext, hifigan=hifigan, wavenet=wavenet, vq=vq)),
            build(dict(vae=jvae, convnext=jconvnext, hifigan=jhifigan, wavenet=jwavenet, vq=jvq)))


def _family(family: str):
    """(port task, JAX task, port generator, JAX params, JAX vq state or None), tiny, random weights."""
    tgen, jgen = _family_cfgs(family)
    common = dict(sampling_rate=SR, n_fft=N_FFT, hop_length=HOP, win_length=N_FFT, num_mels=8, generator_name=family,
                  family=family, input_transform="linear")
    tcfg, jcfg = gan.GANTaskConfig(generator=tgen, **common), jgan.GANTaskConfig(generator=jgen, **common)
    sd = (vae.vae_random_state_dict if family == "vae" else vae.vqvae_random_state_dict)(tgen, 0)
    model = (vae.VAEGenerator if family == "vae" else vae.VQVAEGenerator)(tgen)
    model.load_state_dict(sd)
    if family == "vqvae":
        sd = fit_codebooks(model, sd)
        model.load_state_dict(sd)
    enc = (jconvnext.from_torch_state_dict(sd, jgen.encoder, "encoder.") if family == "vae"
           else jwavenet.from_torch_state_dict(sd, jgen.encoder, "encoder."))
    params = {"encoder": enc, "decoder": jhifigan.from_torch_state_dict(sd, jgen.decoder, "decoder.")}
    vq_state = None
    if family == "vqvae":
        vq_state = {"layers": [{k: jnp.asarray(sd[f"vq.layers.{i}.{k}"].numpy()) for k in ("embed", "embed_avg",
                                                                                              "cluster_size")}
                               for i in range(2)]}
    return tcfg, jcfg, model, params, vq_state


def fit_codebooks(model, sd: dict) -> dict:
    """``sd`` with codebooks where a trained quantiser would hold them, so that frames take many codes (a
    random encoder's latents vary little about their mean, against unit-normal codebooks all of them take
    one code): the first on latent frames of ``_audio`` plus noise of 0.3 of their spread, the second at
    that scale about 0."""
    spec = linear_spectrogram(torch.from_numpy(_audio(4, 256, seed=9)[:, 0]), n_fft=N_FFT, hop_length=HOP,
                              win_length=N_FFT)
    with torch.no_grad():
        frames = model.encoder(spec).transpose(1, 2).reshape(-1, model.cfg.vq.dim).numpy()
    rng = np.random.default_rng(10)
    k, scale = model.cfg.vq.codebook_size, 0.3 * frames.std(0)
    rows = [frames[rng.choice(len(frames), k, replace=False)] + scale * rng.standard_normal((k, frames.shape[1]))]
    rows += [scale * rng.standard_normal((k, frames.shape[1])) for _ in range(model.cfg.vq.num_quantizers - 1)]
    sd = dict(sd)
    for i, r in enumerate(rows):
        sd[f"vq.layers.{i}.embed"] = sd[f"vq.layers.{i}.embed_avg"] = torch.from_numpy(r.astype(np.float32))
    return sd


def _audio(n: int = 2, t: int = 96, seed: int = 4) -> np.ndarray:
    """(n, 1, t): noise under a random envelope that changes every 8 samples, so that frames differ."""
    rng = np.random.default_rng(seed)
    env = np.repeat(rng.uniform(0.0, 0.6, (n, -(-t // 8))), 8, axis=1)[:, :t]
    return (env * rng.standard_normal((n, t)))[:, None].astype(np.float32)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("family", ["vae", "vqvae"])
def test_family_forward_matches_jax(family, training, equal_draws):  # noqa: F811
    """``train/gan.py::generator_forward`` of each family, eval and training (the vae with the same eps),
    against JAX's: the fake, the base loss and the family's metric; a vqvae training forward's EMA update,
    applied, gives JAX's new codebooks."""
    tcfg, jcfg, model, params, vq_state = _family(family)
    audio = _audio()
    want_fake, want_base, want_extra, want_metrics = jgan.generator_forward(
        params, jnp.asarray(audio), jcfg, training=training, rng=jax.random.key(0),
        extra=None if vq_state is None else {"vq": vq_state})
    fake, base, metrics, ema = gan.generator_forward(model.train(training), torch.from_numpy(audio), tcfg,
                                                     noise=torch.Generator())
    assert fake.shape == audio.shape and set(metrics) == set(want_metrics)
    _close(fake, want_fake)
    _close(base, want_base)
    for k in metrics:
        _close(metrics[k], want_metrics[k], err_msg=k)
    assert (ema is not None) == (family == "vqvae" and training)
    if family == "vae":
        assert bool(equal_draws["eps"]) == training
        assert float(base.detach()) > 0
    if ema is not None:
        ema()
        for i, want in enumerate(want_extra["vq"]["layers"]):
            for k in ("embed", "embed_avg", "cluster_size"):
                _close(getattr(model.vq.layers[i], k), want[k], err_msg=f"{i}.{k}")


def clear_frames(model, spec: torch.Tensor) -> np.ndarray:
    """(B, F) bool: the frames whose first quantiser's margin exceeds ``MARGIN``."""
    with torch.no_grad():
        latent = model.encoder(spec)
    b, d, f = latent.shape
    flat = latent.transpose(1, 2).reshape(-1, d).numpy()
    return (margins(flat, _np(model.vq.layers[0].embed)) > MARGIN).reshape(b, f)


def test_codec_api_matches_jax():
    """encode_to_codes (equal on the frames clear of a tie in the first quantiser and wherever the first
    codes agree) and decode_from_codes of the same codes."""
    tcfg, jcfg, model, params, vq_state = _family("vqvae")
    spec = np.array(jlinear(jnp.asarray(_audio(t=128)[:, 0]), n_fft=N_FFT, hop_length=HOP, win_length=N_FFT))
    want = np.asarray(jvae.encode_to_codes(params, vq_state, jnp.asarray(spec), jcfg.generator))
    model.eval()
    with torch.no_grad():
        got = model.encode_to_codes(torch.from_numpy(spec)).numpy()
    clear = clear_frames(model, torch.from_numpy(spec))
    assert clear.mean() > 0.8 and len(np.unique(want[0])) > 8
    np.testing.assert_array_equal(got[0][clear], want[0][clear])
    agree = got[0] == want[0]
    np.testing.assert_array_equal(got[1][agree], want[1][agree])
    with torch.no_grad():
        audio = model.decode_from_codes(torch.from_numpy(want.astype(np.int64)))
    _close(audio, jvae.decode_from_codes(params, vq_state, jnp.asarray(want), jcfg.generator))
    assert audio.shape == (2, 1, 128)


def _codec_workdir(work, tcfg, model) -> None:
    """A port training run's workdir as cli.train leaves it: config.json and checkpoints/<step>.pt."""
    import json

    (work / "checkpoints").mkdir(parents=True)
    (work / "config.json").write_text(json.dumps(dataclasses.asdict(TrainConfig(task=tcfg)), default=str))
    torch.save({"step": 3, "generator": model.state_dict()}, work / "checkpoints" / "3.pt")


def test_codec_cli_round_trip_matches_jax(tmp_path):
    """cli.codec encode -> decode --device cpu over a mono WAV at the task's rate and a stereo one at
    another: the codes equal JAX's encode_to_codes of JAX's linear spectrogram of the same mono,
    resampled, hop-padded audio (on the frames clear of a tie, and the second quantiser's where the first
    agrees); the WAVs JAX's decode_from_codes of the codes the CLI wrote, within a 16-bit step."""
    tcfg, jcfg, model, params, vq_state = _family("vqvae")
    _codec_workdir(tmp_path / "run", tcfg, model)
    (tmp_path / "in" / "sub").mkdir(parents=True)
    rng = np.random.default_rng(5)
    mono = _audio(1, 203, seed=6)[0, 0] + 0.2 * np.sin(2 * np.pi * 440 * np.arange(203) / SR)
    stereo = _audio(2, 150, seed=7)[:, 0]
    write_wav(tmp_path / "in" / "a.wav", mono.astype(np.float32), SR)
    write_wav(tmp_path / "in" / "sub" / "b.wav", stereo.astype(np.float32), 16000)
    ckpt = str(tmp_path / "run")
    codec.main(["encode", "--ckpt", ckpt, "--input", str(tmp_path / "in"), "--output", str(tmp_path / "codes"),
                "--device", "cpu"])
    codec.main(["decode", "--ckpt", str(tmp_path / "run" / "checkpoints"), "--input", str(tmp_path / "codes"),
                "--output", str(tmp_path / "out"), "--device", "cpu"])
    for rel, name in (("a.codes.npy", "a.wav"), ("sub/b.codes.npy", "b.wav")):
        audio, sr = read_wav(tmp_path / "in" / rel.replace(".codes.npy", ".wav"))
        a = jresample(audio.mean(0), sr, SR)
        a = np.pad(a, (0, (-len(a)) % HOP))
        spec = jlinear(jnp.asarray(a[None]), n_fft=N_FFT, hop_length=HOP, win_length=N_FFT)
        want = np.asarray(jvae.encode_to_codes(params, vq_state, spec, jcfg.generator))
        codes = np.load(tmp_path / "codes" / rel)
        assert codes.dtype == np.int32 and codes.shape == (2, 1, len(a) // HOP)
        clear = clear_frames(model.eval(), torch.from_numpy(np.array(spec)))
        assert clear.mean() > 0.8
        np.testing.assert_array_equal(codes[0][clear], want[0][clear])
        agree = codes[0] == want[0]
        np.testing.assert_array_equal(codes[1][agree], want[1][agree])
        wav, sr = read_wav(tmp_path / "out" / name)
        ref = np.asarray(jvae.decode_from_codes(params, vq_state, jnp.asarray(codes), jcfg.generator))[:, 0]
        assert sr == SR and wav.shape == ref.shape and np.abs(ref).max() > 0.05
        np.testing.assert_allclose(wav, ref, rtol=0, atol=1.0 / 32768 + 2e-4)


# -- presets, full-width shapes and the bridges -----------------------------------------------------------


def _without_tpu_fields(d: dict) -> dict:
    d.pop("spectral_precision")  # an MXU pass count
    return d


@pytest.mark.parametrize("resolution", sorted(jconfig.RESOLUTIONS))
@pytest.mark.parametrize("family", ["vae", "vqvae"])
def test_family_task_configs_equal_jax(family, resolution):
    want = _without_tpu_fields(dataclasses.asdict(jconfig.build_task_config(family=family, resolution=resolution)))
    assert dataclasses.asdict(tconfig.build_task_config(family=family, resolution=resolution)) == want


@pytest.mark.parametrize("family", ["vae", "vqvae"])
def test_full_width_parameter_shapes_match_jax(family):
    """The 44.1 kHz presets' generators (vae: ConvNeXt (3, 3, 9, 3) x (128 ... 512) over 1,025 bins;
    vqvae: a 16-layer WaveNet of 256, a 4,096 x 512 codebook): every port tensor against the shape of the
    JAX init's, through the bridge, on the meta device."""
    tcfg = tconfig.build_task_config(family=family).generator
    jcfg = jconfig.build_task_config(family=family).generator
    init = jvae.vae_init if family == "vae" else jvae.vqvae_init
    shapes = jax.eval_shape(lambda k: init(k, jcfg), jax.random.key(0))
    meta = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"), shapes)
    sd = vae_state_dict_from_jax(meta) if family == "vae" else vqvae_state_dict_from_jax(*meta)
    module = (vae.VAEGenerator if family == "vae" else vae.VQVAEGenerator)(tcfg, device="meta")
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


@pytest.mark.parametrize("case", ["vae", "vae_wavenet", "vqvae", "bnvae"])
def test_bridge_round_trip_is_bit_exact(case):
    """port -> the JAX package's from_torch_state_dict (and its EMA/BatchNorm state) -> the port's bridge."""
    if case == "vae_wavenet":
        tgen, jgen = _family_cfgs("vae")
        enc = dict(ENC, out_channels=12)
        tgen = dataclasses.replace(tgen, encoder_kind="wavenet", encoder=wavenet.PosteriorEncoderConfig(**enc))
        jgen = dataclasses.replace(jgen, encoder_kind="wavenet", encoder=jwavenet.PosteriorEncoderConfig(**enc))
    elif case == "bnvae":
        tgen = wavenet.PosteriorEncoderConfig(mode="bnvae", **ENC)
        sd = wavenet.random_state_dict(tgen, 3)
        jgen = jwavenet.PosteriorEncoderConfig(mode="bnvae", **ENC)
        back = wavenet_state_dict_from_jax(jax.tree.map(np.asarray, jwavenet.from_torch_state_dict(sd, jgen)),
                                           bn_state=jwavenet.bn_state_from_torch(sd))
        assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
        wavenet.PosteriorEncoder(tgen).load_state_dict(back)
        return
    else:
        tgen, jgen = _family_cfgs(case)
    family = "vae" if case.startswith("vae") else "vqvae"
    sd = (vae.vae_random_state_dict if family == "vae" else vae.vqvae_random_state_dict)(tgen, 3)
    enc = (jconvnext.from_torch_state_dict(sd, jgen.encoder, "encoder.") if case == "vae"
           else jwavenet.from_torch_state_dict(sd, jgen.encoder, "encoder."))
    dec = jhifigan.from_torch_state_dict(sd, jgen.decoder, "decoder.")
    params = jax.tree.map(np.asarray, {"encoder": enc, "decoder": dec})
    if family == "vae":
        back = vae_state_dict_from_jax(params)
    else:
        vq_state = {"layers": [{k: np.asarray(sd[f"vq.layers.{i}.{k}"]) for k in ("embed", "embed_avg", "cluster_size")}
                               for i in range(2)]}
        back = vqvae_state_dict_from_jax(params, vq_state)
        assert set(vq_state_dict_from_jax(vq_state)) == {k for k in sd if k.startswith("vq.")}
    assert set(back) == set(sd)
    for key in sd:
        torch.testing.assert_close(back[key], sd[key], rtol=0, atol=0)
    (vae.VAEGenerator if family == "vae" else vae.VQVAEGenerator)(tgen).load_state_dict(back)


@pytest.mark.parametrize("drift", [-3, 0, 5, -4, 6])
def test_length_fix_equals_jax(drift):
    """A codec's output within one hop (4) of the audio's length is cut or zero-padded as JAX's
    ``_length_fix`` does; further off, both refuse."""
    fake = np.random.default_rng(8).standard_normal((2, 1, 40 + drift)).astype(np.float32)
    if abs(drift) > HOP:
        with pytest.raises(AssertionError):
            jgan._length_fix(jnp.asarray(fake), 40, HOP)
        with pytest.raises(ValueError, match="more than a hop"):
            gan._length_fix(torch.from_numpy(fake), 40, HOP)
        return
    want = np.asarray(jgan._length_fix(jnp.asarray(fake), 40, HOP))
    np.testing.assert_array_equal(gan._length_fix(torch.from_numpy(fake), 40, HOP).numpy(), want)
