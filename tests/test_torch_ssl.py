"""The ssl family (HuBERT semantic codec) against the JAX package, on the CPU: the post-net, the codec API,
the generator forward, one training step and the eval step after it, and bf16 compute.

Weights come from the JAX package's own ``ssl_init`` (a seeded key) through ``convert.ssl_state_dict_from_jax``;
the features, the backbone's output, are the same numpy arrays (seeded, of unit scale like HuBERT's
layer-normed states) in both packages, so no backbone runs here (``tests/test_torch_hubert.py`` holds it).
A random post-net's latents vary little, so against unit-normal codebooks every frame would take one code:
``fit`` puts the first codebook on latent frames plus noise, the second at that scale about 0, in both
packages.  Compared at rtol 2e-4 / atol 2e-5 (the JAX kernel tests' tolerance), codes on the frames whose
first-quantiser margin (second-best minus best squared distance, float64) exceeds ``MARGIN_REL`` of the
frame's squared norm (these latents sit about a common mean, so an absolute margin, as
``tests/test_torch_codec.py`` takes, would say little: fp32 rounds a distance to ~1e-7 of that norm), the
training step as ``tests/test_torch_family_train.py`` compares a vqvae's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codec import margins
from tests.test_torch_family_train import discriminators_to_jax, vq_to_jax
from tests.test_torch_train import ATOL, COMMON, HOP, RES, RTOL, _assert_adam_updates_close, _assert_trees_close, _batch
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu import config as jconfig
from vocoder_tpu.convert import conv1d_from_torch
from vocoder_tpu.models import hifigan as jhifigan
from vocoder_tpu.models import mpd as jmpd
from vocoder_tpu.models import mrd as jmrd
from vocoder_tpu.models import ssl_encoders as jssl
from vocoder_tpu.models import vae as jvae
from vocoder_tpu.models import vq as jvq
from vocoder_tpu.train import gan as jgan
from vocoder_tpu.train.schedule import WarmupCosineConfig as JWarmupCosine
from vocoder_tpu_torch import config as tconfig
from vocoder_tpu_torch.convert import ssl_state_dict_from_jax
from vocoder_tpu_torch.models import hifigan, mpd, mrd, ssl_encoders, vae, vq
from vocoder_tpu_torch.train import gan
from vocoder_tpu_torch.train.schedule import WarmupCosineConfig

HIDDEN, LATENT = 8, 6
DEC = dict(hop_length=HOP, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 2),), upsample_initial_channel=16)
MARGIN_REL = 1e-4
FRAMES = 2 * COMMON["num_frames"] - 1  # HuBERT frames of a clip: (63 + 1) // 2 = 32 latent frames, 128 samples


def generator_configs():
    """(port, JAX) tiny ssl generator configs: 8-wide features, 6 latent channels, 2 quantisers of 24 codes."""
    def build(m):
        return m["vae"].SSLCodecGeneratorConfig(
            latent_size=LATENT, hubert=m["ssl"].HubertEncoderConfig(hidden_size=HIDDEN, output_size=LATENT),
            decoder=m["hifigan"].HiFiGANConfig(num_mels=LATENT, **DEC),
            vq=m["vq"].VQConfig(dim=LATENT, codebook_size=24, num_quantizers=2))

    return (build(dict(vae=vae, ssl=ssl_encoders, hifigan=hifigan, vq=vq)),
            build(dict(vae=jvae, ssl=jssl, hifigan=jhifigan, vq=jvq)))


def task_configs():
    tgen, jgen = generator_configs()
    kw = dict(COMMON, generator_name="ssl", family="ssl", input_transform="linear", crop_length=HOP * 8)
    jcfg = jgan.GANTaskConfig(generator=jgen, mpd=jmpd.MPDConfig(periods=(2, 3), channels=(1, 4, 8)),
                              mrd=jmrd.MRDConfig(resolutions=RES),
                              schedule=JWarmupCosine(val_base=2e-4, max_decay_steps=1000), **kw)
    tcfg = gan.GANTaskConfig(generator=tgen, mpd=mpd.MPDConfig(periods=(2, 3), channels=(1, 4, 8)),
                             mrd=mrd.MRDConfig(resolutions=RES), schedule=WarmupCosineConfig(val_base=2e-4,
                                                                                           max_decay_steps=1000), **kw)
    return jcfg, tcfg


def features(n: int = 2, frames: int = FRAMES, seed: int = 11) -> np.ndarray:
    """(n, frames, HIDDEN) stand-ins for HuBERT's layer-normed states: a slow random walk plus noise, of
    unit scale, so that neighbouring frames differ."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.standard_normal((n, frames, HIDDEN)), axis=1) / np.sqrt(frames)
    return (walk + 0.5 * rng.standard_normal((n, frames, HIDDEN))).astype(np.float32)


def fit(params, vq_state, jgen, seed: int = 12) -> dict:
    """``vq_state`` with the first codebook on latent frames of ``features()`` plus noise of 0.3 of their
    spread (``embed_avg`` with it), the second at that scale about 0."""
    lat = np.asarray(jvae.ssl_encode(params, jnp.asarray(features(4, seed=seed)), jgen))
    frames = lat.transpose(0, 2, 1).reshape(-1, LATENT)
    rng = np.random.default_rng(seed)
    k, scale = jgen.vq.codebook_size, 0.3 * frames.std(0)
    rows = [frames[rng.choice(len(frames), k, replace=False)] + scale * rng.standard_normal((k, LATENT)),
            scale * rng.standard_normal((k, LATENT))]
    layers = [{**layer, "embed": jnp.asarray(r, jnp.float32), "embed_avg": jnp.asarray(r, jnp.float32)}
              for layer, r in zip(vq_state["layers"], rows)]
    return {"layers": layers}


def codec():
    """(port task, JAX task, port generator, JAX params, JAX vq state): JAX's ssl_init from key 0, the
    codebooks fitted, bridged into the port."""
    jcfg, tcfg = task_configs()
    params, vq_state = jvae.ssl_init(jax.random.key(0), jcfg.generator)
    vq_state = fit(params, vq_state, jcfg.generator)
    model = vae.SSLCodecGenerator(tcfg.generator)
    model.load_state_dict(ssl_state_dict_from_jax(jax.tree.map(np.asarray, params),
                                                  jax.tree.map(np.asarray, vq_state)))
    return tcfg, jcfg, model, params, vq_state


def _close(got, want, **kw):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL, **kw)


def generator_to_jax(sd: dict) -> dict:
    """The port ssl generator's tensors by name (weights or gradients) -> the JAX parameter tree."""
    _, jgen = generator_configs()
    return {"postnet": {n: conv1d_from_torch(sd, f"postnet.{n}") for n in ("post0", "post1", "post2")},
            "decoder": jhifigan.from_torch_state_dict(sd, jgen.decoder, "decoder.")}


@pytest.mark.parametrize("frames", [FRAMES, FRAMES + 1, 5])
def test_postnet_matches_jax(frames):
    """hubert_postnet_apply of the same features and weights, (T' + 1) // 2 frames, channels-first here."""
    tcfg, jcfg, model, params, _ = codec()
    x = features(2, frames)
    want = np.asarray(jssl.hubert_postnet_apply(params["postnet"], jnp.asarray(x))).transpose(0, 2, 1)
    with torch.no_grad():
        got = model.postnet(torch.from_numpy(x))
    assert got.shape == (2, LATENT, (frames + 1) // 2)
    _close(got, want)


def test_ssl_codec_api_matches_jax():
    """encode_to_codes against ssl_encode_to_codes (equal on the frames clear of a tie in the first quantiser
    and wherever the first codes agree; many codes taken), decode_from_codes against ssl_decode_from_codes."""
    tcfg, jcfg, model, params, vq_state = codec()
    x = features(2, FRAMES, seed=13)
    want = np.asarray(jvae.ssl_encode_to_codes(params, vq_state, jnp.asarray(x), jcfg.generator))
    model.eval()
    with torch.no_grad():
        got = model.encode_to_codes(torch.from_numpy(x)).numpy()
        latent = model.encode(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 2, (FRAMES + 1) // 2)
    flat = latent.transpose(1, 2).reshape(-1, LATENT).numpy()
    clear = (margins(flat, model.vq.layers[0].embed.numpy()) > MARGIN_REL * (flat ** 2).sum(1)).reshape(2, -1)
    assert clear.mean() > 0.8 and len(np.unique(want[0])) > 8
    np.testing.assert_array_equal(got[0][clear], want[0][clear])
    agree = got[0] == want[0]
    np.testing.assert_array_equal(got[1][agree], want[1][agree])
    with torch.no_grad():
        audio = model.decode_from_codes(torch.from_numpy(want.astype(np.int64)))
    assert audio.shape == (2, 1, (FRAMES + 1) // 2 * HOP)
    _close(audio, jvae.ssl_decode_from_codes(params, vq_state, jnp.asarray(want), jcfg.generator))


@pytest.mark.parametrize("training", [False, True])
def test_ssl_forward_matches_jax(training):
    """``generator_forward`` with the features as input, eval and training: the fake (length-fixed to the
    audio), the base loss 0, the VQ metric; a training forward's EMA update gives JAX's new codebooks.
    Without features the forward refuses."""
    tcfg, jcfg, model, params, vq_state = codec()
    audio = _batch(tcfg)["audio"]
    x = features()
    want_fake, want_base, want_extra, want_metrics = jgan.generator_forward(
        params, jnp.asarray(audio), jcfg, training=training, rng=jax.random.key(0), extra={"vq": vq_state},
        input_spec=jnp.asarray(x))
    fake, base, metrics, ema = gan.generator_forward(model.train(training), torch.from_numpy(audio), tcfg,
                                                     features=torch.from_numpy(x))
    assert fake.shape == audio.shape and set(metrics) == set(want_metrics) == {"train/generator/vq"}
    _close(fake, want_fake)
    _close(base, want_base)
    _close(metrics["train/generator/vq"], want_metrics["train/generator/vq"])
    assert (ema is not None) == training
    if ema is not None:
        ema()
        for i, want in enumerate(want_extra["vq"]["layers"]):
            for k in ("embed", "embed_avg", "cluster_size"):
                _close(getattr(model.vq.layers[i], k), want[k], err_msg=f"{i}.{k}")
    with pytest.raises(ValueError, match="ssl_features"):
        gan.generator_forward(model, torch.from_numpy(audio), tcfg)


def _train_setup(compute_dtype: str = "float32"):
    """(JAX task, port task, port state, JAX state, numpy batch with features) from the same weights."""
    jcfg, tcfg = task_configs()
    jcfg, tcfg = jcfg.replace(compute_dtype=compute_dtype), tcfg.replace(compute_dtype=compute_dtype)
    _, _, _, params, vq_state = codec()
    state = gan.create_train_state(tcfg, 0, "cpu")
    state.generator.load_state_dict(ssl_state_dict_from_jax(jax.tree.map(np.asarray, params),
                                                            jax.tree.map(np.asarray, vq_state)))
    dp = discriminators_to_jax(jcfg, {k: v.clone() for k, v in state.discriminators.state_dict().items()})
    tx = jgan.make_optimizer(jcfg)
    jstate = jgan.TrainState(step=jnp.zeros((), jnp.int32), gen_params=params, disc_params=dp,
                             opt_g=tx.init(params), opt_d=tx.init(dp), rng=jax.random.key(3),
                             extra={"vq": vq_state})
    batch = {**_batch(tcfg), "ssl_features": features()}
    return jcfg, tcfg, state, jstate, batch


def test_ssl_train_step_matches_jax():
    """One step against ``make_train_step`` (the crop start JAX draws): every metric, the generator's
    (post-net, decoder) and the discriminators' gradients, the updated parameters under Adam's sign
    caveat, the EMA codebooks; then the eval step on what the port step left against JAX's."""
    jcfg, tcfg, state, jstate, batch = _train_setup()
    gp, dp, extra = jstate.gen_params, jstate.disc_params, jstate.extra
    t = batch["audio"].shape[2]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, step_rng = jax.random.split(jstate.rng)
    start = int(jax.random.randint(jax.random.split(step_rng)[0], (), 0, t - jcfg.crop_length))

    @jax.jit
    def jax_step(jstate, jbatch):
        mask = jgan.sequence_mask(jbatch["lengths"], t)
        (_, (_, audio_c, fake_c, _)), grads_g = jax.value_and_grad(jgan._generator_loss, has_aux=True)(
            jstate.gen_params, jstate.disc_params, jbatch["audio"], mask, jcfg, step_rng, jstate.extra, None,
            jbatch["ssl_features"])
        grads_d, _ = jax.grad(jgan._discriminator_loss_fn, has_aux=True)(jstate.disc_params, audio_c, fake_c, jcfg)
        return jgan.make_train_step(jcfg)(jstate, jbatch), grads_g, grads_d

    (new_jstate, jmetrics), jgrads_g, jgrads_d = jax_step(jstate, jbatch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = gan.make_train_step(tcfg)(state, tbatch, start)
    assert state.step == 1 and set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(metrics["train/generator/vq"]) > 0 and float(metrics["train/generator/base"]) == 0.0

    grads_g = generator_to_jax({n: p.grad for n, p in state.generator.named_parameters()})
    grads_d = discriminators_to_jax(jcfg, {n: p.grad for n, p in state.discriminators.named_parameters()})
    _assert_trees_close(grads_g, jgrads_g, "generator gradient")
    _assert_trees_close(grads_d, jgrads_d, "discriminator gradient")
    new_sd = state.generator.state_dict()
    new_g, new_d = generator_to_jax(new_sd), discriminators_to_jax(jcfg, state.discriminators.state_dict())
    lr = float(jmetrics["lr"])
    for new, old, want, grads, jgrads in ((new_g, gp, new_jstate.gen_params, grads_g, jgrads_g),
                                          (new_d, dp, new_jstate.disc_params, grads_d, jgrads_d)):
        err = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()), grads, jgrads)
        _assert_adam_updates_close(new, old, want, jgrads, err, lr, tcfg.weight_decay)
    got = vq_to_jax(new_sd, 2)
    assert not np.array_equal(np.asarray(got["layers"][0]["embed"]), np.asarray(extra["vq"]["layers"][0]["embed"]))
    _assert_trees_close(got, new_jstate.extra["vq"], "EMA codebook")

    jeval = jgan.TrainState(step=jnp.ones((), jnp.int32), gen_params=new_g, disc_params=new_d, opt_g=None,
                            opt_d=None, rng=jax.random.key(0), extra={"vq": got})
    jm, jfake = jax.jit(jgan.make_eval_step(jcfg))(jeval, jbatch)
    em, fake = gan.make_eval_step(tcfg)(state, tbatch)
    np.testing.assert_allclose(float(em["val/metrics/mel"]), float(jm["val/metrics/mel"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fake.numpy(), np.asarray(jfake), rtol=RTOL, atol=ATOL)
    assert all(torch.equal(new_sd[k], v) for k, v in state.generator.state_dict().items())


def test_bf16_keeps_the_ssl_generator_fp32_and_runs_the_discriminators_in_bf16():
    """Under compute_dtype=bfloat16 the JAX package casts the generator in the "gan" family only: its ssl
    forward is the fp32 forward to the bit, and so is the port's, which matches it; every conv of the
    port's generator sees fp32 inputs and weights, every conv of its discriminators bf16 ones, in the step
    and in validation (which runs the generator itself, no bf16 copy).  oneDNN is off, as in
    ``tests/test_torch_bf16_train.py``: its CPU bf16 conv2d is wrong where an output is one column wide with
    padding past the input (the MRD's of this 32-sample crop)."""
    with torch.backends.mkldnn.flags(enabled=False):
        check_bf16_step()


def check_bf16_step():
    jcfg, tcfg, state, jstate, batch = _train_setup("bfloat16")
    audio, x = jnp.asarray(batch["audio"]), jnp.asarray(batch["ssl_features"])
    kw = dict(training=False, extra=jstate.extra, input_spec=x)
    jbf16 = jgan.generator_forward(jstate.gen_params, audio, jcfg, **kw)[0]
    jfp32 = jgan.generator_forward(jstate.gen_params, audio, jcfg.replace(compute_dtype="float32"), **kw)[0]
    np.testing.assert_array_equal(np.asarray(jbf16), np.asarray(jfp32))
    assert gan.eval_generator(state.generator, tcfg) is state.generator
    seen = {"generator": set(), "discriminators": set()}

    def record(part):
        return lambda m, args: seen[part].add((args[0].dtype, m.weight.dtype))

    for part, module in (("generator", state.generator), ("discriminators", state.discriminators)):
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.ConvTranspose1d)):
                m.register_forward_pre_hook(record(part))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state.generator.eval()
    with torch.no_grad():
        fake = gan.generator_forward(state.generator, tbatch["audio"], tcfg, features=tbatch["ssl_features"])[0]
    state.generator.train()
    np.testing.assert_allclose(fake.numpy(), np.asarray(jfp32), rtol=RTOL, atol=ATOL)
    metrics = gan.make_train_step(tcfg)(state, tbatch, 0)
    gan.make_eval_step(tcfg)(state, tbatch)
    assert seen["generator"] == {(torch.float32, torch.float32)}
    assert seen["discriminators"] == {(torch.bfloat16, torch.bfloat16)}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in [*state.generator.parameters(), *state.discriminators.parameters()])


@pytest.mark.parametrize("resolution", sorted(jconfig.RESOLUTIONS))
def test_ssl_task_config_equals_jax(resolution):
    """The ssl task of each resolution, field by field (hubert, decoder at the hop's rates, the 4,096 x 512
    codebook, MPD (2, 3, 5, 7, 11), four MRD resolutions, 32 frames), but the TPU-only spectral_precision."""
    want = dataclasses.asdict(jconfig.build_task_config(family="ssl", resolution=resolution))
    want.pop("spectral_precision")
    assert dataclasses.asdict(tconfig.build_task_config(family="ssl", resolution=resolution)) == want


def test_full_width_parameter_shapes_match_jax():
    """The 16 kHz preset's generator (a 768 -> 512 post-net, a 4,096 x 512 codebook, a 512-channel decoder at
    hop 640): every tensor of the port's module against the JAX init's shapes through the bridge, on meta."""
    tcfg = tconfig.build_task_config(family="ssl", resolution="16000_640_2048").generator
    jcfg = jconfig.build_task_config(family="ssl", resolution="16000_640_2048").generator
    shapes = jax.eval_shape(lambda k: jvae.ssl_init(k, jcfg), jax.random.key(0))
    meta = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"), shapes)
    sd = ssl_state_dict_from_jax(*meta)
    want = {k: tuple(v.shape) for k, v in vae.SSLCodecGenerator(tcfg, device="meta").state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert want["postnet.post0.weight"] == (512, 768, 3) and tcfg.decoder.upsample_rates == (8, 5, 4, 2, 2)
