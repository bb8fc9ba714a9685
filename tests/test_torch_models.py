"""The port's BigVGAN, weights bridge, presets and inference CLI against the JAX package, on the CPU."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocoder_tpu import config as jconfig
from vocoder_tpu.models import bigvgan as jbigvgan
from vocoder_tpu_torch import config as tconfig
from vocoder_tpu_torch.cli import infer
from vocoder_tpu_torch.convert import bigvgan_state_dict_from_jax, load_reference_state_dict
from vocoder_tpu_torch.data.audio_io import read_wav, write_wav
from vocoder_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, random_state_dict
from vocoder_tpu_torch.models.registry import get_generator
from vocoder_tpu_torch.nn import fold_weight_norm

REPO = Path(__file__).resolve().parents[1]

NARROW = dict(
    hop_length=16, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 7, 11),
    resblock_dilation_sizes=((1, 3, 5),) * 3, num_mels=8, upsample_initial_channel=32,
)


def _random_jax_params(cfg, rng):
    """A JAX BigVGAN parameter tree from numpy, at a scale where tanh stays off its rails."""
    shapes = jax.eval_shape(lambda key: jbigvgan.init(key, cfg), jax.random.key(0))

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['v']"):
            return rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("['g']"):
            gain = 0.3 if "conv_post" in name else 0.6
            return (gain * (1 + 0.1 * rng.standard_normal(s.shape))).astype(np.float32)
        if name.endswith("['b']"):
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        linear = not cfg.snake_logscale and "post_act" not in name
        return ((1.0 if linear else 0.0) + 0.2 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_model(params, cfg_kw) -> BigVGAN:
    model = BigVGAN(BigVGANConfig(**cfg_kw))
    model.load_state_dict(bigvgan_state_dict_from_jax(params))
    return fold_weight_norm(model).eval()


@pytest.mark.parametrize("activation", ["snake", "snakebeta"])
@pytest.mark.parametrize("logscale", [True, False])
def test_bigvgan_matches_jax_apply(activation, logscale):
    kw = dict(NARROW, activation=activation, snake_logscale=logscale)
    cfg = jbigvgan.BigVGANConfig(**kw)
    rng = np.random.default_rng(7)
    params = _random_jax_params(cfg, rng)
    mel = rng.standard_normal((2, 8, 24)).astype(np.float32)

    want = np.asarray(jbigvgan.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(mel), cfg))
    with torch.inference_mode():
        got = _port_model(params, kw)(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 1, 24 * 16)
    assert 0.05 < np.abs(want).max() < 0.99  # the comparison is not hidden by tanh saturation
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_bridge_full_width_shapes_without_weights():
    """The 44.1 kHz preset: the bridge maps JAX's abstract parameter shapes
    onto exactly the port model's state_dict, on the meta device."""
    jcfg = jconfig.build_task_config("bigvgan", "44100_512_2048").generator
    tcfg = tconfig.build_task_config("bigvgan", "44100_512_2048").generator
    shapes = jax.eval_shape(lambda key: jbigvgan.init(key, jcfg), jax.random.key(0))
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    bridged = bigvgan_state_dict_from_jax(meta)
    port = BigVGAN(tcfg, device="meta").state_dict()
    assert set(bridged) == set(port)
    assert {k: tuple(v.shape) for k, v in bridged.items()} == {k: tuple(v.shape) for k, v in port.items()}


@pytest.mark.parametrize("activation", ["snake", "snakebeta"])
def test_bridge_round_trip_is_bit_exact(activation):
    """port -> JAX from_torch_state_dict -> bigvgan_state_dict_from_jax -> port."""
    kw = dict(NARROW, activation=activation)
    sd = random_state_dict(BigVGANConfig(**kw), seed=3)
    params = jbigvgan.from_torch_state_dict(sd, jbigvgan.BigVGANConfig(**kw))
    back = bigvgan_state_dict_from_jax(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd)
    for key in sd:
        torch.testing.assert_close(back[key], sd[key], rtol=0, atol=0)
    BigVGAN(BigVGANConfig(**kw)).load_state_dict(back)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_plan_is_a_cache_outside_the_state_dict(dtype):
    """The kernel's per-model launch arguments (weights packed as (K, C, C) in
    the model's dtype) are built once, rebuilt after an in-place weight change,
    and leave state_dict() as it was, keys and values, so the bridge tests above
    cover a model that has run."""
    from vocoder_tpu_torch.ops.amp_block import ROUTES, stage_plan

    cfg = BigVGANConfig(**NARROW)
    model = BigVGAN(cfg)
    model.load_state_dict(random_state_dict(cfg, seed=5))
    model = fold_weight_norm(model).to(dtype).eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    blocks = list(model.resblocks[:3])
    plan = stage_plan(blocks, True)
    assert plan.route == ROUTES[dtype] and len(plan.params) == 18
    conv = blocks[0].convs1[0]
    w0 = plan.weights[0].clone()
    want = conv.weight.detach().permute(2, 0, 1)
    assert torch.equal(w0, want) and plan.params[0].w == plan.weights[0].data_ptr()
    assert stage_plan(blocks, True) is plan  # cached
    with torch.inference_mode():
        model(torch.zeros(1, 8, 6, dtype=dtype))
    with torch.no_grad():
        conv.weight.mul_(2.0)
    rebuilt = stage_plan(blocks, True)
    assert rebuilt is not plan and torch.equal(rebuilt.weights[0], 2 * w0)
    with torch.no_grad():
        conv.weight.mul_(0.5)

    after = model.state_dict()
    assert list(after) == list(before)
    for key, val in before.items():
        assert torch.equal(after[key], val), key


def test_reference_checkpoint_layouts(tmp_path):
    """generator.-prefixed checkpoints with parametrized, legacy or folded weight norm load alike."""
    cfg = BigVGANConfig(**NARROW)
    sd = random_state_dict(cfg, seed=4)
    model = BigVGAN(cfg)
    model.load_state_dict(sd)
    folded = fold_weight_norm(BigVGAN(cfg))
    folded.load_state_dict(fold_weight_norm(model).state_dict())
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 8, 12)).astype(np.float32))
    with torch.inference_mode():
        want = folded(mel)

    legacy = {}
    for k, v in sd.items():
        k = k.replace("parametrizations.weight.original0", "weight_g").replace("parametrizations.weight.original1",
                                                                                "weight_v")
        legacy[f"generator.{k}"] = v
    legacy["generator.resblocks.0.activations.0.upsample.filter"] = torch.zeros(1, 1, 12)
    legacy["discriminator.x"] = torch.zeros(1)
    for name, state in (("legacy", legacy),
                        ("folded", {f"generator.{k}": v for k, v in folded.state_dict().items()})):
        torch.save({"state_dict": state}, tmp_path / f"{name}.ckpt")
        loaded = BigVGAN(cfg)
        loaded.load_state_dict(load_reference_state_dict(tmp_path / f"{name}.ckpt"))
        m = fold_weight_norm(loaded).eval()
        with torch.inference_mode():
            torch.testing.assert_close(m(mel), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("resolution", sorted(jconfig.RESOLUTIONS))
def test_presets_equal_jax_package(resolution):
    assert tconfig.RESOLUTIONS == jconfig.RESOLUTIONS
    assert tconfig._UPSAMPLE_PRESETS == jconfig._UPSAMPLE_PRESETS
    for hop in (128, 300, 512, 640, 1000, 2048):
        assert tconfig.upsample_rates_for_hop(hop) == jconfig.upsample_rates_for_hop(hop)
    want = jconfig.build_task_config("bigvgan", resolution)
    got = tconfig.build_task_config("bigvgan", resolution)
    for field in ("sampling_rate", "n_fft", "hop_length", "win_length", "num_mels", "generator_name"):
        assert getattr(got, field) == getattr(want, field), field
    tfields = {f.name for f in BigVGANConfig.__dataclass_fields__.values()}
    jfields = {f.name for f in jbigvgan.BigVGANConfig.__dataclass_fields__.values()}
    assert tfields == jfields
    for field in tfields:
        assert getattr(got.generator, field) == getattr(want.generator, field), field


def test_unknown_generator_raises():
    """Every name of the JAX registry is ported (tests/test_torch_families.py builds each preset); an
    unknown name raises KeyError, as in the JAX package."""
    with pytest.raises(KeyError, match="unknown generator"):
        get_generator("wavenet")
    with pytest.raises(KeyError, match="unknown generator preset"):
        tconfig.build_task_config("wavenet")


def test_cuda_is_required_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        infer.resolve_device("cuda")
    assert infer.resolve_device("cpu") == torch.device("cpu")


def test_infer_cli_on_cpu_matches_jax_apply(tmp_path, monkeypatch):
    """cli/infer.py --device cpu on a tiny config saved as a generator. checkpoint:
    the WAVs equal the JAX package's bigvgan.apply on the same mels and weights."""
    from vocoder_tpu.ops.spectral import log_mel_spectrogram as jlog_mel
    from vocoder_tpu.parallel.streaming import chunked_synthesis as jchunked

    kw = dict(NARROW, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))  # (3, 7, 11): test_bigvgan_matches_jax_apply
    task = tconfig.GANTaskConfig(sampling_rate=8000, n_fft=64, hop_length=16, win_length=64, num_mels=8,
                                 generator_name="bigvgan", generator=BigVGANConfig(**kw))
    monkeypatch.setattr(infer, "build_task_config", lambda model, resolution: task)
    jcfg = jbigvgan.BigVGANConfig(**kw)
    rng = np.random.default_rng(11)
    params = _random_jax_params(jcfg, rng)
    sd = bigvgan_state_dict_from_jax(params)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in sd.items()}}, tmp_path / "g.ckpt")

    (tmp_path / "in").mkdir()
    audio = (0.3 * np.sin(np.arange(700) / 7.0) + 0.01 * rng.standard_normal(700)).astype(np.float32)
    write_wav(tmp_path / "in" / "a.wav", audio, 8000)
    short = (rng.standard_normal((8, 44)) - 2.0).astype(np.float32)  # a.wav's frame count: one JAX compile
    long = (rng.standard_normal((8, 150)) - 2.0).astype(np.float32)  # past --chunk-frames
    np.save(tmp_path / "in" / "short.npy", short)
    np.save(tmp_path / "in" / "long.npy", long.T)  # (F, num_mels): the CLI transposes it
    (tmp_path / "in" / "notes.txt").write_text("not audio")

    infer.main(["--model", "bigvgan", "--resolution", "tiny", "--ckpt", str(tmp_path / "g.ckpt"),
                "--input", str(tmp_path / "in"), "--output", str(tmp_path / "out"), "--device", "cpu",
                "--chunk-frames", "72"])
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["a.wav", "long.wav", "short.wav"]

    jparams = jax.tree.map(jnp.asarray, params)
    apply = jax.jit(lambda m: jbigvgan.apply(jparams, m, jcfg))  # one compile per shape, not per op

    wav_audio, _ = read_wav(tmp_path / "in" / "a.wav")
    jmel = jlog_mel(jnp.asarray(np.pad(wav_audio, ((0, 0), (0, (-700) % 16)))), sample_rate=8000, n_fft=64,
                    hop_length=16, win_length=64, n_mels=8, f_max=4000)
    cases = {
        "short.wav": np.asarray(apply(jnp.asarray(short[None]))),
        "long.wav": np.asarray(jchunked(apply, jnp.asarray(long[None]), hop_length=16, chunk_frames=72,
                                        overlap_frames=32)),
        "a.wav": np.asarray(apply(jmel)),
    }
    quantum = 1.0 / 32768
    for name, want in cases.items():
        got, sr = read_wav(tmp_path / "out" / name)
        assert sr == 8000 and got.shape == want[:, 0].shape, name
        # 16-bit PCM: within one quantum plus the fp32 parity tolerance.
        np.testing.assert_allclose(got, want[:, 0], rtol=0, atol=quantum + 2e-4, err_msg=name)


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in (REPO / "vocoder_tpu_torch").rglob("*.py")) + ["chip_smoke.py"],
)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for name in _imports(REPO / path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "orbax", "vocoder_tpu", "transformers", "safetensors"), (
            path, name)
