"""Exact variable-length batching in the port (``lengths``, ``frame_lengths``, ``--batch``), on the CPU.

The same numpy inputs go through the JAX package's masked functions and the
port's plain versions (CPU tensors), and a right-padded batch is held
against each item run alone.  Layouts: JAX is (B, T, C), the port (B, C, T).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu.models import bigvgan as jbigvgan
from vocoder_tpu.ops import antialias as jaa
from vocoder_tpu_torch.cli import infer
from vocoder_tpu_torch.config import GANTaskConfig
from vocoder_tpu_torch.convert import bigvgan_state_dict_from_jax
from vocoder_tpu_torch.data.audio_io import read_wav, write_wav
from vocoder_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, random_state_dict
from vocoder_tpu_torch.nn import fold_weight_norm
from vocoder_tpu_torch.ops import antialias as taa
from vocoder_tpu_torch.ops.aa_snake import aa_snake
from vocoder_tpu_torch.ops.amp_block import amp_stage, amp_stage_plain

NARROW = dict(
    hop_length=16, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 7),
    resblock_dilation_sizes=((1, 3), (1, 3)), num_mels=8, upsample_initial_channel=32,
)


def _to_port(x: np.ndarray) -> torch.Tensor:  # (B, T, C) -> (B, C, T)
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def _from_port(x: torch.Tensor) -> np.ndarray:
    return x.detach().numpy().transpose(0, 2, 1)


def _padded(rng, lengths, t, c, scale=1.0):
    """(B, T, C) normal rows, each zero past its length, as a padded batch carries them."""
    x = (scale * rng.standard_normal((len(lengths), t, c))).astype(np.float32)
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    return x


def _snake_params(rng, c):
    return ((0.3 * rng.standard_normal(c)).astype(np.float32), (0.3 * rng.standard_normal(c)).astype(np.float32))


@pytest.mark.parametrize("logscale", [True, False])
def test_masked_aa_snake_plain_matches_jax_masked_and_per_item(logscale):
    """Lengths >= 32 (the JAX masked version's floor): the port's plain aa-snake with lengths
    equals JAX's aa_snake_poly4_masked and each item's aa_snake_poly4 alone; zeros past each length."""
    rng = np.random.default_rng(0)
    lengths = [96, 57, 32]
    x = _padded(rng, lengths, 96, 8)
    alpha, beta = _snake_params(rng, 8)
    if not logscale:
        alpha, beta = np.abs(alpha) + 0.5, np.abs(beta) + 0.5

    got = _from_port(aa_snake(_to_port(x), torch.from_numpy(alpha), torch.from_numpy(beta), logscale,
                              torch.tensor(lengths)))
    want = np.asarray(jaa.aa_snake_poly4_masked(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta), logscale,
                                                jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    for i, n in enumerate(lengths):
        alone = np.asarray(jaa.aa_snake_poly4(jnp.asarray(x[i : i + 1, :n]), jnp.asarray(alpha),
                                              jnp.asarray(beta), logscale))
        np.testing.assert_allclose(got[i : i + 1, :n], alone, rtol=2e-4, atol=2e-5)
        assert not got[i, n:].any()


@pytest.mark.parametrize("lengths", [[40, 0, 1, 5, 11, 12, 13, 39], [7, 7, 3]])
def test_masked_aa_snake_plain_is_each_item_alone_at_every_length(lengths):
    """Lengths 0, 1 and under the 12-sample halo, which the JAX masked version does not take:
    row i is the unmasked plain aa-snake of item i alone, then zeros; the padding's values never
    reach a row, and lengths past T are clamped to T."""
    rng = np.random.default_rng(1)
    t = max(lengths)
    x = torch.from_numpy(rng.standard_normal((len(lengths), 4, t)).astype(np.float32))  # padding not zeroed
    alpha, beta = (torch.from_numpy(v) for v in _snake_params(rng, 4))
    a, b = taa.snake_params(alpha, beta, True)
    got = aa_snake(x, alpha, beta, True, torch.tensor(lengths))
    for i, n in enumerate(lengths):
        if n:
            torch.testing.assert_close(got[i : i + 1, :, :n], taa.aa_snake_plain(x[i : i + 1, :, :n], a, b),
                                       rtol=0, atol=0)
        assert not got[i, :, n:].any()
    over = taa.aa_snake_plain(x, a, b, torch.full((len(lengths),), t + 5))
    torch.testing.assert_close(over, taa.aa_snake_plain(x, a, b), rtol=0, atol=0)


def _jax_params(cfg, rng):
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
        return (0.2 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_model(params, cfg_kw) -> BigVGAN:
    model = BigVGAN(BigVGANConfig(**cfg_kw))
    model.load_state_dict(bigvgan_state_dict_from_jax(params))
    return fold_weight_norm(model).eval()


def test_masked_amp_stage_plain_matches_jax_amp_apply():
    """The first AMP stage of a narrow BigVGAN with lengths >= 32: the mean of JAX's
    _amp_apply(..., lens) chains, and each item's unmasked stage alone."""
    cfg = jbigvgan.BigVGANConfig(**NARROW)
    rng = np.random.default_rng(2)
    params = _jax_params(cfg, rng)
    model = _port_model(params, NARROW)
    c, lengths = 16, [80, 33, 50]
    x = _padded(rng, lengths, 80, c)
    jp = jax.tree.map(jnp.asarray, params)
    outs = [jbigvgan._amp_apply(jp["resblocks"][j], jnp.asarray(x), k, d, cfg, False, 1, jnp.asarray(lengths))
            for j, (k, d) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))]
    want = np.asarray(sum(outs) / len(outs))
    blocks = list(model.resblocks[:2])
    got = _from_port(amp_stage(blocks, _to_port(x), True, torch.tensor(lengths)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    for i, n in enumerate(lengths):
        alone = _from_port(amp_stage_plain(blocks, _to_port(x[i : i + 1, :n]), True))
        np.testing.assert_allclose(got[i : i + 1, :n], alone, rtol=1e-5, atol=1e-6)
        assert not got[i, n:].any()


def test_bigvgan_frame_lengths_matches_jax_apply():
    """BigVGAN.forward(mel, frame_lengths) against JAX bigvgan.apply(..., frame_lengths=...);
    8 frames is the first stage's 32 samples, the JAX masked aa-snake's floor."""
    cfg = jbigvgan.BigVGANConfig(**NARROW)
    rng = np.random.default_rng(3)
    params = _jax_params(cfg, rng)
    lengths = [24, 15, 8]
    mel = (0.5 * rng.standard_normal((3, 8, 24)) - 1.0).astype(np.float32)
    for i, n in enumerate(lengths):
        mel[i, :, n:] = 0.0
    want = np.asarray(jbigvgan.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(mel), cfg,
                                     frame_lengths=jnp.asarray(lengths)))
    with torch.inference_mode():
        got = _port_model(params, NARROW)(torch.from_numpy(mel), torch.tensor(lengths)).numpy()
    assert got.shape == want.shape == (3, 1, 24 * 16)
    assert 0.05 < np.abs(want).max() < 0.99
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bigvgan_padded_batch_equals_per_item_runs(dtype):
    """Lengths 0 and 1 included: row i, cut to its frames, is item i's own forward, and 0 after;
    a row of length 0 is all zeros.  In bf16 too: the plain path rounds the same values."""
    cfg = BigVGANConfig(**NARROW)
    model = BigVGAN(cfg)
    model.load_state_dict(random_state_dict(cfg, seed=4))
    model = fold_weight_norm(model).to(dtype).eval()
    rng = np.random.default_rng(4)
    lengths = [20, 0, 1, 2, 9]
    mel = torch.from_numpy(rng.standard_normal((len(lengths), 8, 20)).astype(np.float32) - 2.0)
    for i, n in enumerate(lengths):
        mel[i, :, n:] = 0.0
    with torch.inference_mode():
        out = model(mel.to(dtype), torch.tensor(lengths))
        for i, n in enumerate(lengths):
            if n:
                alone = model(mel[i : i + 1, :, :n].to(dtype))
                torch.testing.assert_close(out[i : i + 1, :, : n * 16], alone, rtol=1e-5, atol=1e-6)
            assert not out[i, :, n * 16 :].any()


def _tiny_task(kw) -> GANTaskConfig:
    return GANTaskConfig(sampling_rate=8000, n_fft=64, hop_length=16, win_length=64, num_mels=8,
                         generator_name="bigvgan", generator=BigVGANConfig(**kw))


def test_batched_cli_matches_jax_apply_per_file_and_batch_1(tmp_path, monkeypatch):
    """cli/infer.py --device cpu --batch 3 over WAVs of different lengths (one stereo: four items, so
    the last group is ragged), a .npy mel and one file past --chunk-frames: each WAV equals JAX
    bigvgan.apply on that file alone, and equals the port's --batch 1 WAV.  The model is narrow: the
    CLI's build_task_config is monkeypatched."""
    from vocoder_tpu.ops.spectral import log_mel_spectrogram as jlog_mel

    kw = dict(NARROW, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
    task = _tiny_task(kw)
    monkeypatch.setattr(infer, "build_task_config", lambda model, resolution: task)
    jcfg = jbigvgan.BigVGANConfig(**kw)
    rng = np.random.default_rng(5)
    params = _jax_params(jcfg, rng)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in bigvgan_state_dict_from_jax(params).items()}},
               tmp_path / "g.ckpt")
    (tmp_path / "in").mkdir()
    for name, n, ch in (("a.wav", 700, 1), ("b.wav", 300, 2), ("long.wav", 1500, 1)):
        audio = (0.3 * np.sin(np.arange(n) / (5.0 + ch))[None].repeat(ch, 0)
                 + 0.02 * rng.standard_normal((ch, n))).astype(np.float32)
        write_wav(tmp_path / "in" / name, audio, 8000)
    np.save(tmp_path / "in" / "m.npy", (rng.standard_normal((8, 12)) - 2.0).astype(np.float32))

    outs = {}
    for batch in (3, 1):
        out = tmp_path / f"out{batch}"
        infer.main(["--model", "bigvgan", "--resolution", "tiny", "--ckpt", str(tmp_path / "g.ckpt"),
                    "--input", str(tmp_path / "in"), "--output", str(out), "--device", "cpu",
                    "--chunk-frames", "80", "--batch", str(batch)])
        outs[batch] = {p.name: read_wav(p)[0] for p in sorted(out.iterdir())}
    assert sorted(outs[3]) == ["a.wav", "b.wav", "long.wav", "m.wav"]

    apply = jax.jit(lambda m: jbigvgan.apply(jax.tree.map(jnp.asarray, params), m, jcfg))
    quantum = 1.0 / 32768
    for name in ("a.wav", "b.wav", "m.wav"):
        if name == "m.wav":
            mel = np.load(tmp_path / "in" / "m.npy")[None]
        else:
            audio, _ = read_wav(tmp_path / "in" / name)
            audio = np.pad(audio, ((0, 0), (0, (-audio.shape[-1]) % 16)))
            mel = np.asarray(jlog_mel(jnp.asarray(audio), sample_rate=8000, n_fft=64, hop_length=16,
                                      win_length=64, n_mels=8, f_max=4000))
        want = np.asarray(apply(jnp.asarray(mel)))[:, 0]
        got = outs[3][name]
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=quantum + 2e-4, err_msg=name)
    for name, got in outs[3].items():
        np.testing.assert_allclose(got, outs[1][name], rtol=0, atol=quantum, err_msg=name)


def test_batched_cli_falls_back_per_file_for_an_odd_upsample_stage(tmp_path, monkeypatch, capsys):
    """An upsample stage with odd (kernel - rate) cannot keep exact lengths: --batch falls back."""
    kw = dict(NARROW, upsample_kernel_sizes=(8, 7), resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),))
    task = _tiny_task(kw)
    assert not infer.batchable(task, 4) and infer.batchable(_tiny_task(NARROW), 4)
    assert not infer.batchable(_tiny_task(NARROW), 1)
    monkeypatch.setattr(infer, "build_task_config", lambda model, resolution: task)
    cfg = BigVGANConfig(**kw)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in random_state_dict(cfg, 0).items()}},
               tmp_path / "g.ckpt")
    (tmp_path / "in").mkdir()
    np.save(tmp_path / "in" / "m.npy", np.zeros((8, 6), np.float32))
    infer.main(["--model", "bigvgan", "--resolution", "tiny", "--ckpt", str(tmp_path / "g.ckpt"), "--input",
                str(tmp_path / "in"), "--output", str(tmp_path / "out"), "--device", "cpu", "--batch", "4"])
    assert "falling back to per-file synthesis" in capsys.readouterr().out
    assert (tmp_path / "out" / "m.wav").is_file()


@pytest.mark.parametrize("semitones", [3.0, -5.0])
def test_pitch_shift_matches_jax_load_mel_item(tmp_path, semitones):
    """--pitch-shift: two resamples before the log-mel, as JAX's _load_mel_item does them; the shifted,
    padded audio beside the mel (what an f0 template is made from) is JAX's too."""
    import argparse

    from vocoder_tpu.cli import infer as jinfer
    from vocoder_tpu.ops.spectral import log_mel_spectrogram as jlog_mel

    rng = np.random.default_rng(6)
    audio = (0.3 * np.sin(np.arange(900) / 4.0) + 0.02 * rng.standard_normal(900)).astype(np.float32)
    write_wav(tmp_path / "a.wav", audio[None], 11025)
    task = _tiny_task(NARROW)

    def featurize(a):
        return jlog_mel(a, sample_rate=8000, n_fft=64, hop_length=16, win_length=64, n_mels=8, f_max=4000)

    want, _, want_audio = jinfer._load_mel_item(tmp_path / "a.wav", argparse.Namespace(pitch_shift=semitones), task,
                                                featurize)
    got, got_audio = infer.load_mel_item(tmp_path / "a.wav", task, torch.device("cpu"), semitones)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert got_audio.shape == want_audio.shape
    np.testing.assert_allclose(got_audio, want_audio, rtol=0, atol=1e-6)


def test_cli_turns_tf32_off(tmp_path, monkeypatch):
    """After cli.infer.main both TF32 flags read False, whatever they were: fp32 means fp32."""
    kw = dict(NARROW, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),))
    task = _tiny_task(kw)
    monkeypatch.setattr(infer, "build_task_config", lambda model, resolution: task)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in random_state_dict(BigVGANConfig(**kw), 0).items()}},
               tmp_path / "g.ckpt")
    np.save(tmp_path / "m.npy", np.zeros((8, 4), np.float32))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    infer.main(["--model", "bigvgan", "--resolution", "tiny", "--ckpt", str(tmp_path / "g.ckpt"),
                "--input", str(tmp_path / "m.npy"), "--output", str(tmp_path / "out"), "--device", "cpu"])
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
