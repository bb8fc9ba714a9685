"""The port's evaluation (PESQ, SI-SDR, MCD, mel-L1, ``cli/evaluate.py``) and validation PESQ against
the JAX package's, on the CPU."""

import numpy as np
import pytest
import torch

from vocoder_tpu import eval_metrics as jmetrics
from vocoder_tpu import pesq_native as jpesq
from vocoder_tpu.cli import evaluate as jevaluate
from vocoder_tpu.data import native as jnative
from vocoder_tpu.data import resample as jresample
from vocoder_tpu.train import trainer as jtrainer
from vocoder_tpu_torch import eval_metrics, pesq_native
from vocoder_tpu_torch.cli import evaluate
from vocoder_tpu_torch.data import flac
from vocoder_tpu_torch.data import native as tnative
from vocoder_tpu_torch.data.audio_io import write_wav
from vocoder_tpu_torch.data.resample import resample
from vocoder_tpu_torch.train import trainer

SPEC_RTOL = 1e-4  # the log-mel in torch against JAX's (other FFT and sum orders)
IDENTITY_NB, IDENTITY_WB = 4.5486, 4.6439  # the P.862.1 / P.862.2 maps at raw 4.5 (tests/test_pesq.py:33)


def _speechish(sr: int, seconds: float, seed: int) -> np.ndarray:
    """tests/test_pesq.py's speech-like signal: AM multi-tone with pauses."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    env = (np.sin(2 * np.pi * 1.5 * t) ** 2) * (np.sin(2 * np.pi * 0.25 * t) > -0.3)
    x = env * (0.5 * np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 800 * t)
               + 0.15 * np.sin(2 * np.pi * 1800 * t) + 0.05 * rng.standard_normal(len(t)))
    return x.astype(np.float32)


@pytest.fixture
def numpy_resample(monkeypatch):
    """Both packages' resample in numpy (their C++ polyphase kernels off), so that the scores compare the
    numpy paths bit for bit (the native ones are held to them in tests/test_torch_native_resample.py)."""
    monkeypatch.setattr(jnative, "resample_native", lambda *a, **k: None)
    monkeypatch.setattr(tnative, "resample_native", lambda *a, **k: None)


@pytest.mark.parametrize("sr,mode", [(8000, "nb"), (16000, "wb")])
def test_pesq_native_equals_jax(sr, mode):
    x = _speechish(sr, 1.0, 0)
    rng = np.random.default_rng(1)
    for snr_db in (30.0, 10.0):
        noise = rng.standard_normal(x.size).astype(np.float32) * np.sqrt(np.mean(x**2) / 10 ** (snr_db / 10))
        y = np.roll(x + noise, 40)
        got = pesq_native.pesq(x, y, sr, mode)
        assert abs(got - jpesq.pesq(x, y, sr, mode)) <= 1e-9 and 1.0 <= got <= 4.65
        assert eval_metrics.pesq(x, y, sr, mode) == got
    want = IDENTITY_NB if mode == "nb" else IDENTITY_WB
    assert pesq_native.pesq(x, x, sr, mode) == pytest.approx(want, abs=5e-5)


def test_si_sdr_equals_jax():
    rng = np.random.default_rng(2)
    s = rng.standard_normal(4000).astype(np.float32)
    for est in (s, 0.5 * s, s + 0.1 * rng.standard_normal(4000).astype(np.float32)):
        assert eval_metrics.si_sdr(s, est) == jmetrics.si_sdr(s, est)


def test_mcd_and_spec_difference_equal_jax():
    sr = 24000
    x = _speechish(sr, 0.8, 3)
    y = x + 0.05 * np.random.default_rng(4).standard_normal(x.size).astype(np.float32)
    np.testing.assert_allclose(eval_metrics.mcd(x, y, sr), jmetrics.mcd(x, y, sr), rtol=SPEC_RTOL)
    np.testing.assert_allclose(evaluate.spec_difference(x, y, sr), jevaluate.spec_difference(x, y, sr), rtol=SPEC_RTOL)
    assert eval_metrics.mcd(x, x, sr) == 0.0 and evaluate.spec_difference(x, x, sr) == 0.0


def _pairs(tmp_path, sr: int = 24000):
    """Three FLAC sources and their 'generated' WAVs (noise, a delay, a gain)."""
    src, gen = tmp_path / "src", tmp_path / "gen"
    src.mkdir()
    gen.mkdir()
    rng = np.random.default_rng(5)
    for i in range(3):
        x = _speechish(sr, 0.6 + 0.2 * i, 10 + i) * 0.8
        flac.write_flac(src / f"{i}.flac", x, sr)
        y = 0.9 * np.roll(x, 12 * i) + 0.02 * (i + 1) * rng.standard_normal(x.size).astype(np.float32)
        write_wav(gen / f"{i}.wav", np.clip(y, -1, 1), sr)
    return src, gen


def _close(got: dict, want: dict) -> None:
    assert set(got) == set(want) == {"pesq_nb", "pesq_wb", "spec_diff", "si_sdr", "mcd"}
    for k in ("pesq_nb", "pesq_wb", "si_sdr"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    for k in ("spec_diff", "mcd"):
        np.testing.assert_allclose(got[k], want[k], rtol=SPEC_RTOL, err_msg=k)


def test_cli_evaluate_equals_jax(tmp_path, numpy_resample, capsys):
    src, gen = _pairs(tmp_path)
    argv = [str(src), str(gen), "--sr", "24000", "--glob-pattern", "*.flac"]
    got = evaluate.main([*argv, "--device", "cpu"])
    want = jevaluate.main(argv)
    _close(got, want)
    assert 1.0 <= got["pesq_wb"] <= 4.65 and got["mcd"] > 0
    assert capsys.readouterr().out.count("Average scores:") == 2

    ident = evaluate.main([str(src), str(src), "--sr", "24000", "--glob-pattern", "*.flac", "--device", "cpu"])
    assert ident["pesq_nb"] == pytest.approx(IDENTITY_NB, abs=5e-5)
    assert ident["pesq_wb"] == pytest.approx(IDENTITY_WB, abs=5e-5)
    assert ident["spec_diff"] == 0.0 and ident["mcd"] == 0.0


def test_cli_evaluate_workers_equal_one_process(tmp_path):
    """--workers 2 (spawned processes on the CPU): PESQ and SI-SDR equal, the spectral ones within rtol."""
    src, gen = _pairs(tmp_path)
    argv = [str(src), str(gen), "--sr", "24000", "--glob-pattern", "*.flac", "--device", "cpu"]
    one = evaluate.main(argv)
    two = evaluate.main([*argv, "--workers", "2"])
    for k in ("pesq_nb", "pesq_wb", "si_sdr"):
        assert one[k] == two[k], k
    for k in ("spec_diff", "mcd"):
        np.testing.assert_allclose(two[k], one[k], rtol=SPEC_RTOL, err_msg=k)


def test_cli_evaluate_errors_are_loud_and_all_failing_exits(tmp_path, capsys):
    src, gen = _pairs(tmp_path)
    (gen / "0.wav").write_bytes(b"RIFF" + b"\x00" * 40)  # corrupt
    out = evaluate.main([str(src), str(gen), "--sr", "24000", "--glob-pattern", "*.flac", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "Error processing" in text and "warning: 1/3 file pairs failed" in text and set(out) >= {"pesq_wb"}
    for i in (1, 2):
        (gen / f"{i}.wav").write_bytes(b"junk")
    with pytest.raises(SystemExit, match="every file pair failed"):
        evaluate.main([str(src), str(gen), "--sr", "24000", "--glob-pattern", "*.flac", "--device", "cpu"])
    with pytest.raises(SystemExit, match="glob-pattern"):
        evaluate.main([str(src), str(gen), "--device", "cpu"])  # *.wav matches no source


def test_cli_evaluate_on_cuda_without_a_card_exits(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")
    src, gen = _pairs(tmp_path)
    with pytest.raises(SystemExit, match="--device cpu"):
        evaluate.main([str(src), str(gen), "--glob-pattern", "*.flac"])


def test_cli_evaluate_workers_refuse_cuda(tmp_path):
    """The worker processes score on the CPU, so --workers N > 1 with the default --device cuda is refused
    rather than moving spec_diff and MCD off the card unsaid."""
    src, gen = _pairs(tmp_path)
    with pytest.raises(SystemExit, match="--workers N > 1 scores every pair on the CPU"):
        evaluate.main([str(src), str(gen), "--glob-pattern", "*.flac", "--workers", "2"])


def test_val_pesq_equals_jax(numpy_resample):
    """The trainer's validation PESQ on the same (fake, batch): a padded batch with a clip of length 0
    (skipped) and an all-silent clip (degenerate, skipped)."""
    from vocoder_tpu.config import build_task_config

    task = build_task_config("hifigan", "24000_256_1024")
    t = 256 * 64
    rng = np.random.default_rng(6)
    audio = np.zeros((4, 1, t), np.float32)
    audio[0, 0] = _speechish(24000, t / 24000, 20)
    audio[1, 0, : t // 2] = _speechish(24000, t / 48000, 21)
    fake = audio + 0.03 * rng.standard_normal(audio.shape).astype(np.float32)
    fake[2] = 0.0
    batch = {"audio": audio, "lengths": np.asarray([t, t // 2, t, 0], np.int64)}
    got = trainer._make_val_pesq(task)(fake, batch)
    want = jtrainer._make_val_pesq(task)(fake, batch)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.array_equal(resample(audio[0, 0], 24000, 16000), jresample.resample(audio[0, 0], 24000, 16000))
