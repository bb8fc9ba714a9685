"""The port's trainer, training CLI and checkpoints, and the repairs to its inference path, on the CPU."""

import argparse
import dataclasses
import inspect
import json
import pickle

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu import config as jconfig
from vocoder_tpu_torch import config as tconfig
from vocoder_tpu_torch.cli import infer
from vocoder_tpu_torch.cli import train as train_cli
from vocoder_tpu_torch.convert import load_reference_state_dict
from vocoder_tpu_torch.data.audio_io import read_wav, write_wav
from vocoder_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, random_state_dict
from vocoder_tpu_torch.ops.amp_block import amp_stage_plain
from vocoder_tpu_torch.train import gan
from vocoder_tpu_torch.utils.checkpoint import CheckpointManager


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _cli_default(main, monkeypatch, flag: str):
    """The default of ``flag`` in the parser that ``main`` builds (stopped at parse_args)."""
    def stop(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as caught:
        main([])
    return caught.value.parser.get_default(flag)


def test_default_generator_equals_jax(monkeypatch):
    """The CLIs' --model and the config functions' model default to the JAX package's, read from its own code."""
    from vocoder_tpu.cli import infer as jinfer
    from vocoder_tpu.cli import train as jtrain

    assert _cli_default(infer.main, monkeypatch, "model") == _cli_default(jinfer.main, monkeypatch, "model")
    assert _cli_default(train_cli.main, monkeypatch, "model") == _cli_default(jtrain.main, monkeypatch, "model")
    for name in ("build_task_config", "build_train_config"):
        want = inspect.signature(getattr(jconfig, name)).parameters["model"].default
        assert inspect.signature(getattr(tconfig, name)).parameters["model"].default == want, name


def test_task_config_equals_jax_package():
    """The gan task of each ported preset, field by field, but the TPU-only ``spectral_precision``."""
    for model in ("hifigan", "bigvgan"):
        want = dataclasses.asdict(jconfig.build_task_config(model))
        got = dataclasses.asdict(tconfig.build_task_config(model))
        want.pop("spectral_precision")  # an MXU pass count
        assert got == want, model
    assert dataclasses.asdict(tconfig.DataConfig()) == dataclasses.asdict(jconfig.DataConfig())
    jrun = dataclasses.asdict(jconfig.RunConfig())
    jrun.pop("split_step")  # an XLA workaround
    assert dataclasses.asdict(tconfig.RunConfig()) == jrun


def _tiny_checkpoint(path, extra: dict):
    cfg = BigVGANConfig(hop_length=16, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), num_mels=8,
                        upsample_initial_channel=32, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
    sd = random_state_dict(cfg, 0)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in sd.items()}, **extra}, path)
    return cfg, sd


def test_pickled_checkpoint_entries_load_only_when_trusted(tmp_path, monkeypatch):
    """A checkpoint with an argparse.Namespace among its entries: refused with a message that names
    --trust-checkpoint, loaded with it (the JAX package's weights_only=False)."""
    cfg, sd = _tiny_checkpoint(tmp_path / "g.ckpt", {"hyper_parameters": argparse.Namespace(lr=1e-4)})
    with pytest.raises(pickle.UnpicklingError, match="--trust-checkpoint"):
        load_reference_state_dict(tmp_path / "g.ckpt")
    got = load_reference_state_dict(tmp_path / "g.ckpt", trust=True)
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)

    task = gan.GANTaskConfig(sampling_rate=8000, n_fft=64, hop_length=16, win_length=64, num_mels=8,
                             generator_name="bigvgan", generator=cfg)
    monkeypatch.setattr(infer, "build_task_config", lambda model, resolution: task)
    (tmp_path / "in").mkdir()
    np.save(tmp_path / "in" / "m.npy", (np.random.default_rng(0).standard_normal((8, 20)) - 3).astype(np.float32))
    argv = ["--model", "bigvgan", "--ckpt", str(tmp_path / "g.ckpt"), "--input", str(tmp_path / "in"),
            "--output", str(tmp_path / "out"), "--device", "cpu"]
    with pytest.raises(pickle.UnpicklingError, match="--trust-checkpoint"):
        infer.main(argv)
    infer.main([*argv, "--trust-checkpoint"])
    assert read_wav(tmp_path / "out" / "m.wav")[0].shape == (1, 20 * 16)


@pytest.mark.parametrize("uic,blockwise", [(768, 1), (48, 2)])
def test_stages_k2_does_not_take_run_blockwise_and_counted(uic, blockwise):
    """C = 384 (over 256) and C = 24, 12 (not multiples of 16) run block by block in eval mode, counted,
    and equal the plain stage there; every stage does in training mode.  The plain path counts nothing."""
    cfg = BigVGANConfig(hop_length=16, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), num_mels=8,
                        upsample_initial_channel=uic, resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3),) * 2)
    model = BigVGAN(cfg)
    model.load_state_dict(random_state_dict(cfg, 0))
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8, 6)).astype(np.float32) - 3.0)
    with torch.no_grad():
        BigVGAN.blockwise_stages = 0
        model.eval()(mel)
        assert BigVGAN.blockwise_stages == blockwise
        model.train()(mel)
        assert BigVGAN.blockwise_stages == blockwise + 2
        model.forward_plain(mel)
        model.eval().forward_plain(mel)
        assert BigVGAN.blockwise_stages == blockwise + 2
        blocks = list(model.resblocks[:2])
        x = torch.randn(2, uic // 2, 40)
        torch.testing.assert_close(sum(b(x) for b in blocks) / 2, amp_stage_plain(blocks, x, True), rtol=1e-5, atol=1e-6)


def test_port_refuses_what_it_does_not_train():
    """An unknown compute dtype is refused by name (bf16 trains now), and so is an unknown family."""
    task = tconfig.build_task_config("hifigan")
    with pytest.raises(ValueError, match="compute_dtype 'float16': one of 'float32' or 'bfloat16'"):
        gan.create_train_state(task.replace(compute_dtype="float16"), 0, "cpu")
    with pytest.raises(ValueError, match="unknown task family 'mms'"):
        gan.create_train_state(task.replace(family="mms"), 0, "cpu")


def _wavs(root, n, rng):
    root.mkdir(parents=True)
    for i in range(n):
        t = np.arange(int(8000 * rng.uniform(0.3, 0.8))) / 8000
        write_wav(root / f"{i}.wav", (0.3 * np.sin(2 * np.pi * 300 * t) + 0.01 * rng.standard_normal(t.size))
                  .astype(np.float32), 8000)


TINY = ["task.sampling_rate=8000", "task.n_fft=64", "task.win_length=64", "task.hop_length=16", "task.num_mels=8",
        "task.num_frames=32", "task.crop_length=128", "task.generator.hop_length=16",
        "task.generator.upsample_rates=(4,4)", "task.generator.upsample_kernel_sizes=(8,8)", "task.generator.num_mels=8",
        "task.generator.upsample_initial_channel=32", "task.generator.resblock_kernel_sizes=(3,)",
        "task.generator.resblock_dilation_sizes=((1,3),)", "task.mpd.channels=(1,4,8)", "task.mpd.periods=(2,3)",
        "task.mrd.resolutions=((64,16,64),(32,8,32))", "task.stft_resolutions=((64,16,64),(32,8,32))",
        "data.batch_size=2", "data.val_batch_size=2", "data.val_crop_frames=64", "data.num_workers=1",
        "run.log_interval=1", "run.val_interval=2", "run.ckpt_interval=2"]


def test_cli_train_checkpoints_resumes_and_guards(tmp_path, capsys):
    """4 steps on the CPU with validation (the default config: mel-L1, PESQ and media) and checkpoints
    every 2, a resume to 6, the guard against a workdir of another task, and cli.infer from the run's
    workdir."""
    rng = np.random.default_rng(0)
    _wavs(tmp_path / "train", 4, rng)
    _wavs(tmp_path / "val", 2, rng)
    work = tmp_path / "run"
    base = ["--model", "bigvgan", "--device", "cpu", f"data.train_roots=('{tmp_path / 'train'}',)",
            f"data.val_root={tmp_path / 'val'}", f"run.workdir={work}", *TINY]
    assert tconfig.RunConfig().val_pesq
    state = train_cli.main([*base, "run.max_steps=4"])
    assert state.step == 4
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train/generator/all" in r] == [2, 3, 4]
    assert [r["step"] for r in records if "val/metrics/mel" in r] == [2, 4]
    pesqs = [r["val/metrics/pesq"] for r in records if "val/metrics/pesq" in r]
    assert [r["step"] for r in records if "val/metrics/pesq" in r] == [2, 4]
    assert all(1.0 <= v <= 4.65 for v in pesqs), pesqs
    assert all({"perf/val_forward_s", "perf/val_pesq_s"} <= set(r) for r in records if "val/metrics/mel" in r)
    assert sorted(p.name for p in (work / "media").iterdir()) == ["val_mel_00000002.png", "val_mel_00000004.png"]
    assert all(np.isfinite(v) for r in records for v in r.values())
    assert {"perf/steps_per_s", "perf/audio_s_per_s", "perf/input_wait_s", "lr"} <= set(records[0])
    assert CheckpointManager(work / "checkpoints").steps() == [2, 4]
    capsys.readouterr()

    state = train_cli.main([*base, "run.max_steps=6"])
    assert state.step == 6 and "auto-resumed from step 4" in capsys.readouterr().err
    assert CheckpointManager(work / "checkpoints").steps() == [2, 4, 6]

    with pytest.raises(SystemExit, match="different task config"):
        train_cli.main([*base, "run.max_steps=8", "task.mel_weight=99.0"])
    assert not (work / "checkpoints" / "8.pt").exists()

    wav = tmp_path / "val" / "0.wav"
    infer.main(["--model", "bigvgan", "--ckpt", str(work / "checkpoints"), "--input", str(wav), "--output",
                str(tmp_path / "out"), "--device", "cpu"])
    n = read_wav(wav)[0].shape[-1]
    audio = read_wav(tmp_path / "out" / "0.wav")[0]
    assert audio.shape == (1, -(-n // 16) * 16) and np.isfinite(audio).all()
    with pytest.raises(SystemExit, match="records generator 'bigvgan'"):
        infer.main(["--model", "hifigan", "--ckpt", str(work), "--input", str(wav), "--output", str(tmp_path / "o2"),
                    "--device", "cpu"])


def test_checkpoint_round_trip_and_weights_only(tmp_path):
    """Every part of the state comes back; weights-only keeps fresh optimizers and step; saves are atomic
    (no temporary file left) and follow the interval unless forced."""
    task = tconfig.apply_overrides(tconfig.build_train_config("hifigan"), TINY[:18]).task
    state = gan.create_train_state(task, 0, "cpu")
    batch = {"audio": torch.randn(2, 1, 512) * 0.3, "lengths": torch.tensor([512, 400])}
    gan.make_train_step(task)(state, batch)
    mgr = CheckpointManager(tmp_path / "ck", save_interval_steps=2)
    assert not mgr.save(1, state) and mgr.save(1, state, force=True) and mgr.latest_step() == 1
    assert [p.name for p in (tmp_path / "ck").iterdir()] == ["1.pt"]
    crop = gan.draw_crop_start(state, task, 512)

    fresh = gan.create_train_state(task, 1, "cpu")
    mgr.restore(fresh)
    assert fresh.step == 1 and gan.draw_crop_start(fresh, task, 512) == crop
    for a, b in zip(fresh.generator.state_dict().values(), state.generator.state_dict().values()):
        assert torch.equal(a, b)
    assert fresh.opt_g.state_dict()["state"][0]["exp_avg"].equal(state.opt_g.state_dict()["state"][0]["exp_avg"])

    other = gan.create_train_state(task, 1, "cpu")
    mgr.restore_weights_only(other)
    assert other.step == 0 and not other.opt_d.state_dict()["state"]
    for a, b in zip(other.discriminators.state_dict().values(), state.discriminators.state_dict().values()):
        assert torch.equal(a, b)
