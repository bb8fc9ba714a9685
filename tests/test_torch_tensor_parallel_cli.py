"""The CLIs under tensor parallelism on the CPU: two gloo ranks under torchrun against one process.

``torchrun --nproc_per_node 2 -m vocoder_tpu_torch.cli.infer --device cpu --model-parallel 2`` from a
training workdir of BigVGAN at 256 channels (its config.json sets the widths; the first stage shards)
writes the WAVs that one process writes, per file (one past ``--chunk-frames``, one stereo) and with
``--batch 2``, within two 16-bit steps, and only rank 0 writes; so does a Firefly-GAN workdir (no
``param_specs``: its folded weights of 65,536 elements or more stored in shards and gathered at each forward).  ``cli.train run.model_parallel=2``
under torchrun (``tests/torch_dp_ranks.py``'s ``cli`` mode, which records each rank's writes and
batches): two steps with a validation at 2 and a resume to 3; only rank 0 writes, both ranks train on
the whole batch (one data-parallel share), the checkpoints hold whole tensors that load in one process,
and the logged validation is one process's on those weights.  Then the layouts refused by name.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_tensor_parallel import ROOT, _env
from tests.test_torch_trainer import TINY, _wavs
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_tp_ranks import UPSAMPLER
from vocoder_tpu_torch import config as tconfig
from vocoder_tpu_torch.cli import infer
from vocoder_tpu_torch.data.audio_io import read_wav, write_wav
from vocoder_tpu_torch.models import firefly
from vocoder_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, random_state_dict
from vocoder_tpu_torch.models.convnext import ConvNeXtConfig
from vocoder_tpu_torch.models.hifigan import HiFiGANConfig
from vocoder_tpu_torch.train import gan, trainer
from vocoder_tpu_torch.utils.checkpoint import CheckpointManager

WORLD = 2
PROCESS_TIMEOUT = 240
WAV_TOL = 2.0 / 32768  # two 16-bit steps
WIDE = ["task.generator.upsample_initial_channel=256"]  # TINY's BigVGAN with a sharded first stage


def torchrun(args: list[str], world: int = WORLD) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                             str(world), "-m", *args], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env())


def wait(proc: subprocess.Popen) -> str:
    try:
        out, err = proc.communicate(timeout=PROCESS_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    return out


# Firefly-GAN at widths whose larger weights reach the storage rule's 65,536 elements: the second stage's MLP
# (128 x 512), the head's conv_pre and first upsample; the rest stays whole.
FIREFLY = firefly.FireflyConfig(
    backbone=ConvNeXtConfig(input_channels=8, depths=(1, 1), dims=(64, 128)),
    head=HiFiGANConfig(**{**UPSAMPLER, "num_mels": 128, "resblock_kernel_sizes": (3,),
                          "resblock_dilation_sizes": ((1, 2),)}, pre_conv_kernel_size=13, post_conv_kernel_size=13))


def infer_workdir(root: Path, name: str = "bigvgan") -> Path:
    """A training run's workdir as the trainer leaves one: config.json recording an 8 kHz BigVGAN task at
    ``UPSAMPLER``'s widths (or ``FIREFLY``'s), and checkpoints/0.pt holding its generator (numpy seed 5)."""
    cfg = BigVGANConfig(**UPSAMPLER) if name == "bigvgan" else FIREFLY
    hop = UPSAMPLER["hop_length"]
    task = gan.GANTaskConfig(sampling_rate=8000, n_fft=16, hop_length=hop, win_length=16, num_mels=8,
                             generator_name=name, generator=cfg)
    work = root / f"run_{name}"
    (work / "checkpoints").mkdir(parents=True)
    (work / "config.json").write_text(json.dumps(dataclasses.asdict(tconfig.TrainConfig(task=task)), default=str))
    weights = random_state_dict(cfg, 5) if name == "bigvgan" else firefly.random_state_dict(cfg, 5)
    torch.save({"generator": weights}, work / "checkpoints" / "0.pt")
    return work


def write_inputs(root: Path) -> None:
    """Three mono clips of 0.02-0.05 s, one stereo one, and one of 0.2 s (400 frames, past --chunk-frames 100)."""
    rng = np.random.default_rng(7)
    root.mkdir()
    for i, seconds in enumerate((0.02, 0.035, 0.05, 0.2)):
        t = np.arange(int(8000 * seconds)) / 8000
        write_wav(root / f"{i}.wav", (0.3 * np.sin(2 * np.pi * 300 * t) + 0.01 * rng.standard_normal(t.size))
                  .astype(np.float32), 8000)
    t = np.arange(300) / 8000
    write_wav(root / "stereo.wav", np.stack([0.2 * np.sin(2 * np.pi * f * t) for f in (250, 330)]).astype(np.float32),
              8000)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' torchrun launches, started together; one process's inference meanwhile."""
    root = tmp_path_factory.mktemp("tp_cli")
    work = infer_workdir(root)
    write_inputs(root / "in")
    rng = np.random.default_rng(0)
    _wavs(root / "train", 4, rng)
    _wavs(root / "val", 2, rng)
    base = ["--model", "bigvgan", "--ckpt", str(work), "--input", str(root / "in"), "--device", "cpu",
            "--chunk-frames", "100"]
    runs = (("files", base), ("batch", [*base, "--batch", "2"]),
            ("firefly", ["--model", "firefly_gan_base", "--ckpt", str(infer_workdir(root, "firefly_gan_base")),
                         *base[4:]]))
    infer_tp = {tag: torchrun(["vocoder_tpu_torch.cli.infer", *args, "--model-parallel", "2",
                               "--output", str(root / f"tp_{tag}")]) for tag, args in runs}
    argv = ["--model", "bigvgan", "--device", "cpu", f"data.train_roots=('{root / 'train'}',)",
            f"data.val_root={root / 'val'}", f"run.workdir={root / 'train_run'}", *TINY, *WIDE, "run.model_parallel=2"]
    train = torchrun(["tests.torch_dp_ranks", "cli", str(root), "first", *argv, "run.max_steps=2"])
    for tag, args in runs:
        infer.main([*args, "--output", str(root / f"one_{tag}")])
    outs = {tag: wait(p) for tag, p in infer_tp.items()}
    wait(train)
    wait(torchrun(["tests.torch_dp_ranks", "cli", str(root), "resume", *argv, "run.max_steps=3"]))
    return root, outs, argv


@pytest.mark.parametrize("tag", ["files", "batch", "firefly"])
def test_model_parallel_infer_writes_one_process_wavs(runs, tag):
    root, outs, _ = runs
    names = sorted(p.name for p in (root / "in").iterdir())
    assert sorted(p.name for p in (root / f"tp_{tag}").iterdir()) == names
    for name in names:
        got, sr = read_wav(root / f"tp_{tag}" / name)
        want, _ = read_wav(root / f"one_{tag}" / name)
        assert sr == 8000 and got.shape == want.shape and np.abs(want).max() > 1e-3
        assert float(np.abs(got - want).max()) <= WAV_TOL, name
    assert "model-parallel inference: 2-way tensor sharding (gloo)" in outs[tag]
    assert int(outs[tag].split("(gloo), ")[1].split(" tensors sharded")[0]) > 0
    assert outs[tag].count("stereo.wav: ") == 1  # rank 0 alone prints


def test_model_parallel_train_writes_on_rank_0_and_resumes(runs):
    """Rank 1 wrote nothing; both ranks trained on data rank 0's batches (the whole batch), resumed at
    step 2 and reached 3; the checkpoints hold whole tensors that load in one process; the logged
    validation is one process's on the step-2 weights."""
    root, _, argv = runs
    rec = {(tag, r): torch.load(root / f"{tag}_rank{r}.pt", weights_only=False)
           for tag in ("first", "resume") for r in range(WORLD)}
    assert all(not rec[(tag, 1)]["writes"] for tag in ("first", "resume"))
    written = {Path(p).name for tag in ("first", "resume") for _, p in rec[(tag, 0)]["writes"]}
    assert {"config.json", "metrics.jsonl", "2.pt", "3.pt"} <= written
    for tag in ("first", "resume"):
        assert len(rec[(tag, 0)]["batches"]) == len(rec[(tag, 1)]["batches"]) > 0
        for a, b in zip(rec[(tag, 0)]["batches"], rec[(tag, 1)]["batches"]):
            np.testing.assert_array_equal(a, b)
        assert rec[(tag, 0)]["batches"][0].shape[0] == 2  # data.batch_size, one data-parallel share
    assert rec[("resume", 0)]["step"] == rec[("resume", 1)]["step"] == 3
    work = root / "train_run"
    cfg = tconfig.build_train_config("bigvgan", overrides=argv[4:-1])
    state = gan.create_train_state(cfg.task, cfg.run.seed, "cpu")
    CheckpointManager(work / "checkpoints").restore(state, 2)
    whole = BigVGAN(cfg.task.generator).state_dict()
    assert {k: v.shape for k, v in state.generator.state_dict().items()} == {k: v.shape for k, v in whole.items()}
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    logged = next(r for r in records if "val/metrics/mel" in r)
    val, _ = trainer.validate(state, gan.make_eval_step(cfg.task), trainer._build_val_batches(cfg),
                              trainer._make_val_pesq(cfg.task), torch.device("cpu"))
    for key in ("val/metrics/mel", "val/metrics/pesq"):
        assert logged[key] == pytest.approx(val[key], rel=1e-5), key


def test_model_parallel_infer_refuses_another_world_size(tmp_path):
    with pytest.raises(SystemExit, match=r"--model-parallel 2 needs that many processes \(torchrun --nproc_per_node 2\); "
                                         "there are 1"):
        infer.main(["--model", "bigvgan", "--ckpt", str(infer_workdir(tmp_path)), "--input", str(tmp_path),
                    "--output", str(tmp_path / "out"), "--device", "cpu", "--model-parallel", "2"])


@pytest.mark.parametrize("override,world,message", [
    ("run.model_parallel=3", 4, r"run.model_parallel=3 does not divide the number of processes \(4\)"),
    ("run.data_parallel=4", 4, r"run.data_parallel=4 must be the number of processes \(4\) // run.model_parallel \(2\)"),
    ("data.batch_size=3", 4, r"data.batch_size=3 is not divisible by the 2 processes of data parallelism "
                             r"\(4 // run.model_parallel=2\)"),
    ("data.val_batch_size=1", 4, "data.val_batch_size=1 is not divisible by the 2 processes of data parallelism"),
])
def test_grid_layouts_refused_by_name(override, world, message):
    """With run.model_parallel=2 on 4 processes (data parallelism of 2), each layout the grid cannot hold;
    the same config without the override passes, with run.data_parallel=2 too."""
    base = [*TINY, "data.val_root=/val", "run.model_parallel=2"]
    with pytest.raises(SystemExit, match=message):
        trainer.check_parallel(tconfig.build_train_config("bigvgan", overrides=[*base, override]), world)
    trainer.check_parallel(tconfig.build_train_config("bigvgan", overrides=[*base, "run.data_parallel=2"]), world)
