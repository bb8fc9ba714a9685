"""``cli.train`` for the newly trainable families on the CPU: vae, vqvae, Vocos and Firefly-GAN train
through the trainer at tiny widths, and a vqvae run resumed from a checkpoint repeats the run it resumes,
codebooks included, then feeds ``cli.codec`` from its workdir."""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_trainer import TINY, _wavs
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu_torch.cli import codec
from vocoder_tpu_torch.cli import train as train_cli
from vocoder_tpu_torch.data.audio_io import read_wav

# TINY's task, data and run settings (tests/test_torch_trainer.py: hop 16, n_fft 64, so 33 linear bins)
# with each family's generator at widths of 16 or less.
BASE = [o for o in TINY if not o.startswith("task.generator.")]
DECODER = ["hop_length=16", "upsample_rates=(4,4)", "upsample_kernel_sizes=(8,8)", "upsample_initial_channel=16",
           "resblock_kernel_sizes=(3,)", "resblock_dilation_sizes=((1,3),)"]
BACKBONE = ["backbone.input_channels=8", "backbone.depths=(1,2)", "backbone.dims=(8,16)"]
FAMILIES = {
    "vae": (["--family", "vae"], ["latent_size=6", "encoder.input_channels=33", "encoder.depths=(1,1)",
                                  "encoder.dims=(8,12)", "decoder.num_mels=6", *[f"decoder.{o}" for o in DECODER]]),
    "vqvae": (["--family", "vqvae"], ["latent_size=6", "encoder.in_channels=33", "encoder.out_channels=6",
                                      "encoder.hidden_channels=8", "encoder.n_layers=2", "decoder.num_mels=6",
                                      "vq.dim=6", "vq.codebook_size=16", *[f"decoder.{o}" for o in DECODER]]),
    "vocos": (["--model", "vocos"], [*BACKBONE, "head.dim=16", "head.n_fft=64", "head.hop_length=16",
                                     "head.win_length=64"]),
    "firefly_gan_base": (["--model", "firefly_gan_base"], [*BACKBONE, "head.num_mels=16",
                                                           *[f"head.{o}" for o in DECODER]]),
}


def _run(tmp_path, name: str, work: str, steps: int):
    flags, gen = FAMILIES[name]
    return train_cli.main([*flags, "--device", "cpu", f"data.train_roots=('{tmp_path / 'train'}',)",
                           f"data.val_root={tmp_path / 'val'}", f"run.workdir={tmp_path / work}", "run.val_pesq=False",
                           *BASE, *[f"task.generator.{o}" for o in gen], f"run.max_steps={steps}"])


@pytest.mark.parametrize("name", ["vae", "vocos", "firefly_gan_base"])
def test_cli_trains_the_family(tmp_path, name):
    """Two steps with validation and checkpoints: finite losses (the vae's KL among them), and a
    ConvNeXt's drop_path drawing from the state's noise generator, which the steps advanced."""
    rng = np.random.default_rng(3)
    _wavs(tmp_path / "train", 4, rng)
    _wavs(tmp_path / "val", 2, rng)
    state = _run(tmp_path, name, "run", 2)
    assert state.step == 2
    records = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(v) for r in records for v in r.values())
    assert ("train/generator/kl" in records[0]) == (name == "vae")
    assert [r["step"] for r in records if "val/metrics/mel" in r] == [2]
    advanced = not torch.equal(state.noise.get_state(), torch.Generator().manual_seed(594461).get_state())
    assert advanced  # the vae's eps, the ConvNeXt masks of Vocos and Firefly-GAN


def test_resumed_vqvae_run_repeats_the_run_and_feeds_the_codec(tmp_path):
    """4 steps in one run, and 2 steps then a resume to 4: the same weights and EMA codebooks (buffers
    of the generator, restored with its state_dict), moved from their start; then cli.codec encode and
    decode from that workdir on the CPU."""
    rng = np.random.default_rng(4)
    _wavs(tmp_path / "train", 4, rng)
    _wavs(tmp_path / "val", 2, rng)
    straight = _run(tmp_path, "vqvae", "a", 4)
    first = _run(tmp_path, "vqvae", "b", 2)
    embed_at_2 = first.generator.vq.layers[0].embed.clone()
    resumed = _run(tmp_path, "vqvae", "b", 4)
    assert straight.step == resumed.step == 4
    for (key, a), b in zip(straight.generator.state_dict().items(), resumed.generator.state_dict().values()):
        assert torch.equal(a, b), key
    assert not torch.equal(resumed.generator.vq.layers[0].embed, embed_at_2)
    assert not any(b is p for b in resumed.generator.buffers() for p in resumed.opt_g.param_groups[0]["params"])
    records = [json.loads(line) for line in (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    assert all("train/generator/vq" in r for r in records if "train/generator/all" in r)

    codec.main(["encode", "--ckpt", str(tmp_path / "b"), "--input", str(tmp_path / "val"), "--output",
                str(tmp_path / "codes"), "--device", "cpu"])
    codec.main(["decode", "--ckpt", str(tmp_path / "b"), "--input", str(tmp_path / "codes"), "--output",
                str(tmp_path / "out"), "--device", "cpu"])
    n = read_wav(tmp_path / "val" / "0.wav")[0].shape[-1]
    codes = np.load(tmp_path / "codes" / "0.codes.npy")
    assert codes.shape == (1, 1, -(-n // 16)) and codes.min() >= 0 and codes.max() < 16
    audio = read_wav(tmp_path / "out" / "0.wav")[0]
    assert audio.shape == (1, -(-n // 16) * 16) and np.isfinite(audio).all()
