"""Training the generators that consume an f0 template, against the JAX package, on the CPU.

One RefineGAN train step and the eval step after it, held to JAX's by ``tests/test_torch_train.py``'s
checks (same tolerances) with the AdaIN noise zero on both sides (the JAX package's
``jax.random.normal`` and the port's ``adain_noise`` patched inside the test; the AdaIN weights stay
nonzero, so their gradients, the noise times the upstream gradient, are 0 on both sides alike).  The
data pipeline's templates against the JAX package's ``batch_iterator(template_fn=...)``.  Then the
trainer: a RefineGAN run resumed from a checkpoint repeats the run it resumes, AdaIN draws included,
and a BigVGAN with ``use_template`` trains and feeds the inference CLI from its workdir.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import check_eval_step, check_train_step
from tests.test_torch_trainer import TINY, _wavs
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu.data import dataset as jdataset
from vocoder_tpu.data import f0 as jf0
from vocoder_tpu.data import transforms as jtransforms
from vocoder_tpu_torch.cli import infer
from vocoder_tpu_torch.cli import train as train_cli
from vocoder_tpu_torch.data import dataset, transforms
from vocoder_tpu_torch.data.audio_io import read_wav, write_wav
from vocoder_tpu_torch.data.f0 import f0_template
from vocoder_tpu_torch.models import refinegan
from vocoder_tpu_torch.train import gan

# TINY's task, data and run settings (tests/test_torch_trainer.py) with a RefineGAN of hop 16.
REFINE_TINY = [o for o in TINY if not o.startswith("task.generator.")] + [
    "task.generator.sampling_rate=8000", "task.generator.hop_length=16", "task.generator.downsample_rates=(2,2,2,2)",
    "task.generator.upsample_rates=(2,2,2,2)", "task.generator.num_mels=8", "task.generator.start_channels=4"]


@pytest.fixture
def zero_noise(monkeypatch):
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(refinegan, "adain_noise", lambda x, generator: torch.zeros_like(x))


def test_refinegan_train_step_matches_jax(zero_noise):
    check_train_step("refinegan", True)


def test_refinegan_eval_step_matches_jax(zero_noise):
    check_eval_step("refinegan")


def test_batch_iterator_templates_match_jax(tmp_path):
    """Three batches of the training transforms over voiced WAVs: the same audio and, from it, the same
    templates (each element's final audio), for 1 and 3 workers."""
    rng = np.random.default_rng(0)
    tmp_path.joinpath("w").mkdir()
    for i in range(3):
        t = np.arange(int(16000 * rng.uniform(0.3, 0.6))) / 16000
        audio = 0.4 * np.sin(2 * np.pi * rng.uniform(120, 400) * t) + 0.01 * rng.standard_normal(t.size)
        write_wav(tmp_path / "w" / f"{i}.wav", audio.astype(np.float32), 16000)

    def it(ds_mod, tr_mod, template_fn, workers):
        tr = tr_mod.train_transform(16000, 160, 24)
        sample = ds_mod.MixDataset([ds_mod.VocoderDataset(root=tmp_path / "w", transform=tr)], [1.0]).sample
        return ds_mod.batch_iterator(sample, batch_size=3, target_length=160 * 24, seed=5, start_step=1,
                                     num_workers=workers, template_fn=template_fn)

    for workers in (1, 3):
        want = it(jdataset, jtransforms, lambda a: jf0.template_from_f0(jf0.estimate_f0(a, 16000, 160), 16000, 160),
                  1)
        got = it(dataset, transforms, lambda a: f0_template(a, 16000, 160), workers)
        for _ in range(3):
            w, g = next(want), next(got)
            assert g["template"].shape == w["template"].shape == (3, 1, 160 * 24)
            assert g["template"].dtype == np.float32 and np.abs(w["template"]).max() > 0.05
            np.testing.assert_allclose(g["audio"], w["audio"], rtol=0, atol=1e-6)
            np.testing.assert_allclose(g["template"], w["template"], rtol=0, atol=1e-4)
        got.close()
        want.close()


def test_batch_iterator_makes_templates_in_its_own_thread():
    """With a pool of data workers, the templates are made in the thread that takes the batch, one
    element after another (the f0 loop runs several times slower across pool threads), and each is the
    template of its element's final audio."""
    seen = []

    def template_fn(a):
        seen.append(threading.current_thread())
        return a * 2.0

    def sample(rng):
        return rng.standard_normal(rng.integers(50, 300)).astype(np.float32)

    it = dataset.batch_iterator(sample, batch_size=4, target_length=200, num_workers=3, template_fn=template_fn)
    batch = next(it)
    it.close()
    assert seen == [threading.current_thread()] * 4
    np.testing.assert_array_equal(batch["template"], batch["audio"] * 2.0)


def _run(tmp_path, name: str, steps: int, extra=()):
    base = ["--model", "refinegan", "--resolution", "24000_256_1024", "--device", "cpu",
            f"data.train_roots=('{tmp_path / 'train'}',)", f"data.val_root={tmp_path / 'val'}",
            f"run.workdir={tmp_path / name}", "run.val_pesq=False", *REFINE_TINY, *extra]
    return train_cli.main([*base, f"run.max_steps={steps}"])


def test_resumed_refinegan_run_repeats_the_run(tmp_path):
    """4 steps in one run, and 2 steps then a resume to 4: the same weights and the same state of the
    noise generator, which the steps advanced (the AdaIN draws of steps 3 and 4 are the same draws)."""
    rng = np.random.default_rng(1)
    _wavs(tmp_path / "train", 4, rng)
    _wavs(tmp_path / "val", 2, rng)
    straight = _run(tmp_path, "a", 4)
    _run(tmp_path, "b", 2)
    resumed = _run(tmp_path, "b", 4)
    assert straight.step == resumed.step == 4
    assert torch.equal(straight.noise.get_state(), resumed.noise.get_state())
    assert not torch.equal(straight.noise.get_state(), torch.Generator().manual_seed(594461).get_state())
    for (key, a), b in zip(straight.generator.state_dict().items(), resumed.generator.state_dict().values()):
        assert torch.equal(a, b), key

    wav = tmp_path / "val" / "0.wav"
    infer.main(["--model", "refinegan", "--resolution", "24000_256_1024", "--ckpt", str(tmp_path / "b"), "--input",
                str(wav), "--output", str(tmp_path / "out"), "--device", "cpu"])
    n = read_wav(wav)[0].shape[-1]
    audio = read_wav(tmp_path / "out" / "0.wav")[0]
    assert audio.shape == (1, -(-n // 16) * 16) and np.isfinite(audio).all()


def test_bigvgan_with_template_trains_and_infers_from_its_workdir(tmp_path):
    """cli.train --model bigvgan task.generator.use_template=True: the batches carry templates, the run
    validates; cli.infer --ckpt <workdir> reads use_template from config.json and makes a template."""
    rng = np.random.default_rng(2)
    _wavs(tmp_path / "train", 4, rng)
    _wavs(tmp_path / "val", 2, rng)
    work = tmp_path / "run"
    state = train_cli.main(["--model", "bigvgan", "--device", "cpu", f"data.train_roots=('{tmp_path / 'train'}',)",
                            f"data.val_root={tmp_path / 'val'}", f"run.workdir={work}", "run.val_pesq=False",
                            *TINY, "task.generator.use_template=True", "run.max_steps=2"])
    assert state.step == 2 and state.generator.cfg.use_template and gan.needs_template(
        gan.GANTaskConfig(generator_name="bigvgan", generator=state.generator.cfg))
    assert all(p.grad is not None and p.grad.abs().max() > 0 for p in state.generator.noise_convs.parameters())
    wav = tmp_path / "val" / "1.wav"
    infer.main(["--model", "bigvgan", "--ckpt", str(work), "--input", str(wav), "--output", str(tmp_path / "out"),
                "--device", "cpu"])
    n = read_wav(wav)[0].shape[-1]
    audio = read_wav(tmp_path / "out" / "1.wav")[0]
    assert audio.shape == (1, -(-n // 16) * 16) and np.isfinite(audio).all() and np.abs(audio).max() > 0
