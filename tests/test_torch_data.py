"""The port's training data pipeline against the JAX package's, on the CPU.

Same WAVs, same seed: ``batch_iterator`` over a ``MixDataset`` of ``VocoderDataset``s with the training
transforms (pitch shift by resampling, random loudness, random crop, pad) gives the JAX package's
batches.  Both are numpy on the host with per-element rngs, so they agree to the last bit but for
the resampler's einsum order: atol 1e-6.
"""

import numpy as np
import pytest

from vocoder_tpu.data import dataset as jdataset
from vocoder_tpu.data import transforms as jtransforms
from vocoder_tpu_torch.data import dataset, transforms
from vocoder_tpu_torch.data.audio_io import list_audio_files, write_wav


@pytest.fixture
def wav_dirs(tmp_path):
    """Two corpora of 16 kHz WAVs of 0.3 to 1.2 s (one stereo), made from numpy seed 0."""
    rng = np.random.default_rng(0)
    roots = []
    for name, n in (("a", 4), ("b", 3)):
        root = tmp_path / name
        (root / "sub").mkdir(parents=True)
        for i in range(n):
            samples = int(16000 * rng.uniform(0.3, 1.2))
            ch = 2 if (name, i) == ("a", 1) else 1
            t = np.arange(samples) / 16000
            audio = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 500) * t) + 0.05 * rng.standard_normal((ch, samples))
            write_wav(root / ("sub" if i % 2 else "") / f"{i}.wav", audio.astype(np.float32), 16000)
        roots.append(root)
    return roots


def _sampler(ds_mod, tr_mod, roots):
    tr = tr_mod.train_transform(16000, 64, 64)
    return ds_mod.MixDataset([ds_mod.VocoderDataset(root=r, transform=tr) for r in roots], [0.7, 0.3]).sample


@pytest.mark.parametrize("num_workers", [1, 3])
def test_batch_iterator_matches_jax(wav_dirs, num_workers):
    """Five batches from step 2 on (a resume point), for any worker count."""
    kw = dict(batch_size=4, target_length=64 * 64, seed=11, start_step=2)
    want = jdataset.batch_iterator(_sampler(jdataset, jtransforms, wav_dirs), num_workers=1, **kw)
    got = dataset.batch_iterator(_sampler(dataset, transforms, wav_dirs), num_workers=num_workers, **kw)
    for _ in range(5):
        w, g = next(want), next(got)
        assert g["audio"].shape == w["audio"].shape == (4, 1, 64 * 64) and g["audio"].dtype == np.float32
        np.testing.assert_array_equal(g["lengths"], w["lengths"])
        np.testing.assert_allclose(g["audio"], w["audio"], rtol=0, atol=1e-6)
    got.close()
    want.close()


def test_list_audio_files_matches_jax(wav_dirs):
    from vocoder_tpu.data.audio_io import list_audio_files as jlist

    assert list_audio_files(wav_dirs[0]) == jlist(wav_dirs[0])


def test_dataset_refuses_undecodable_files_at_construction(wav_dirs):
    """A corpus with a file the port cannot decode (an audio suffix without a decoder) fails when the
    dataset is built, not as silence later."""
    (wav_dirs[0] / "x.m4a").write_bytes(b"\x00\x00\x00\x20ftypM4A ")
    with pytest.raises(ValueError, match="not decodable"):
        dataset.VocoderDataset(root=wav_dirs[0], transform=transforms.val_transform(16000, 64))


def test_filelist_and_peak_normalisation(wav_dirs, tmp_path):
    """A filelist names the files; an item whose peak reaches 1 is scaled to 0.99."""
    loud = tmp_path / "loud.wav"
    write_wav(loud, np.full((1, 800), 0.999, np.float32) * np.sign(np.sin(np.arange(800))), 16000)
    filelist = tmp_path / "list.txt"
    filelist.write_text(f"{loud}\n\n")
    ds = dataset.VocoderDataset(root=filelist, transform=lambda rng, p: 2.0 * transforms.LoadAudio(16000)(rng, p))
    assert len(ds) == 1
    assert np.isclose(np.abs(ds.get(np.random.default_rng(0), 0)).max(), 0.99)
