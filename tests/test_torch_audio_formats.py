"""The port's FLAC, Ogg/Vorbis and MP3 input against the JAX package's decoders, on the CPU.

Every decoder of the port (the host library's C++ FLAC decoder and Ogg loop, the numpy FLAC
decoder, libvorbisfile's pull loop, the numpy Vorbis decoder, libmpg123) must give the JAX
package's samples to the bit on the same file.  The JAX package's numpy FLAC decoder and Ogg
pull loop are reached by patching its ``native`` bindings inside the test.
"""

import numpy as np
import pytest
import torch

from vocoder_tpu.data import audio_io as jaudio_io
from vocoder_tpu.data import dataset as jdataset
from vocoder_tpu.data import flac as jflac
from vocoder_tpu.data import mp3 as jmp3
from vocoder_tpu.data import native as jnative
from vocoder_tpu.data import ogg as jogg
from vocoder_tpu.data import transforms as jtransforms
from vocoder_tpu.data import vorbis as jvorbis
from vocoder_tpu_torch.cli import infer
from vocoder_tpu_torch.data import audio_io, dataset, flac, mp3, native, ogg, transforms, vorbis
from vocoder_tpu_torch.data.audio_io import read_wav, write_wav
from vocoder_tpu_torch.models.bigvgan import BigVGANConfig, random_state_dict
from vocoder_tpu_torch.tools import vorbis_fixture
from vocoder_tpu_torch.train import gan

needs_xiph = pytest.mark.skipif(not (ogg.system_decoder_available() and ogg.encoder_available()),
                                reason="system libvorbis/libvorbisenc not present")
needs_lame = pytest.mark.skipif(not (mp3.decoder_available() and mp3.encoder_available()),
                                reason="system libmpg123/libmp3lame not present")
VORBIS_ATOL = 5e-6  # tests/test_vorbis_native.py: the numpy decoder against libvorbisfile


def _tone(sr: int, seconds: float, freqs=(440.0, 1321.0), amps=(0.5, 0.2)) -> np.ndarray:
    t = np.arange(int(sr * seconds))
    return sum(a * np.sin(2 * np.pi * f * t / sr) for f, a in zip(freqs, amps)).astype(np.float32)


def _jax_flac_pure(path, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(jnative, "flac_decode", lambda data: None)
        return jflac.read_flac(path)


def _flac_cases():
    """(pcm, sample rate, bits, block size): the cases of tests/test_flac.py."""
    rng = np.random.default_rng(0)
    t = np.arange(50_000)
    tone = np.rint(np.sin(2 * np.pi * 220 * t / 44100) * 12000).astype(np.int64)
    walk = np.clip(np.cumsum(np.random.default_rng(2).integers(-200, 200, 13_001)), -32768, 32767)[None, :]
    x24 = np.rint(np.sin(2 * np.pi * 100 * np.arange(20_000) / 44100) * (1 << 22)).astype(np.int64)
    mono24 = np.rint(np.sin(2 * np.pi * 330 * np.arange(11_025) / 22050) * (1 << 21)).astype(np.int64)[None]
    return {
        "tonal_stereo": (np.stack([tone + rng.integers(-30, 30, t.size), tone + rng.integers(-30, 30, t.size)]),
                         44100, 16, 4096),
        "white_noise_verbatim": (np.random.default_rng(1).integers(-32768, 32768, size=(2, 20_000)), 48000, 16, 4096),
        "silence": (np.zeros((1, 9000), np.int64), 16000, 16, 4096),
        "constant_stereo": (np.full((2, 5000), -123, np.int64), 8000, 16, 4096),
        "mono_odd_block_22050": (walk.astype(np.int64), 22050, 16, 1000),
        "stereo_24bit": (np.stack([x24, -x24 // 2]), 44100, 24, 4096),
        "mono_24bit_22050": (mono24, 22050, 24, 4096),
    }


@pytest.mark.parametrize("case", sorted(_flac_cases()))
def test_flac_equals_jax_on_both_paths(case, tmp_path, monkeypatch):
    """The port's encoder writes the JAX package's bytes; its C++ and numpy decoders both give the
    JAX package's C++ and numpy decodes and the source PCM, to the bit; the C++ decode is counted."""
    pcm, sr, bits, bs = _flac_cases()[case]
    path = tmp_path / "t.flac"
    flac.write_flac(path, pcm, sr, bits_per_sample=bits, block_size=bs)
    jflac.write_flac(tmp_path / "j.flac", pcm, sr, bits_per_sample=bits, block_size=bs)
    assert path.read_bytes() == (tmp_path / "j.flac").read_bytes()
    before = native.decodes["flac"]
    got, got_sr = flac.read_flac(path)
    assert native.available() and native.decodes["flac"] == before + 1
    pure, pure_sr = flac.read_flac_pure(path)
    want, want_sr = jflac.read_flac(path)
    want_pure, _ = _jax_flac_pure(path, monkeypatch)
    assert got_sr == pure_sr == want_sr == sr
    for a in (pure, want, want_pure):
        assert a.dtype == got.dtype == np.float32 and np.array_equal(got, a)
    np.testing.assert_array_equal(np.rint(got.astype(np.float64) * (1 << (bits - 1))).astype(np.int64), pcm)


def test_flac_unknown_length_and_no_library_take_the_numpy_path(tmp_path, monkeypatch):
    """A STREAMINFO total of 0 (unknown length) and a host without the library both decode in numpy,
    equal to JAX's, and count no native decode."""
    x = np.tanh(np.random.default_rng(3).standard_normal((2, 6000))).astype(np.float32) * 0.7
    flac.write_flac(tmp_path / "f.flac", x, 24000)
    data = bytearray((tmp_path / "f.flac").read_bytes())
    data[21] &= 0xF0  # the 36-bit total: the low nibble of byte 21 and bytes 22-25
    data[22:26] = bytes(4)
    (tmp_path / "u.flac").write_bytes(bytes(data))
    want, _ = jflac.read_flac(tmp_path / "f.flac")
    before = native.decodes["flac"]
    got, sr = flac.read_flac(tmp_path / "u.flac")
    assert sr == 24000 and np.array_equal(got, want) and np.array_equal(got, jflac.read_flac(tmp_path / "u.flac")[0])
    monkeypatch.setattr(native, "_load", lambda: None)
    assert np.array_equal(flac.read_flac(tmp_path / "f.flac")[0], want)
    assert native.decodes["flac"] == before


def test_flac_corrupt_streams_raise_on_both_paths(tmp_path):
    (tmp_path / "trunc.flac").write_bytes(b"fLaC" + b"\x00" * 16)
    x = _tone(16000, 0.5)[None]
    flac.write_flac(tmp_path / "ok.flac", x, 16000)
    (tmp_path / "cut.flac").write_bytes((tmp_path / "ok.flac").read_bytes()[:-200])
    for name in ("trunc.flac", "cut.flac"):
        for fn in (flac.read_flac, flac.read_flac_pure, jflac.read_flac):
            with pytest.raises((ValueError, IndexError)):
                fn(tmp_path / name)
    (tmp_path / "riff.flac").write_bytes(b"RIFF" + b"\x00" * 16)
    for fn in (flac.read_flac, flac.read_flac_pure):
        with pytest.raises(ValueError, match="not a FLAC"):
            fn(tmp_path / "riff.flac")


def _negative_lpc_shift(mod):
    bw = mod.BitWriter()
    bw.write(0, 1)  # padding
    bw.write(32, 6)  # LPC order 1
    bw.write(0, 1)  # no wasted bits
    bw.write_signed(0, 16)  # warmup sample
    bw.write(11, 4)  # precision 12
    bw.write_signed(-1, 5)  # negative shift (reserved)
    bw.write_signed(1, 12)  # coefficient
    bw.align()
    return bw.getvalue(), "shift"


def _wasted_bits_overflow(mod):
    bw = mod.BitWriter()
    bw.write(0, 1)  # padding
    bw.write(0, 6)  # CONSTANT
    bw.write(1, 1)  # wasted-bits flag
    bw.write_unary(16)  # wasted = 17 > bps = 16
    bw.align()
    return bw.getvalue(), "wasted"


@pytest.mark.parametrize("hostile", [_negative_lpc_shift, _wasted_bits_overflow])
def test_flac_hostile_subframes_raise_as_jax(hostile):
    """tests/test_flac.py's hostile subframes: the port's decoder raises where JAX's does, on the same bits."""
    data, match = hostile(flac)
    assert data == hostile(jflac)[0]
    for mod in (flac, jflac):
        with pytest.raises(ValueError, match=match):
            mod._decode_subframe(mod.BitReader(data), block_size=4, bps=16)


def test_decodable_extensions_equal_jax():
    assert audio_io.DECODABLE_EXTENSIONS == jaudio_io.DECODABLE_EXTENSIONS
    assert {".wav", ".flac", ".ogg"} <= audio_io.DECODABLE_EXTENSIONS
    assert audio_io.AUDIO_EXTENSIONS == jaudio_io.AUDIO_EXTENSIONS


@needs_xiph
@pytest.mark.parametrize("sr,stereo,quality", [(44100, False, 0.6), (22050, True, 0.6), (16000, True, 0.3)])
def test_ogg_equals_jax_on_every_path(sr, stereo, quality, tmp_path, monkeypatch):
    """On one file: the port's C++ loop, pull loop and numpy Vorbis decoder each equal the JAX
    package's same path to the bit; the C++ loop equals the pull loop, and the numpy decoder is within
    VORBIS_ATOL of it; the C++ decode is counted."""
    x = _tone(sr, 0.4)
    if stereo:
        x = np.stack([x, _tone(sr, 0.4, freqs=(250.0,), amps=(0.4,))])
    path = tmp_path / "x.ogg"
    ogg.write_ogg(path, x, sr, quality=quality)
    before = native.decodes["ogg"]
    got, got_sr = ogg.read_ogg(path)
    assert native.decodes["ogg"] == before + 1
    want, _ = jogg.read_ogg(path)
    with monkeypatch.context() as m:
        m.setattr(native, "ogg_decode", lambda p: None)
        m.setattr(jnative, "ogg_decode", lambda p: None)
        pull, _ = ogg.read_ogg(path)
        jpull, _ = jogg.read_ogg(path)
    pure, pure_sr = vorbis.read_ogg_pure(path)
    jpure, _ = jvorbis.read_ogg_pure(path)
    assert got_sr == pure_sr == sr and got.shape == (2 if stereo else 1, x.shape[-1])
    assert np.array_equal(got, want) and np.array_equal(pull, jpull) and np.array_equal(pure, jpure)
    assert np.array_equal(got, pull)
    assert np.abs(pure - got).max() < VORBIS_ATOL
    assert np.array_equal(audio_io.read_audio(path)[0], got)


@needs_xiph
def test_ogg_without_libvorbisfile_uses_the_numpy_decoder(tmp_path, monkeypatch):
    ogg.write_ogg(tmp_path / "x.ogg", _tone(16000, 0.3), 16000)
    want, _ = jvorbis.read_ogg_pure(tmp_path / "x.ogg")
    monkeypatch.setattr(native, "ogg_decode", lambda p: None)
    monkeypatch.setattr(ogg, "_libs", lambda: (None, None, None, None))
    got, sr = ogg.read_ogg(tmp_path / "x.ogg")
    assert sr == 16000 and np.array_equal(got, want)


def test_committed_vorbis_fixture_decodes_as_expected():
    """The committed Ogg fixture and its expected decode, which chip_smoke.py holds the numpy decoder to
    on a host without libvorbis: the port's numpy decode equals JAX's and lies within VORBIS_ATOL of the
    expectation, and where libvorbisfile loads, its pull loop gives the expectation again."""
    want = np.load(vorbis_fixture.EXPECTED)
    got, sr = vorbis.read_ogg_pure(vorbis_fixture.FIXTURE)
    jgot, _ = jvorbis.read_ogg_pure(vorbis_fixture.FIXTURE)
    n = int(vorbis_fixture.RATE * vorbis_fixture.SECONDS)
    assert sr == vorbis_fixture.RATE and got.shape == want.shape == (2, n) and want.dtype == np.float32
    assert np.array_equal(got, jgot)
    assert float(np.abs(got - want).max()) < VORBIS_ATOL
    if ogg.system_decoder_available():
        pull, _ = ogg.read_ogg_pull(vorbis_fixture.FIXTURE)
        assert float(np.abs(pull - want).max()) < VORBIS_ATOL


@needs_lame
@pytest.mark.parametrize("sr,channels", [(44100, 1), (32000, 2)])
def test_mp3_equals_jax_and_is_gapless(sr, channels, tmp_path):
    x = _tone(sr, 0.5) if channels == 1 else np.stack([_tone(sr, 0.5), _tone(sr, 0.5, freqs=(554.0,), amps=(0.4,))])
    mp3.write_mp3(tmp_path / "t.mp3", x, sr)
    got, got_sr = audio_io.read_audio(tmp_path / "t.mp3")
    want, want_sr = jmp3.read_mp3(tmp_path / "t.mp3")
    assert got_sr == want_sr == sr and got.shape == (channels, x.shape[-1]) and np.array_equal(got, want)


def _tiny_task():
    cfg = BigVGANConfig(hop_length=16, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), num_mels=8,
                        upsample_initial_channel=32, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
    task = gan.GANTaskConfig(sampling_rate=8000, n_fft=64, hop_length=16, win_length=64, num_mels=8,
                             generator_name="bigvgan", generator=cfg)
    return task, random_state_dict(cfg, 0)


def test_cli_infer_reads_flac_as_its_wav(tmp_path, monkeypatch):
    """The same 16-bit PCM as .wav and as .flac: cli.infer --device cpu writes bit-equal WAVs."""
    task, sd = _tiny_task()
    torch.save({"state_dict": {f"generator.{k}": v for k, v in sd.items()}}, tmp_path / "g.ckpt")
    monkeypatch.setattr(infer, "build_task_config", lambda model, resolution: task)
    rng = np.random.default_rng(5)
    pcm = np.clip(np.rint(_tone(8000, 0.3, freqs=(300.0,), amps=(0.4,)) * 32768)
                  + rng.integers(-200, 200, 2400), -32768, 32767).astype(np.int64)
    for sub, write in (("wav", lambda p: write_wav(p / "x.wav", (pcm / 32768.0).astype(np.float32), 8000)),
                       ("flac", lambda p: flac.write_flac(p / "x.flac", pcm[None], 8000))):
        (tmp_path / sub).mkdir()
        write(tmp_path / sub)
        infer.main(["--model", "bigvgan", "--ckpt", str(tmp_path / "g.ckpt"), "--input", str(tmp_path / sub),
                    "--output", str(tmp_path / f"out_{sub}"), "--device", "cpu"])
    assert np.array_equal(audio_io.read_audio(tmp_path / "wav" / "x.wav")[0],
                          audio_io.read_audio(tmp_path / "flac" / "x.flac")[0])
    a = (tmp_path / "out_wav" / "x.wav").read_bytes()
    assert a == (tmp_path / "out_flac" / "x.wav").read_bytes() and read_wav(tmp_path / "out_wav" / "x.wav")[0].size


def _mixed_corpus(root):
    root.mkdir()
    sr = 16000
    write_wav(root / "a.wav", _tone(sr, 0.6, freqs=(200.0,), amps=(0.4,)), sr)
    flac.write_flac(root / "b.flac", _tone(sr, 0.7, freqs=(260.0,), amps=(0.4,)), sr)
    if ogg.encoder_available():
        ogg.write_ogg(root / "c.ogg", _tone(sr, 0.5, freqs=(330.0,), amps=(0.4,)), sr)
    if mp3.encoder_available():
        mp3.write_mp3(root / "d.mp3", _tone(sr, 0.5, freqs=(410.0,), amps=(0.4,)), sr)
    return sr


def test_mixed_corpus_batches_equal_jax(tmp_path):
    """A Dataset over WAV + FLAC + Ogg + MP3: the port's batches are the JAX package's."""
    sr = _mixed_corpus(tmp_path / "mix")

    def sampler(ds_mod, tr_mod):
        tr = tr_mod.train_transform(sampling_rate=sr, hop_length=64, num_frames=32)
        ds = ds_mod.VocoderDataset(root=tmp_path / "mix", transform=tr)
        return ds_mod.MixDataset(datasets=[ds], probs=[1.0]).sample, len(ds)

    (s_port, n_port), (s_jax, n_jax) = sampler(dataset, transforms), sampler(jdataset, jtransforms)
    assert n_port == n_jax == len(list((tmp_path / "mix").iterdir()))
    kw = dict(batch_size=4, target_length=64 * 32, seed=3)
    got, want = dataset.batch_iterator(s_port, num_workers=2, **kw), jdataset.batch_iterator(s_jax, **kw)
    for _ in range(3):
        g, w = next(got), next(want)
        np.testing.assert_array_equal(g["lengths"], w["lengths"])
        np.testing.assert_allclose(g["audio"], w["audio"], rtol=0, atol=1e-6)
        assert np.abs(g["audio"]).max() > 0.01
    got.close()
    want.close()


@pytest.mark.parametrize("name,blob", [("broken.flac", b"fLaC" + b"\x00" * 16),
                                       ("broken.ogg", b"OggS" + bytes(range(256))),
                                       ("broken.mp3", b"\xff\xfb" + bytes(range(256)) * 4)])
def test_corrupt_file_falls_back_to_counted_silence(name, blob, tmp_path):
    if name.endswith(".mp3") and ".mp3" not in audio_io.DECODABLE_EXTENSIONS:
        pytest.skip("libmpg123 not present")
    (tmp_path / name).write_bytes(blob)
    la = transforms.LoadAudio(sampling_rate=8000)
    for n in (1, 2):
        audio = la(np.random.default_rng(0), str(tmp_path / name))
        assert audio.shape == (1, 8000 * 10) and not audio.any() and la.fallback_count == n
