"""The port's native resample (``resample_poly`` in ``csrc/audio_host.cc``, bound by ``data/native.py``)
against its numpy path and the JAX package's ``resample``, at the tolerance of
``tests/test_native_kernels.py::test_native_resample_matches_numpy`` (rtol 1e-4, atol 1e-5): the two paths
sum the same kernel table in other orders.  ``resample`` takes 1-D audio to the native path and counts it
in ``native.resamples``; other shapes, and every shape without the library, go through numpy."""

import numpy as np
import pytest

from vocoder_tpu.data import resample as jresample
from vocoder_tpu_torch.data import native, resample

RTOL, ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("orig_sr,new_sr", [(44100, 16000), (22050, 44100), (24000, 16000), (48000, 44100)])
def test_native_resample_matches_numpy_and_jax(orig_sr, new_sr, monkeypatch):
    x = np.random.default_rng(2).standard_normal(4410).astype(np.float32)
    before = native.resamples
    got = resample.resample(x, orig_sr, new_sr)
    assert native.available() and native.resamples == before + 1
    with monkeypatch.context() as m:
        m.setattr(native, "resample_native", lambda *a, **k: None)
        numpy_path = resample.resample(x, orig_sr, new_sr)
    assert native.resamples == before + 1
    want = jresample.resample(x, orig_sr, new_sr)
    assert got.shape == numpy_path.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, numpy_path, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_multichannel_and_equal_rates_stay_in_numpy():
    x = np.random.default_rng(3).standard_normal((2, 1000)).astype(np.float32)
    before = native.resamples
    out = resample.resample(x, 44100, 16000)
    assert out.shape == (2, 363) and native.resamples == before
    assert np.array_equal(resample.resample(x[0], 16000, 16000), x[0]) and native.resamples == before
    np.testing.assert_allclose(resample.resample(x[0], 44100, 16000), out[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("length", [1, 7, 100, 1000])
def test_native_resample_short_signals(length, monkeypatch):
    """Signals shorter than the filter (475 taps at 44.1 -> 16 kHz): every output's taps are cut at both
    ends, where the native kernel's run of nonzero taps meets the signal's edges."""
    x = np.random.default_rng(length).standard_normal(length).astype(np.float32)
    for orig_sr, new_sr in ((44100, 16000), (22050, 44100)):
        got = resample.resample(x, orig_sr, new_sr)
        with monkeypatch.context() as m:
            m.setattr(native, "resample_native", lambda *a, **k: None)
            want = resample.resample(x, orig_sr, new_sr)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
