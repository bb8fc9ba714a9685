"""The port's HuBERT (``models/hubert.py``) and the ssl family's frozen extractor against ``transformers``, on
the CPU.

The JAX package's ``HubertFeatureExtractor`` builds ``transformers.HubertModel(HubertConfig(hidden_size=768))``
with random weights when ``from_pretrained`` fails; the tests make it fail at once (``from_pretrained``
patched to raise, so nothing is fetched) and seed torch's global RNG around the build.  Its state_dict,
as numpy arrays through ``convert.hubert_state_dict_from_numpy``, loads into the port's model with
strict keys; the outputs are held at rtol 1e-4 / atol 1e-4 in fp32 (12 post-LN layers over 63 frames).
Local snapshots are written by ``transformers`` itself (``save_pretrained``, offline) or, for the old
``pytorch_model.bin`` layout, by ``torch.save`` here.  The tests import ``transformers``; the port does not.
"""

import json
import os

import numpy as np
import pytest
import torch
import transformers

from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu.models import ssl_encoders as jssl
from vocoder_tpu_torch.convert import hubert_state_dict_from_numpy
from vocoder_tpu_torch.models import hubert, ssl_encoders

RTOL = ATOL = 1e-4
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64, conv_dim=(16,) * 7,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.fixture
def offline(monkeypatch):
    """transformers' from_pretrained raises unless given a local directory, as it does with no network."""
    real = transformers.HubertModel.from_pretrained.__func__

    def from_pretrained(cls, name, *args, **kw):
        if not isinstance(name, str) or not name.startswith("/") or not os.path.isdir(name):
            raise OSError(f"{name}: no local snapshot (network disabled in the tests)")
        return real(cls, name, *args, **kw)

    monkeypatch.setattr(transformers.HubertModel, "from_pretrained", classmethod(from_pretrained))


def _audio(n: int = 2, t: int = 20480, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tt = np.arange(t) / 16000
    return (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (n, 1)) * tt) + 0.05 * rng.standard_normal((n, t))
            ).astype(np.float32)


def test_full_width_backbone_matches_the_jax_extractor(tmp_path, offline):
    """The default HubertConfig (12 layers, 768 wide, 94 M parameters): the JAX extractor's random backbone,
    bridged, loads with strict keys; 2 clips of 20,480 samples give its (2, 63, 768) last hidden state.
    The port's own extractor without a snapshot builds the same architecture from seed 0, frozen."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        jax_extractor = jssl.HubertFeatureExtractor(jssl.HubertEncoderConfig(model_name_or_path=str(tmp_path / "no")))
    sd = {k: v.numpy() for k, v in jax_extractor.model.state_dict().items()}
    model = hubert.HubertModel(hubert.HubertConfig())
    assert model.load_state_dict(hubert_state_dict_from_numpy(sd), strict=True)
    audio = _audio()
    want = jax_extractor(audio)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(audio)).numpy()
    assert want.shape == got.shape == (2, 63, 768)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    port = ssl_encoders.HubertFeatureExtractor(ssl_encoders.HubertEncoderConfig(), "cpu")
    assert not any(p.requires_grad for p in port.model.parameters()) and not port.model.training
    assert sum(p.numel() for p in port.model.parameters()) == sum(v.size for v in sd.values())
    feats = port(torch.from_numpy(audio[:1, :6400]))
    assert feats.shape == (1, 19, 768) and feats.dtype == torch.float32 and bool(torch.isfinite(feats).all())


def test_random_init_follows_transformers_distributions():
    """``random_state_dict`` against HubertPreTrainedModel._init_weights at a reduced width: the same keys
    and shapes, norms at 1 and 0, zero biases, the positional conv's gain the norm of its direction, and each
    drawn tensor's mean and spread within sampling error of transformers' draw; the same seed the same
    weights."""
    kw = dict(hidden_size=96, num_hidden_layers=2, num_attention_heads=4, intermediate_size=192, conv_dim=(64,) * 7)
    cfg = hubert.HubertConfig(**kw)
    got = hubert.random_state_dict(cfg, 3)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        want = transformers.HubertModel(transformers.HubertConfig(**kw)).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
    for key, w in want.items():
        g = got[key]
        if w.std() == 0:  # constants: norms and biases
            assert torch.equal(g, w), key
        elif key.endswith("original0"):
            v = got[key.replace("original0", "original1")]
            torch.testing.assert_close(g, torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True))
        else:
            n = w.numel()
            assert abs(float(g.mean() - w.mean())) < 6 * float(w.std()) / n ** 0.5, key
            assert abs(float(g.std() / w.std()) - 1) < 6 / n ** 0.5 + 1e-3, key
    again = hubert.random_state_dict(cfg, 3)
    assert all(torch.equal(again[k], got[k]) for k in got)


@pytest.mark.parametrize("layout", ["safetensors", "pytorch_model.bin"])
def test_local_snapshot_loads_without_transformers(tmp_path, layout, offline):
    """A tiny HuBERT saved by ``save_pretrained`` (model.safetensors), or as an old-style pytorch_model.bin
    (weight_g / weight_v, a ``hubert.`` prefix, a pretraining head's tensor the model does not have), loads
    through the port's extractor with its own config.json and gives transformers' output; the JAX
    extractor's ``from_pretrained`` of the same directory does too."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        ref = transformers.HubertModel(transformers.HubertConfig(**TINY)).eval()
    snap = tmp_path / "snap"
    ref.save_pretrained(snap)
    if layout == "pytorch_model.bin":
        (snap / "model.safetensors").unlink()
        old = {}
        for k, v in ref.state_dict().items():
            k = k.replace("parametrizations.weight.original0", "weight_g").replace("parametrizations.weight.original1",
                                                                                  "weight_v")
            old[f"hubert.{k}"] = v.clone()
        old["label_embeddings_concat"] = torch.zeros(3, 4)
        torch.save(old, snap / "pytorch_model.bin")
    audio = _audio(2, 4000, seed=2)
    with torch.no_grad():
        want = ref(torch.from_numpy(audio)).last_hidden_state.numpy()
    port = ssl_encoders.HubertFeatureExtractor(ssl_encoders.HubertEncoderConfig(model_name_or_path=str(snap),
                                                                                hidden_size=32), "cpu")
    assert port.model.cfg == hubert.HubertConfig(**TINY)
    np.testing.assert_allclose(port(torch.from_numpy(audio)).numpy(), want, rtol=RTOL, atol=ATOL)
    jax_side = jssl.HubertFeatureExtractor(jssl.HubertEncoderConfig(model_name_or_path=str(snap), hidden_size=32))
    np.testing.assert_allclose(jax_side(audio), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="32 wide"):
        ssl_encoders.HubertFeatureExtractor(ssl_encoders.HubertEncoderConfig(model_name_or_path=str(snap),
                                                                             hidden_size=48), "cpu")


@pytest.mark.parametrize("field,value", [("do_stable_layer_norm", True), ("feat_extract_norm", "layer"),
                                         ("conv_pos_batch_norm", True)])
def test_snapshot_of_another_architecture_is_refused(tmp_path, field, value):
    (tmp_path / "config.json").write_text(json.dumps({**TINY, field: value}))
    with pytest.raises(ValueError, match=field):
        hubert.load_snapshot(tmp_path)


def test_read_safetensors_every_dtype(tmp_path):
    """The numpy reader against the safetensors package's writer: fp32, fp16, bf16, int64, bit for bit."""
    from safetensors.torch import save_file

    rng = np.random.default_rng(4)
    base = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    tensors = {"a": base, "b": base.half(), "c": base.bfloat16(), "d": torch.arange(7, dtype=torch.int64),
               "e": torch.zeros(0, 2)}
    save_file(tensors, tmp_path / "x.safetensors")
    got = hubert.read_safetensors(tmp_path / "x.safetensors")
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_extractor_runs_fp32_with_tf32_off_whatever_the_flags(tmp_path):
    """Inside a call both TF32 flags are off and the input is fp32 (a bf16 clip is cast); after it the
    caller's flags are back."""
    with torch.random.fork_rng(devices=[]):
        transformers.HubertModel(transformers.HubertConfig(**TINY)).save_pretrained(tmp_path)
    extractor = ssl_encoders.HubertFeatureExtractor(
        ssl_encoders.HubertEncoderConfig(model_name_or_path=str(tmp_path), hidden_size=32), "cpu")
    seen = []
    extractor.model.register_forward_pre_hook(lambda m, args: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, args[0].dtype)))
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        out = extractor(torch.from_numpy(_audio(1, 4000)).bfloat16())
        assert seen == [(False, False, torch.float32)] and out.dtype == torch.float32 and not out.requires_grad
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
