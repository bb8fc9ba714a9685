"""Vocos as the benchmark builds it, on the CPU: its configuration from the benchmark's file, the head's window
on the model's device, its spans, and the port against the plain reference of ``portbench/reference/vocos.py``.

The tiny Vocos has dims (8, 16, 24, 32), depths (1, 1, 3, 1), n_fft 64, hop 16 and 16 mels; vocos-huge is
built on the meta device only (651 M parameters).  The tolerance, relative L2 1e-5 in fp32, is the sum-order
noise of a few dozen fp32 layers with room to spare; the TF32 control (the reference with its convs'
operands rounded to TF32) must fail the cell's own limit.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import check, program, weights
from portbench.reference import vocos as ref
from portbench.reference.ops import Precision
from portbench.tests import tiny_vocos
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu_torch.config import build_task_config, overlay_task_config
from vocoder_tpu_torch.models.convnext import ConvNeXtConfig
from vocoder_tpu_torch.models.registry import get_generator
from vocoder_tpu_torch.models.vocos import ISTFTHeadConfig, Vocos, VocosConfig
from vocoder_tpu_torch.ops.spectral import hann_window, istft_same

ROOT = Path(__file__).resolve().parents[1] / "portbench"
TINY_GEN = tiny_vocos.TINY_GEN


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a.double() - b.double()) / torch.linalg.vector_norm(b.double()))


def test_the_config_file_builds_vocos_huge():
    file = tiny_vocos.config_file()
    task = program.task_config(file)
    huge = VocosConfig.huge()
    assert task.generator_name == "vocos"
    assert isinstance(task.generator.backbone, ConvNeXtConfig) and isinstance(task.generator.head, ISTFTHeadConfig)
    for part in ("backbone", "head"):
        got, want = getattr(task.generator, part), getattr(huge, part)
        for f in dataclasses.fields(want):
            assert getattr(got, f.name) == getattr(want, f.name), (part, f.name)
            assert type(getattr(got, f.name)) is type(getattr(want, f.name)), (part, f.name)
    assert task.generator == huge == build_task_config("vocos_huge").generator
    model = get_generator(task.generator_name).module_cls(task.generator, device="meta")
    assert sum(p.numel() for p in model.parameters()) == file["parameters"] == 651_265_696
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == ref.shapes(file["generator"])


def test_nested_mappings_follow_the_config_json_rule():
    """Mappings become the nested configs, lists tuples; a config.json tree still overlays the preset; an
    unknown key is refused."""
    cfg = VocosConfig(**TINY_GEN)
    assert cfg.backbone.depths == (1, 1, 3, 1) and cfg.head.n_fft == 64
    assert cfg == VocosConfig(backbone=ConvNeXtConfig(**{**TINY_GEN["backbone"], "depths": (1, 1, 3, 1),
                                                         "dims": (8, 16, 24, 32)}),
                              head=ISTFTHeadConfig(**TINY_GEN["head"]))
    task = build_task_config("vocos_huge")
    tree = json.loads(json.dumps(dataclasses.asdict(dataclasses.replace(task, generator=cfg))))
    assert overlay_task_config(task, tree).generator == cfg
    with pytest.raises(TypeError):
        VocosConfig(backbone={**TINY_GEN["backbone"], "width": 3}, head=TINY_GEN["head"])


def test_the_window_is_a_non_persistent_fp32_buffer():
    model = Vocos(VocosConfig(**TINY_GEN))
    assert "head.window" not in model.state_dict()
    torch.testing.assert_close(model.head.window, torch.from_numpy(hann_window(64)), rtol=0, atol=0)
    model.to(torch.bfloat16)
    assert model.head.out.weight.dtype == torch.bfloat16 and model.head.window.dtype == torch.float32
    torch.testing.assert_close(model.head.window, torch.from_numpy(hann_window(64)), rtol=0, atol=0)


def _forward() -> torch.Tensor:
    torch.manual_seed(0)
    model = Vocos(VocosConfig(**TINY_GEN)).eval()
    with torch.no_grad():
        return model(torch.randn(2, 16, 12) - 5.0, frame_lengths=torch.tensor([12, 9]))


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record_function was built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _forward()


def test_forward_spans_under_the_profiler():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = _forward()
    torch.testing.assert_close(out, _forward(), rtol=0, atol=0)
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events() if e.name().startswith("gen."))

    def inside(inner, outer):
        return outer[0] <= inner[0] and inner[1] <= outer[1]

    (forward,) = [e for e in events if e[2] == "gen.forward"]
    top = [e for e in events if e[2] != "gen.forward" and e[2] != "gen.mlp"]
    assert [e[2] for e in top] == ["gen.stage.0", "gen.stage.1", "gen.stage.2", "gen.stage.3", "gen.head"]
    assert all(inside(e, forward) for e in top)
    mlps = [e for e in events if e[2] == "gen.mlp"]
    per_stage = [sum(inside(m, s) for m in mlps) for s in top[:4]]
    assert per_stage == TINY_GEN["backbone"]["depths"] and len(mlps) == 6


def test_the_port_matches_the_reference_item_by_item_and_in_a_padded_batch():
    cfg = tiny_vocos.tiny_config()
    gen = cfg["generator"]
    params = weights.state_dict(ref.shapes(gen), lambda k: ref.init(gen, k), 2**31 + 19, "generator", "cpu")
    model = program.generator(cfg, params, "cpu")
    frames = [40, 17, 33]
    mels = [torch.randn(16, f, generator=torch.Generator().manual_seed(f)) - 5 for f in frames]
    batch = torch.zeros(3, 16, max(frames))
    for i, m in enumerate(mels):
        batch[i, :, : m.shape[1]] = m
    hop = cfg["audio"]["hop_length"]
    with torch.inference_mode():
        out = model(batch, frame_lengths=torch.tensor(frames, dtype=torch.int32))
        alone = [model(m[None])[0, 0] for m in mels]
    with torch.no_grad():
        want = [ref.forward(params, m[None], gen, Precision("fp32"))[0, 0] for m in mels]
        control = [ref.forward(params, m[None], gen, Precision("tf32"))[0, 0] for m in mels]
    for i, f in enumerate(frames):
        assert want[i].shape == (f * hop,)
        assert _rel(out[i, 0, : f * hop], want[i]) < 1e-5
        assert _rel(alone[i], want[i]) < 1e-5
    limits = check.load_limits(ROOT, tiny_vocos.CELL)
    want = [w.numpy() for w in want]
    assert check.judge(check.wave_gap([out[i, 0, : f * hop].numpy() for i, f in enumerate(frames)], want), limits)[0]
    correct, table = check.judge(check.wave_gap([c.numpy() for c in control], want), limits)
    assert not correct, table


@pytest.mark.parametrize("n_fft,hop", [(64, 16), (2048, 512)])
def test_the_references_istft_matches_the_ports(n_fft, hop):
    """The reference's overlap-add by ``F.fold`` against the port's shifted adds, on random spectra whose DC
    and Nyquist bins carry imaginary parts that both must ignore."""
    g = torch.Generator().manual_seed(n_fft)
    re, im = (torch.randn(2, n_fft // 2 + 1, 11, generator=g) for _ in range(2))
    got = istft_same(re, im, torch.from_numpy(hann_window(n_fft)), n_fft=n_fft, hop_length=hop, win_length=n_fft)
    want = ref.istft_same(re, im, n_fft, hop, n_fft)
    assert got.shape == want.shape == (2, 11 * hop)
    assert _rel(got, want) < 1e-6
