"""The port's spans (``vocoder_tpu_torch/utils/spans.py``), on the CPU.

With no profiler recording, a tiny BigVGAN and HiFiGAN forward and a tiny train step of each build no
``torch.profiler.record_function`` (patched to raise).  Under ``torch.profiler.profile`` (CPU activity) the
forward records ``gen.forward`` holding ``gen.up.{i}`` then ``gen.stage.{i}`` for every stage, and the step
records its seven spans in order, ``mr_stft_loss`` and ``discriminators`` inside ``train.g.loss``, and
``aa_snake_backward`` inside BigVGAN's backward.  The spans change no number: the outputs with the profiler
on equal those with it off.
"""

import contextlib

import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu_torch.models import bigvgan, hifigan, mpd, mrd
from vocoder_tpu_torch.ops.aa_snake import AASnakeFunction
from vocoder_tpu_torch.train import gan
from vocoder_tpu_torch.train.schedule import WarmupCosineConfig
from vocoder_tpu_torch.utils import spans

HOP = 4
GEN = dict(hop_length=HOP, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 2),), num_mels=8, upsample_initial_channel=16)
RES = ((16, 4, 16), (32, 8, 32))
MODELS = {"bigvgan": (bigvgan.BigVGAN, bigvgan.BigVGANConfig), "hifigan": (hifigan.HiFiGAN, hifigan.HiFiGANConfig)}
STEP_SPANS = ["train.g.forward", "train.g.loss", "train.g.backward", "train.g.update", "train.d.loss",
              "train.d.backward", "train.d.update"]


def _task(name: str) -> gan.GANTaskConfig:
    return gan.GANTaskConfig(generator_name=name, generator=MODELS[name][1](**GEN), crop_length=HOP * 8,
                             mpd=mpd.MPDConfig(periods=(2, 3), channels=(1, 4, 8)),
                             mrd=mrd.MRDConfig(resolutions=RES), schedule=WarmupCosineConfig(val_base=2e-4),
                             sampling_rate=8000, n_fft=16, hop_length=HOP, win_length=16, num_mels=8,
                             stft_resolutions=RES, num_frames=16)


def _forward(name: str) -> torch.Tensor:
    torch.manual_seed(0)
    module, config = MODELS[name]
    model = module(config(**GEN)).eval()
    mel = torch.randn(2, 8, 12)
    with torch.no_grad():
        return model(mel, frame_lengths=torch.tensor([12, 9]))


def _step(name: str) -> dict:
    state = gan.create_train_state(_task(name), 0, "cpu")
    t = HOP * 16
    audio = 0.3 * torch.randn(2, 1, t, generator=torch.Generator().manual_seed(0))
    metrics = gan.make_train_step(_task(name))(state, {"audio": audio, "lengths": torch.tensor([t, t - 5])}, 7)
    return {k: float(v) for k, v in metrics.items()}


def _recorded(run) -> tuple[list, object]:
    """(the (start, end, name) of every range that ``run()`` opened under a CPU profiler, by start; its
    result)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = run()
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in prof.profiler.kineto_results.events()]
    return sorted(events), out


def _named(events, name: str) -> list:
    return [e for e in events if e[2] == name]


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_the_gate_is_one_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert spans.span("gen.forward") is spans.span("train.g.update")
    assert isinstance(spans.span("x"), contextlib.nullcontext)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(spans.span("x"), torch.profiler.record_function)


@pytest.mark.parametrize("name", ["bigvgan", "hifigan"])
def test_no_record_function_without_a_profiler(name, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record_function was built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _forward(name)
    _step(name)


@pytest.mark.parametrize("name", ["bigvgan", "hifigan"])
def test_forward_spans_under_the_profiler(name):
    events, out = _recorded(lambda: _forward(name))
    torch.testing.assert_close(out, _forward(name), rtol=0, atol=0)
    (forward,) = _named(events, "gen.forward")
    order = [e[2] for e in events if e[2].startswith("gen.") and e[2] != "gen.forward"]
    stages = len(GEN["upsample_rates"])
    assert order == [f"gen.{part}.{i}" for i in range(stages) for part in ("up", "stage")]
    for e in events:
        if e[2].startswith(("gen.up.", "gen.stage.")):
            assert _inside(e, forward), e


@pytest.mark.parametrize("name", ["bigvgan", "hifigan"])
def test_train_step_spans_under_the_profiler(name):
    events, metrics = _recorded(lambda: _step(name))
    assert metrics == _step(name)
    step = [e for e in events if e[2] in STEP_SPANS]
    assert [e[2] for e in step] == STEP_SPANS  # each once, in order
    for a, b in zip(step, step[1:]):
        assert a[1] <= b[0], (a, b)
    spans_at = dict((e[2], e) for e in step)
    (forward,) = _named(events, "gen.forward")
    assert _inside(forward, spans_at["train.g.forward"])
    (stft,) = _named(events, "mr_stft_loss")
    assert _inside(stft, spans_at["train.g.loss"])
    disc = _named(events, "discriminators")
    assert len(disc) == 4  # fake and real in each phase
    assert all(_inside(d, spans_at["train.g.loss"]) for d in disc[:2])
    assert all(_inside(d, spans_at["train.d.loss"]) for d in disc[2:])
    snake = _named(events, "aa_snake_backward")
    if name == "bigvgan":  # 2 stages x 1 block x 2 dilations x 2 activations, and the post activation
        assert len(snake) == 9
        assert all(_inside(s, spans_at["train.g.backward"]) for s in snake)
    else:
        assert snake == []


def test_aa_snake_backward_is_recorded_under_autograd():
    x = torch.randn(2, 3, 40, requires_grad=True)
    alpha, beta = torch.rand(3) + 0.5, torch.rand(3) + 0.5

    def run():
        AASnakeFunction.apply(x, alpha, beta).square().sum().backward()
        return x.grad.clone()

    events, grad = _recorded(run)
    assert len(_named(events, "aa_snake_backward")) == 1
    x.grad = None
    torch.testing.assert_close(grad, run(), rtol=0, atol=0)
