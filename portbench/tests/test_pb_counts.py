"""The counts of ``flops/`` against a count of the port's own layers, taken with hooks at a tiny width."""

import importlib.util

import pytest
import torch
from torch import nn

from portbench import counts, program
from portbench.tests import tiny


def _flops_module(name):
    spec = importlib.util.spec_from_file_location(f"flops_{name}", tiny.SRC / "flops" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hook_macs(model: nn.Module, call) -> int:
    """Multiply-adds of every Conv1d/2d and ConvTranspose1d the call runs, and 24 per sample and channel of
    every BigVGAN anti-aliased activation (its two 12-tap FIRs)."""
    total = [0]

    def conv(m, inputs, out):
        k = m.weight.shape[2:].numel()
        if isinstance(m, nn.ConvTranspose1d):
            x = inputs[0]
            total[0] += x.shape[0] * x.shape[1] * x.shape[2] * m.out_channels * k
        else:
            total[0] += out.numel() * (m.in_channels // m.groups) * k

    def act(m, inputs, out):
        total[0] += counts.FIR_MACS * inputs[0].numel()

    hooks = []
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
            hooks.append(m.register_forward_hook(conv))
        elif type(m).__name__ == "Activation1d":
            hooks.append(m.register_forward_hook(act))
    try:
        with torch.no_grad():
            call()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


@pytest.mark.parametrize("config", ["bigvgan-44k", "hifigan-44k"])
def test_forward_flops_match_the_ports_layers(config):
    from vocoder_tpu_torch.models.registry import get_generator

    cfg = tiny.tiny_config(config)
    task = program.task_config(cfg)
    model = get_generator(task.generator_name).module_cls(task.generator).train()  # block by block: every layer runs
    frames = 23
    mel = torch.randn(2, cfg["audio"]["num_mels"], frames) - 5.0
    macs = hook_macs(model, lambda: model(mel))
    assert _flops_module(config).forward_flops(cfg, 2 * frames) == pytest.approx(2.0 * macs, rel=1e-12)


def test_discriminator_counts_match_the_ports_layers():
    from vocoder_tpu_torch.models.mpd import MultiPeriodDiscriminator
    from vocoder_tpu_torch.models.mrd import MultiResolutionDiscriminator

    cfg = tiny.tiny_config("bigvgan-44k")
    task = program.task_config(cfg)
    mpd, mrd = MultiPeriodDiscriminator(task.mpd), MultiResolutionDiscriminator(task.mrd)
    crop = torch.randn(3, 1, cfg["train"]["crop_length"])
    assert counts.mpd_macs(cfg["train"], 3, crop.shape[-1]) == hook_macs(mpd, lambda: mpd(crop))
    assert counts.mrd_macs(cfg["train"], 3, crop.shape[-1]) == hook_macs(mrd, lambda: mrd(crop))
    step = _flops_module("bigvgan-44k").train_step_flops(cfg, 3, cfg["train"]["num_frames"])
    g = _flops_module("bigvgan-44k").forward_flops(cfg, 3 * cfg["train"]["num_frames"])
    d = 2 * (counts.mpd_macs(cfg["train"], 3, crop.shape[-1]) + counts.mrd_macs(cfg["train"], 3, crop.shape[-1]))
    assert step == pytest.approx(3 * g + 7 * d)


def test_published_sizes():
    """The full configurations' counts: 681.6 and 651.1 MFLOP a frame, K2's bound ops-bound at b16."""
    import json

    big = json.loads((tiny.SRC / "configs" / "bigvgan-44k.json").read_text())
    hifi = json.loads((tiny.SRC / "configs" / "hifigan-44k.json").read_text())
    assert _flops_module("bigvgan-44k").forward_flops(big, 1) == pytest.approx(681.623552e6)
    assert _flops_module("hifigan-44k").forward_flops(hifi, 1) == pytest.approx(651.149312e6)
    stages = counts.upsampler_stage_macs(big["generator"], 1, aa=True)
    assert [s["c"] for s in stages] == [256, 128, 64, 32, 16] and [s["t"] for s in stages] == [8, 64, 128, 256, 512]
    bound = counts.amp_stage_bound_s(big["generator"], 16 * 600, 495e12, 3.35e12)
    stages = counts.upsampler_stage_macs(big["generator"], 9600, True)
    ops_only = sum(2.0 * (s["convs"] + s["fir"]) for s in stages) / 495e12
    assert bound == pytest.approx(ops_only)
