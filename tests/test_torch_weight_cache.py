"""The one rule for state made from weights (``vocoder_tpu_torch/utils/weight_cache.py``), held by each cache
that keeps such state: K2's stage plans (with the wgmma kernel's tf32 halves at a 64-channel fp32 stage), K3's
tf32 packs and the bf16 eval copy of the generator.  Tensor
parallelism's gathered stages are held to it in ``tests/torch_tp_ranks.py``, where the ranks run.

Each case makes the cache's value, changes the parameters (or not), asks again and reads the cache's
``builds`` and ``hits``: a change is seen whether it bumps ``_version`` (in place), brings a new Parameter
(replaced) or swaps ``.data`` and keeps ``_version`` (a ``Module.to`` round trip through bf16, which the entry
sees because it holds the old storages); an inference tensor, which has no version counter, makes the value
anew at every call and leaves no entry.
"""

import dataclasses
from typing import Callable

import numpy as np
import pytest
import torch
from torch import nn

from vocoder_tpu_torch import config as tconfig
from vocoder_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, random_state_dict
from vocoder_tpu_torch.nn import fold_weight_norm
from vocoder_tpu_torch.ops import amp_block
from vocoder_tpu_torch.ops import linear_3xtf32 as lin3
from vocoder_tpu_torch.train import gan
from vocoder_tpu_torch.utils.weight_cache import WeightCache

CHANGES = ["none", "in_place", "replaced", "cast_round_trip", "inference_tensor"]

# A BigVGAN of two 32- and 16-channel stages of three blocks, and the trainer's tiny bf16 task around one.
NARROW = BigVGANConfig(hop_length=16, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), num_mels=8,
                       upsample_initial_channel=64)
TINY_TASK = ["task.sampling_rate=8000", "task.n_fft=64", "task.win_length=64", "task.hop_length=16",
             "task.num_mels=8", "task.num_frames=8", "task.crop_length=128", "task.generator.hop_length=16",
             "task.generator.upsample_rates=(4,4)", "task.generator.upsample_kernel_sizes=(8,8)",
             "task.generator.num_mels=8", "task.generator.upsample_initial_channel=32",
             "task.generator.resblock_kernel_sizes=(3,)", "task.generator.resblock_dilation_sizes=((1,3),)",
             "task.mpd.channels=(1,4,8)", "task.mpd.periods=(2,3)", "task.mrd.resolutions=((64,16,64),)",
             "task.stft_resolutions=((64,16,64),)", "task.compute_dtype=bfloat16"]


@dataclasses.dataclass
class Cache:
    cache: WeightCache
    owner: nn.Module  # the entry's owner
    module: nn.Module  # what a round trip casts
    slot: tuple  # (module, name) of the parameter that a change touches
    value: Callable  # asks the cache, as its caller does
    follows: Callable  # whether a value was made from the parameters as they are now


def _k2() -> Cache:
    model = BigVGAN(NARROW)
    model.load_state_dict(random_state_dict(NARROW, seed=5))
    model = fold_weight_norm(model).eval()
    blocks = list(model.resblocks[:3])
    convs = [c for b in blocks for pair in zip(b.convs1, b.convs2) for c in pair]  # in launch order

    def follows(plan) -> bool:
        return all(torch.equal(plan.weights[4 * i], amp_block.pack_conv_weight(c.weight))
                   and plan.weights[4 * i + 1].data_ptr() == c.bias.data_ptr() for i, c in enumerate(convs))

    return Cache(amp_block.stage_plans, blocks[0], model, (blocks[1].convs2[2], "weight"),
                 lambda: amp_block.stage_plan(blocks, True), follows)


def _k2_halves() -> Cache:
    """K2's plan at a 64-channel fp32 stage, which also keeps each conv's tf32 halves for the wgmma kernel."""
    cfg = dataclasses.replace(NARROW, upsample_initial_channel=128)
    model = BigVGAN(cfg)
    model.load_state_dict(random_state_dict(cfg, seed=6))
    model = fold_weight_norm(model).eval()
    blocks = list(model.resblocks[:3])
    convs = [c for b in blocks for pair in zip(b.convs1, b.convs2) for c in pair]  # in launch order

    def follows(plan) -> bool:
        return len(plan.halves) == 18 and all(
            torch.equal(plan.halves[i], torch.stack(lin3.tf32_split(amp_block.pack_conv_weight(c.weight))))
            for i, c in enumerate(convs))

    return Cache(amp_block.stage_plans, blocks[0], model, (blocks[2].convs1[1], "weight"),
                 lambda: amp_block.stage_plan(blocks, True), follows)


def _k3() -> Cache:
    rng = np.random.default_rng(3)
    lin = nn.Linear(8, 12)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy((rng.standard_normal((12, 8)) / np.sqrt(8)).astype(np.float32)))
    return Cache(lin3.weight_packs, lin, lin, (lin, "weight"), lambda: lin3.packed_weight(lin),
                 lambda halves: torch.equal(halves, torch.stack(lin3.tf32_split(lin.weight.detach()))))


def _eval_copy(monkeypatch) -> Cache:
    task = tconfig.build_train_config("bigvgan", overrides=TINY_TASK).task
    state = gan.create_train_state(task, 0, "cpu")
    t = task.hop_length * task.num_frames
    batch = {"audio": torch.from_numpy((0.3 * np.random.default_rng(0).standard_normal((1, 1, t))).astype(np.float32)),
             "lengths": torch.tensor([t])}
    made = []  # every copy the eval step made
    eval_generator = gan.eval_generator
    monkeypatch.setattr(gan, "eval_generator", lambda g, c: made.append(eval_generator(g, c)) or made[-1])
    eval_step = gan.make_eval_step(task)
    gen = state.generator

    def value() -> nn.Module:
        eval_step(state, batch)
        return made[-1]  # the copy the step ran: a kept one was the last made

    def follows(copy: nn.Module) -> bool:
        return all(torch.equal(c, m.detach().to(torch.bfloat16)) for c, m in zip(copy.parameters(), gen.parameters()))

    return Cache(gan.eval_copies, gen, gen, (gen.conv_pre.parametrizations.weight, "original1"), value, follows)


@pytest.mark.parametrize("change", CHANGES)
@pytest.mark.parametrize("name", ["k2_stage_plan", "k3_packed_weight", "eval_copy", "k2_wgmma_halves"])
def test_cache_follows_its_weights(name, change, monkeypatch):
    """The value is made once and reused while nothing changed; an in-place change, a new Parameter and a
    fp32 -> bf16 -> fp32 round trip (``_version`` kept; the entry holds the storage the value was made from,
    so the new tensor cannot take its address) each make it anew, from the parameters as they are; a
    Parameter that is an inference tensor makes it at every call and leaves no entry."""
    case = {"k2_stage_plan": _k2, "k3_packed_weight": _k3, "eval_copy": lambda: _eval_copy(monkeypatch),
            "k2_wgmma_halves": _k2_halves}[name]()
    cache, (module, pname) = case.cache, case.slot
    first = case.value()
    assert case.follows(first) and case.owner in cache._entries
    assert case.value() is first
    builds, hits = cache.builds, cache.hits
    p = getattr(module, pname)
    if change == "in_place":
        with torch.no_grad():
            p.mul_(1.5)
    elif change == "replaced":
        setattr(module, pname, nn.Parameter(p.detach() * 2.0))
    elif change == "cast_round_trip":
        version, ptr = p._version, p.data_ptr()
        case.module.to(torch.bfloat16).to(torch.float32)
        assert p._version == version  # the version counter alone would not see it
        assert ptr in {s.data_ptr() for s in cache._entries[case.owner].storages} and p.data_ptr() != ptr
    elif change == "inference_tensor":
        with torch.inference_mode():
            w = p.detach() * 3.0
        setattr(module, pname, nn.Parameter(w, requires_grad=False))
        case.value()
    again = case.value()
    made = {"none": 0, "inference_tensor": 2}.get(change, 1)
    assert (cache.builds - builds, cache.hits - hits) == (made, 1 - min(made, 1))
    assert (again is first) == (made == 0) and case.follows(again)
    assert (case.owner in cache._entries) == (change != "inference_tensor")
