"""The system under test: the port's objects, built from a configuration file and the benchmark's weights.

The only module of the benchmark that imports the port
(``vocoder_tpu_torch``).  It builds what the port's entry points build:
the generator as ``cli/infer.py::load_generator`` leaves it (the state dict
loaded, weight norm folded, eval mode on the card; here from the benchmark's
tensors instead of a checkpoint file), and the training state and step of
``cli/train.py`` (``train/gan.py::create_train_state``, ``make_train_step``),
with TF32 off as both entry points set it (``nn.set_full_precision``).  The
configuration file's values replace the preset's, so the file is what runs.
"""

from __future__ import annotations

import dataclasses

import torch


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def task_config(cfg: dict):
    """The port's ``GANTaskConfig`` of the preset, with the file's generator, discriminators, losses,
    optimizer and schedule."""
    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models.mpd import MPDConfig
    from vocoder_tpu_torch.models.mrd import MRDConfig
    from vocoder_tpu_torch.models.registry import get_generator
    from vocoder_tpu_torch.train.schedule import WarmupCosineConfig

    task = build_task_config(cfg["model"], cfg["resolution"])
    gen = get_generator(task.generator_name).config_cls(**{k: _tuples(v) for k, v in cfg["generator"].items()})
    train = cfg["train"]
    mrd = _tuples(train["mrd_resolutions"])
    adam = train["adam"]
    audio = {k: v for k, v in cfg["audio"].items()}
    return dataclasses.replace(
        task, generator=gen, **audio,
        mpd=MPDConfig(**{k: _tuples(v) for k, v in train["mpd"].items()}), mrd=MRDConfig(resolutions=mrd),
        stft_resolutions=mrd, crop_length=train["crop_length"], num_frames=train["num_frames"],
        stft_weight=train["stft_weight"], mel_weight=train["mel_weight"], adam_b1=adam["b1"], adam_b2=adam["b2"],
        adam_eps=adam["eps"], weight_decay=adam["weight_decay"], schedule=WarmupCosineConfig(**train["schedule"]),
        compute_dtype=train["compute_dtype"])


def full_precision() -> None:
    from vocoder_tpu_torch.nn import set_full_precision

    set_full_precision()


def generator(cfg: dict, state: dict, device) -> torch.nn.Module:
    """The inference generator holding ``state`` (reference names), folded, in eval mode on ``device``."""
    from vocoder_tpu_torch.models.registry import get_generator
    from vocoder_tpu_torch.nn import fold_weight_norm

    task = task_config(cfg)
    model = get_generator(task.generator_name).module_cls(task.generator, device=device)
    model.load_state_dict(state)
    return fold_weight_norm(model).eval()


def train_state(cfg: dict, state_g: dict, state_d: dict, seed: int, device):
    """(task, train state holding the benchmark's weights, the train step)."""
    from vocoder_tpu_torch.train import gan

    task = task_config(cfg)
    state = gan.create_train_state(task, seed % 2**63, device)
    state.generator.load_state_dict(state_g)
    state.discriminators.load_state_dict(state_d)
    return task, state, gan.make_train_step(task)


def synthesize(model, mel: torch.Tensor, task, chunk_frames: int) -> torch.Tensor:
    """``cli/infer.py::synthesize``: one file's mel (C, num_mels, F) -> audio (C, 1, F * hop)."""
    from vocoder_tpu_torch.cli.infer import synthesize as cli_synthesize

    return cli_synthesize(model, mel, task, chunk_frames)


def min_batch_frames(task) -> int:
    from vocoder_tpu_torch.cli.infer import min_batch_frames as cli_min

    return cli_min(task)
