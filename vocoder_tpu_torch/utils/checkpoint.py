"""Training checkpoints: periodic saves, auto-resume, weights-only resume.

Counterpart of ``vocoder_tpu/utils/checkpoint.py``'s ``CheckpointManager`` (the
reference's ModelCheckpoint every 20k steps, keep all, and its resume logic),
with ``torch.save`` in place of Orbax, whose format is the JAX package's and is
not read here.  Step s lives in ``<directory>/<s>.pt``: the whole
``TrainState.state_dict()`` (generator, discriminators, both optimizers, the
step and the crop generator's RNG state), written to a temporary file in the
same directory and renamed over the target, so a reader never sees half a
checkpoint.  Saves are synchronous; ``wait`` returns at once.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str | Path, save_interval_steps: int = 20_000):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.save_interval_steps = save_interval_steps

    def path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir() if (m := _NAME.match(p.name)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, force: bool = False) -> bool:
        """Save ``state`` at ``step`` if ``force``, or if the step is a multiple of the interval and
        past the latest checkpoint; whether it saved."""
        latest = self.latest_step()
        if not force and (step % self.save_interval_steps or (latest is not None and step <= latest)):
            return False
        tmp = self.directory / f".{step}.pt.tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, self.path(step))
        return True

    def load(self, step: int | None = None) -> dict:
        """The checkpoint's dict (the latest by default), its tensors on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"{self.directory}: no checkpoint")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore(self, state, step: int | None = None):
        """Full resume: weights, optimizers, step and RNG state, in place."""
        state.load_state_dict(self.load(step))
        return state

    def restore_weights_only(self, state, step: int | None = None):
        """The generator's and discriminators' weights; the optimizers and the step stay fresh."""
        state.load_state_dict(self.load(step), weights_only=True)
        return state

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""
