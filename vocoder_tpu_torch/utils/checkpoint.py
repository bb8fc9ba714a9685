"""Training checkpoints: periodic saves, auto-resume, weights-only resume.

Counterpart of ``vocoder_tpu/utils/checkpoint.py``'s ``CheckpointManager`` (the
reference's ModelCheckpoint every 20k steps, keep all, and its resume logic),
with ``torch.save`` in place of Orbax, whose format is the JAX package's and is
not read here.  Step s lives in ``<directory>/<s>.pt``: the whole
``TrainState.state_dict()`` (generator, discriminators, both optimizers, the
step and the crop generator's RNG state), written to a temporary file in the
same directory and renamed over the target, so a reader never sees half a
checkpoint.  Saves are synchronous; ``wait`` returns at once.  Under data
parallelism every rank takes the same decisions (the latest step is read from
the directory once, then kept), rank 0 alone writes, and every rank waits at a
barrier after each save; every rank restores from the same file.  Under tensor
parallelism the saved state holds whole tensors (``TrainState.state_dict``
gathers every shard, the explicit specs' and the storage shards of the
discriminators, of a generator without specs and of the vq codebooks, and
their moments over the model group, so every rank makes it), and a restore
gives each rank its shard; a checkpoint of a sharded run loads in one process
and the reverse.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from vocoder_tpu_torch.parallel import dist

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str | Path, save_interval_steps: int = 20_000):
        self.directory = Path(directory).absolute()
        if dist.is_main():
            self.directory.mkdir(parents=True, exist_ok=True)
        self.save_interval_steps = save_interval_steps
        self._latest = self.latest_step()  # what this process saved last, the same on every rank

    def path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(m.group(1)) for p in self.directory.iterdir() if (m := _NAME.match(p.name)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    @property
    def saved_step(self) -> int | None:
        """The latest step saved or found at the start: what every rank decides from, never the directory,
        which rank 0 may have written to before a slower rank looks."""
        return self._latest

    def save(self, step: int, state, force: bool = False) -> bool:
        """Save ``state`` at ``step`` if ``force``, or if the step is a multiple of the interval and
        past the latest checkpoint; whether it saved (on every rank: rank 0 writes, all wait for it)."""
        latest = self._latest
        if not force and (step % self.save_interval_steps or (latest is not None and step <= latest)):
            return False
        sd = state.state_dict()  # on every rank: the shards are gathered over the model group
        if dist.is_main():
            tmp = self.directory / f".{step}.pt.tmp"
            torch.save(sd, tmp)
            os.replace(tmp, self.path(step))
        self._latest = step
        dist.barrier()
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
