"""The ranks' side of ``tests/test_torch_data_parallel.py``: what each gloo rank runs in its own process,
and the same computations as one process for the reference.  It imports the port only (no JAX), so that
a rank starts in seconds.

    python -m tests.torch_dp_ranks cases PLAN OUT      # torchrun's variables set: every case, OUT/rank<r>.pt
    torchrun --standalone --nproc_per_node 2 -m tests.torch_dp_ranks cli OUT TAG <cli.train arguments>

``cases`` runs each training case of PLAN (a JSON list of {name, model, family, overrides}) for two steps
and each component case (``COMPONENTS``) on this rank's rows of the global batch; ``cli`` runs
``cli.train.main`` and records what the rank wrote under the workdir (audit hook), the batches it trained
on and the state it restored.  Rank 1 is made late after each checkpoint it declines (``LATE_SECONDS``), so
that rank 0 has written the run's final checkpoint before rank 1 decides whether to save it: a decision
read from the directory would differ between the ranks there and pair the wrong barriers.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vocoder_tpu_torch.config import build_train_config
from vocoder_tpu_torch.losses import multi_resolution_stft_loss
from vocoder_tpu_torch.models import refinegan, vq, wavenet
from vocoder_tpu_torch.nn import drop_path, normal_like
from vocoder_tpu_torch.parallel import dist
from vocoder_tpu_torch.train import gan

GLOBAL_BATCH = 4
SEED = 5
SSL_FRAMES, SSL_HIDDEN = 63, 8  # HuBERT frames of TINY's 512-sample clip, the tiny backbone's width
COMPONENTS = ("spectral_convergence", "bnvae", "ema", "draws")
LATE_SECONDS = 1.0  # rank 1's wait after each checkpoint it declines in ``cli``


def rows(x, index: int, count: int):
    """This rank's rows of a global batch (dim 0)."""
    b = x.shape[0] // count
    return x[index * b : (index + 1) * b]


def global_batches(task, family: str, step: int) -> dict:
    """The global batch of ``step``: noise at 0.3, items cut to lengths (T, 3T/4, T/2, T) and zero past
    them; the ssl family's stand-in features, a slow random walk plus noise."""
    rng = np.random.default_rng((SEED, step))
    t = task.hop_length * task.num_frames
    lengths = np.array([t, 3 * t // 4, t // 2, t], np.int64)
    audio = (0.3 * rng.standard_normal((GLOBAL_BATCH, 1, t))).astype(np.float32)
    audio[np.arange(t)[None, None, :] >= lengths[:, None, None]] = 0.0
    batch = {"audio": torch.from_numpy(audio), "lengths": torch.from_numpy(lengths)}
    if family == "ssl":
        walk = np.cumsum(rng.standard_normal((GLOBAL_BATCH, SSL_FRAMES, SSL_HIDDEN)), axis=1) / np.sqrt(SSL_FRAMES)
        batch["ssl_features"] = torch.from_numpy((walk + 0.5 * rng.standard_normal(walk.shape)).astype(np.float32))
    return batch


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def run_case(spec: dict, index: int = 0, count: int = 1, group=None) -> dict:
    """Two training steps of ``spec``'s task from its seed on rows ``index`` of ``count`` equal shares of
    each global batch (one process: 0 of 1), in ``group``: each step's metrics and crop start, the step-1
    gradients, the state after step 2 (weights, EMA codebooks) and the noise generator's state."""
    task = build_train_config(spec["model"], "44100_512_2048", spec["family"], spec["overrides"]).task
    state = gan.create_train_state(task, SEED, "cpu")
    dist.broadcast_modules([state.generator, state.discriminators], group)
    step = gan.make_train_step(task, group=group)
    out = {"metrics": [], "starts": []}
    for s in range(2):
        batch = {k: rows(v, index, count) for k, v in global_batches(task, spec["family"], s).items()}
        start = gan.draw_crop_start(state, task, batch["audio"].shape[2])
        out["starts"].append(start)
        out["metrics"].append({k: float(v) for k, v in step(state, batch, start).items()})
        if s == 0:
            out["grads"] = _numpy({f"{m}.{n}": p.grad for m, mod in (("generator", state.generator),
                                                                     ("discriminators", state.discriminators))
                                   for n, p in mod.named_parameters() if p.grad is not None})
    out["state"] = _numpy({**{f"generator.{k}": v for k, v in state.generator.state_dict().items()},
                           **{f"discriminators.{k}": v for k, v in state.discriminators.state_dict().items()}})
    out["noise"] = state.noise.get_state().numpy()
    return out


def run_component(name: str, index: int = 0, count: int = 1, group=None) -> dict:
    """One part that couples the batch, on this rank's rows inside ``data_parallel(group)``: the spectral
    convergence (value and gradient), bnvae's posterior encoder (BatchNorm statistics, eps draws,
    gradients, running statistics), an EMA quantiser's update, and the batch-axis draws."""
    rng = np.random.default_rng((SEED, len(name)))
    out = {}
    with dist.data_parallel(group):
        if name == "spectral_convergence":
            x = torch.from_numpy(rng.standard_normal((GLOBAL_BATCH, 256)).astype(np.float32))
            y = torch.from_numpy(rng.standard_normal((GLOBAL_BATCH, 256)).astype(np.float32))
            x = rows(x, index, count).requires_grad_(True)
            sc, mag = multi_resolution_stft_loss(x, rows(y, index, count), ((64, 16, 64), (32, 8, 32)))
            (sc + mag).backward()
            out["values"] = dist.all_reduce_sum(torch.stack([sc, mag]).detach()).numpy()
            out["rows/grad"] = x.grad.numpy()
        elif name == "bnvae":
            cfg = wavenet.PosteriorEncoderConfig(in_channels=6, out_channels=4, hidden_channels=8, n_layers=2,
                                                 mode="bnvae")
            enc = wavenet.PosteriorEncoder(cfg)
            enc.load_state_dict(wavenet.random_state_dict(cfg, 3))
            noise = torch.Generator().manual_seed(SEED)
            x = torch.from_numpy(rng.standard_normal((GLOBAL_BATCH, 6, 16)).astype(np.float32))
            x = rows(x, index, count).requires_grad_(True)
            z, mean, logvar, _ = enc.train()(x, noise=noise)
            weight = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
            dist.mean_share(torch.square(z * weight) + mean).backward()
            dist.all_reduce_grads(enc.parameters())
            out.update({"rows/z": z.detach().numpy(), "rows/mean": mean.detach().numpy(),
                        "rows/grad": x.grad.numpy(), "noise": noise.get_state().numpy()})
            out.update(_numpy({f"grad/{n}": p.grad for n, p in enc.named_parameters()}))
            out.update(_numpy({f"buffer/{n}": b for n, b in enc.named_buffers()}))
        elif name == "ema":
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(SEED)
                quantiser = vq.VectorQuantizer(vq.VQConfig(dim=4, codebook_size=8, num_quantizers=2))
            x = rows(torch.from_numpy(rng.standard_normal((GLOBAL_BATCH, 4, 10)).astype(np.float32)), index, count)
            _, codes, loss = quantiser(x)
            quantiser.ema_update(x, codes)
            out["values"] = dist.all_reduce_sum(loss.detach().reshape(1)).numpy()
            out["rows/codes"] = codes.transpose(0, 1).numpy()
            out.update(_numpy({f"buffer/{n}": b for n, b in quantiser.named_buffers()}))
        elif name == "draws":
            noise = torch.Generator().manual_seed(SEED)
            ones = torch.ones(GLOBAL_BATCH // count, 3, 5)
            out["rows/drop_path"] = drop_path(ones, 0.5, True, noise).numpy()
            out["rows/adain"] = refinegan.adain_noise(ones, noise).numpy()
            out["rows/normal_like"] = normal_like(ones, noise).numpy()
            out["noise"] = noise.get_state().numpy()
        else:
            raise ValueError(name)
    return out


def digest(state) -> str:
    """sha256 of every tensor of the generator's and discriminators' state_dicts, in order."""
    h = hashlib.sha256()
    for module in (state.generator, state.discriminators):
        for v in module.state_dict().values():
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _cases(plan: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_from_env("cpu")
    index, count, group = dist.rank(), dist.world_size(), dist.world_group()
    results = {spec["name"]: run_case(spec, index, count, group) for spec in json.loads(plan.read_text())}
    results.update({name: run_component(name, index, count, group) for name in COMPONENTS})
    torch.save(results, out / f"rank{index}.pt")
    dist.close()


def _cli(out: Path, tag: str, argv: list[str]) -> None:
    """``cli.train.main(argv)`` on this rank, recording its writes under the workdir, the batches it
    trained on and the digest of the state each restore left."""
    from vocoder_tpu_torch.cli import train as train_cli
    from vocoder_tpu_torch.train import trainer
    from vocoder_tpu_torch.utils.checkpoint import CheckpointManager

    torch.set_num_threads(1)
    workdir = Path(next(a.split("=", 1)[1] for a in argv if a.startswith("run.workdir="))).resolve()
    writes, batches, restored = [], [], []

    def under(path) -> bool:
        try:
            return Path(os.fsdecode(path)).resolve().is_relative_to(workdir)
        except (TypeError, ValueError):
            return False  # a file descriptor

    def hook(event: str, args) -> None:
        if event == "open" and under(args[0]):
            mode, flags = args[1], args[2]
            if (isinstance(mode, str) and set(mode) & set("wax+")) or (
                    mode is None and flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
                writes.append([event, os.fsdecode(args[0])])
        elif event == "os.rename" and under(args[1]):
            writes.append([event, os.fsdecode(args[1])])
        elif event in ("os.mkdir", "os.remove", "os.rmdir") and under(args[0]):
            writes.append([event, os.fsdecode(args[0])])

    sys.addaudithook(hook)
    take = trainer.DevicePrefetcher.__next__

    def next_batch(self):
        batch = take(self)
        batches.append(batch["audio"].numpy().copy())
        return batch

    restore = CheckpointManager.restore

    def restore_and_record(self, state, step=None):
        restore(self, state, step)
        restored.append(digest(state))
        return state

    save = CheckpointManager.save

    def save_late(self, step, state, force=False):
        saved = save(self, step, state, force)
        if not saved:
            time.sleep(LATE_SECONDS)
        return saved

    trainer.DevicePrefetcher.__next__ = next_batch
    CheckpointManager.restore = restore_and_record
    rank = int(os.environ["RANK"])
    if rank == 1:
        CheckpointManager.save = save_late
    state = train_cli.main(argv)
    torch.save({"writes": writes, "batches": batches, "restored": restored, "step": state.step,
                "final": digest(state)}, out / f"{tag}_rank{rank}.pt")


if __name__ == "__main__":
    if sys.argv[1] == "cases":
        _cases(Path(sys.argv[2]), Path(sys.argv[3]))
    elif sys.argv[1] == "cli":
        _cli(Path(sys.argv[2]), sys.argv[3], sys.argv[4:])
    else:
        raise SystemExit(f"unknown mode {sys.argv[1]!r}: cases or cli")
