"""Scaling of the GAN training step over data-parallel sizes (weak scaling).

Counterpart of ``vocoder_tpu/cli/bench_scaling.py``:

    torchrun --standalone --nproc_per_node 8 -m vocoder_tpu_torch.cli.bench_scaling --meshes 1,2,4,8
    python -m vocoder_tpu_torch.cli.bench_scaling --model bigvgan --batch 4      # one process, one card
    python -m vocoder_tpu_torch.cli.bench_scaling --virtual 2 --tiny --meshes 1,2   # 2 gloo ranks on the CPU

For each size ``dp`` of ``--meshes``, ranks 0 .. dp - 1 form a process group and each trains on
``--batch`` items a step (the global batch grows with dp: weak scaling) through the trainer's
data-parallel step (``train/gan.py``, from seed 0, the batch noise of numpy seed 0 at amplitude 0.3, as
the JAX package's): one warm-up step, then ``--iters`` steps timed on the host clock up to a
synchronise of the card.  Sizes above the number of processes are skipped, as the JAX package skips
sizes above its devices.  Rank 0 prints one JSON line a size with the JAX package's keys:
``data_parallel``, ``step_ms``, ``audio_s_per_s`` (the global batch's audio over the step) and
``efficiency`` (throughput over dp times the first size's throughput per rank).  ``--virtual N`` spawns N
gloo ranks on the CPU (the JAX package's N virtual CPU devices); ``--tiny`` trains the port's tiny task
(``tiny_task``, the JAX tests' ``tiny_cfg(crop=True)``).  On the card each rank takes ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time

import numpy as np
import torch

from vocoder_tpu_torch.config import build_task_config
from vocoder_tpu_torch.models.hifigan import HiFiGANConfig
from vocoder_tpu_torch.models.mpd import MPDConfig
from vocoder_tpu_torch.models.mrd import MRDConfig
from vocoder_tpu_torch.parallel import dist
from vocoder_tpu_torch.train import gan
from vocoder_tpu_torch.train.schedule import WarmupCosineConfig
from vocoder_tpu_torch.train.trainer import set_precision


def tiny_task() -> gan.GANTaskConfig:
    """A HiFiGAN at hop 4 and 16 channels on 8 kHz audio, two MPD periods and MRD resolutions, 32 frames
    and a 32-sample crop: the JAX package's tests' ``tiny_cfg(crop=True)``."""
    hop = 4
    resolutions = ((16, 4, 16), (32, 8, 32))
    return gan.GANTaskConfig(
        sampling_rate=8000, n_fft=16, hop_length=hop, win_length=16, num_mels=8, generator_name="hifigan",
        generator=HiFiGANConfig(hop_length=hop, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                                resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),), num_mels=8,
                                upsample_initial_channel=16),
        mpd=MPDConfig(periods=(2, 3), channels=(1, 4, 8)), mrd=MRDConfig(resolutions=resolutions),
        stft_resolutions=resolutions, num_frames=32, crop_length=hop * 8,
        schedule=WarmupCosineConfig(val_base=2e-4, max_decay_steps=1000))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(args, device: torch.device) -> list[dict]:
    """Every size's record (on rank 0; the other ranks return an empty list)."""
    set_precision("highest")
    task = tiny_task() if args.tiny else build_task_config(args.model, args.resolution).replace(
        num_frames=args.num_frames)
    t = task.hop_length * task.num_frames
    world, rank = dist.world_size(), dist.rank()
    results, base = [], None
    for dp in [int(x) for x in args.meshes.split(",")]:
        if dp > world:
            continue
        group = torch.distributed.new_group(list(range(dp))) if world > 1 else dist.world_group()
        if rank < dp:
            state = gan.create_train_state(task, 0, device)
            dist.broadcast_modules([state.generator, state.discriminators], group)
            audio = np.random.default_rng(0).standard_normal((dp * args.batch, 1, t)).astype(np.float32) * 0.3
            mine = audio[rank * args.batch : (rank + 1) * args.batch]
            batch = {"audio": torch.from_numpy(mine).to(device),
                     "lengths": torch.full((args.batch,), t, dtype=torch.int64, device=device)}
            step = gan.make_train_step(task, group=group)
            step(state, batch)  # warm-up: the kernels' build, cuDNN's plans
            _sync(device)
            start = time.perf_counter()
            for _ in range(args.iters):
                metrics = step(state, batch)
            float(metrics["train/generator/all"])
            _sync(device)
            seconds = (time.perf_counter() - start) / args.iters
            del state
        dist.barrier()
        if rank == 0:
            rate = dp * args.batch * t / task.sampling_rate / seconds
            base = rate / dp if base is None else base
            results.append({"data_parallel": dp, "step_ms": seconds * 1e3, "audio_s_per_s": rate,
                            "efficiency": rate / (dp * base)})
            print(json.dumps(results[-1]), flush=True)
    return results


def _virtual_rank(rank: int, port: int, args) -> None:
    """One of ``--virtual``'s gloo ranks: torchrun's environment, a share of the host's cores (or fewer
    threads, where ``OMP_NUM_THREADS`` asks for fewer)."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(args.virtual), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // args.virtual)))
    bench(args, dist.init_from_env("cpu"))
    dist.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description="GAN train-step scaling over data-parallel sizes (PyTorch)")
    ap.add_argument("--virtual", type=int, default=0, help="spawn N gloo ranks on the CPU")
    ap.add_argument("--meshes", default="1,2,4,8", help="data-parallel sizes to time")
    ap.add_argument("--model", default="hifigan")
    ap.add_argument("--resolution", default="44100_512_2048")
    ap.add_argument("--batch", type=int, default=8, help="items a rank a step")
    ap.add_argument("--num-frames", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--tiny", action="store_true", help="the tiny task (CPU-friendly)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu; --virtual runs on the cpu")
    args = ap.parse_args(argv)
    if args.virtual:
        if args.device not in (None, "cpu"):
            raise SystemExit("--virtual spawns gloo ranks on the CPU; it takes no --device but cpu")
        ctx = multiprocessing.get_context("spawn")
        port = dist.free_port()
        procs = [ctx.Process(target=_virtual_rank, args=(r, port, args)) for r in range(args.virtual)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise SystemExit(f"bench_scaling: virtual ranks {failed} failed")
        return None
    device = dist.init_from_env(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu, or --virtual N")
    results = bench(args, device)
    dist.close()
    return results


if __name__ == "__main__":
    main()
