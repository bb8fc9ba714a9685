#!/usr/bin/env python3
"""Drive the PyTorch port's inference (BigVGAN, HiFiGAN, Vocos, RefineGAN, Firefly-GAN; BigVGAN also with an
f0 template), training (those, and the vae, vqvae and ssl families; fp32 and bf16, with and without activation
checkpointing; data-parallel under torchrun; tensor-parallel over two gloo ranks sharing the card), the vqvae and
HuBERT (ssl) codecs, FLAC/Ogg/MP3 input, evaluation and the benchmark CLIs on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root; needs one NVIDIA H100

Phases, in order; any failure exits non-zero:
  0. build the CUDA kernels from vocoder_tpu_torch/csrc (nvcc, sm_90a), in a thread: phases 38 and
     16, which launch no hand kernel, run during the build, each alone on the card (38, then 16);
  1. K1 (aa-snake) against its plain version at activation_post's shape,
     C = 16, T = 512 * 256, b1, b4 and b16, plus ragged T and a B * C above
     65535 rows, in fp32 and bf16; then at b16 with per-item lengths against
     the masked plain version (lengths T, 0, 1, under the 12-sample halo,
     the 3968-output tile's edges +- 1 and random ones), exactly 0 past each;
  2. K2 (AMP stage, csrc/amp_conv_mma.cu) against its plain stage at the
     five stage shapes of the 44.1 kHz preset, F = 256 frames, b1 and b16: fp32
     through the 3xTF32 route, bf16 through the bf16 route against the
     plain stage that rounds the same conv inputs to bf16; then every stage
     at b16 with per-item lengths (as K1's, with K2's time tile's edges)
     against the masked plain stage, exactly 0 past each length;
  3. the full-width BigVGAN (random weights from a numpy seed, saved as a
     `generator.` checkpoint) through `cli.infer.main` (fp32) on generated
     WAVs and one .npy mel, one file longer than --chunk-frames; K1's and
     the fp32 K2 route's launch counts must be > 0 for that run; then the
     kernel path against the plain path on the same mel in fp32; then the
     same model in bf16 through `BigVGAN.forward` against its plain path,
     K1's and the bf16 K2 route's counts > 0 for that forward;
  4. a padded batch of 8 mels (64 ... 300 frames) through
     `BigVGAN.forward(mel, frame_lengths)`, fp32 and bf16, against each mel's
     own forward, the kernels' counts > 0 for each masked forward;
  5. HiFiGAN and Vocos at full width (44.1 kHz presets, random weights from
     numpy seed 0): finite outputs, and a padded batch against per-item runs;
  6. the batched CLI: `--batch 4` against `--batch 1` over WAVs of different
     lengths, a stereo one, a long one and a .npy mel, for bigvgan (the
     kernels' counts > 0 in the batched run), hifigan and vocos;
  7. CUDA-event timings of K1, both K2 routes and the generator in bf16 and
     fp32 at b1 and b16, with K2's yardsticks (the stage's convs alone in
     cuDNN, the design's traffic floor) and each kernel's host time per
     launch.  K1's launches are queued behind a spin kernel, so its time is
     the card's alone (`device_time`, vocoder_tpu_torch/tools/timing.py).
     Then BigVGAN's masked b16 forward against the unmasked one at the same
     padded shape, HiFiGAN's and Vocos' forwards at b1 and b16 in both
     dtypes, and the CLI's seconds at --batch 1 and --batch 16 over 16 WAVs;
  8. BigVGAN with an f0 template (the 44.1 kHz preset, use_template=True):
     `BigVGAN.forward(mel, template=)` against `forward_plain` in fp32 and
     bf16 at the generator limits (K1 and the dtype's K2 route launched, no
     stage block by block, a zero template moves the output), then
     `cli.infer --ckpt <workdir>` whose config.json records use_template on
     voiced WAVs (K1 and K2 counts > 0, each output F * hop samples);
  9. RefineGAN (24 kHz preset) and Firefly-GAN (44.1 kHz) at full width
     through `cli.infer` on WAVs (Firefly also a .npy mel and a file past
     --chunk-frames): finite output of each file's length; RefineGAN twice,
     equal to the bit.  The CLI over 16 WAVs for refinegan, split into the
     host's f0 seconds and the forwards'; then the generator ms, audio-s/s,
     card busy share and launches (`tools/profile_forward.py`) of BigVGAN
     with a template (b1, b16; bf16, fp32; K2's share of the forward),
     RefineGAN and Firefly-GAN (b16; fp32);
 10. K1 under autograd (`AASnakeFunction`: the kernel forward, the backward
     kernel `csrc/aa_snake_bwd.cu`) against autograd through the plain version,
     fp32, at C = 16, 256, 512, T = K1's tile edge +- 1, under the halo and
     65,536, B = 1 and 4: dx, d alpha and d beta; then the backward kernel
     against `aa_snake_plain_vjp` in fp32 at those C and B, T = 1, 2, under the
     halo, its own tile edge +- 1 and 65,536, the upstream gradient contiguous
     and as a channel shard's view, one count a call; then its card time at the
     b16 step's five stage shapes in fp32 and bf16 beside its bound and the
     plain VJP's;
 11. one full-width training step (`train.gan.make_train_step`, 44.1 kHz
     presets, b2 x 65,536 samples, fp32, TF32 off) with the kernels against
     the same step through the plain versions, from the same weights, batch
     and crop start: every loss, the grad norms and every generator gradient,
     for BigVGAN (K1 and its backward launched 91 times each in the step),
     HiFiGAN and BigVGAN with an f0 template (its batch carrying each item's
     template; K1 and its backward 91 times each);
 12. `cli.train.main --model bigvgan` at the preset's batch 16 x 128 frames on
     32 generated WAVs, 3 steps with a validation at 2 (K2 in validation,
     the blockwise AMP path in training only), then a resume to step 4, then
     `cli.infer --ckpt <workdir>` from that run;
 13. the training step's ms by phase, audio-s/s, peak memory and the card-time
     shares of its parts at b16 (vocoder_tpu_torch/tools/profile_train.py);
 14. `cli.train.main --model refinegan --resolution 24000_256_1024` at the
     preset's batch 16 x 128 frames (f0 templates made on the host), 2 steps
     with a validation at 2, a resume to 3 (the AdaIN noise generator on the
     card, restored from the checkpoint) and `cli.infer --ckpt <workdir>`;
     then the RefineGAN step at b16 as in 13, with the host's f0 seconds for
     one batch and the CLI run's input wait;
 15. `cli.codec` at the vqvae preset's full width (44.1 kHz: a 16-layer
     WaveNet of 256 over 1,025 bins, a 4,096 x 512 EMA codebook, a
     512-channel HiFiGAN decoder) from a seeded training workdir: `encode`
     and `decode` on the card over generated WAVs (one stereo, one at
     22.05 kHz) and `encode --device cpu`; the card's codes equal the CPU's
     wherever a frame's margin allows (the share under it is printed), each
     decoded WAV equals the generator's eval forward on the card; encode and
     decode audio-s/s and seconds;
 16. the training step of vae, vqvae, Vocos and Firefly-GAN at their presets'
     widths and batch 16, as in 13 (ms by phase, audio-s/s, peak memory, card
     busy share, top kernels; one timed step each), during the build;
 17. one step of each of those four at full width and reduced depth (b2,
     8,192 samples, a 4,096-sample crop, TF32 off) on the card against the
     same step on the CPU, the same draws (drop_path, eps) on both: losses,
     gradients, updated parameters and the vqvae's EMA codebook;
 18. `cli.train --family vqvae` at the preset's batch 16 x 32 frames: 4 steps
     with validation every 2, a resume to 6, the codebooks checkpointed;
 19. the host audio library (vocoder_tpu_torch/csrc/audio_host.cc, built by the
     system C++ compiler): its build seconds and which codec libraries load; its
     resample of 30 s of 44.1 kHz audio to 16 kHz against the numpy path (equal
     within rtol 1e-4, counted in native.resamples) and the speed-up;
 20. decoders on fixtures from the port's own encoders: FLAC at 16 / 24 bit,
     mono / stereo, 44.1 / 22.05 kHz (native and numpy decodes equal to the
     quantised source, bit for bit), Ogg q0.6 (native loop equal to the pull
     loop, the numpy Vorbis decoder within 5e-6), MP3 (gapless, SNR > 25 dB);
     each path's decode audio-s/s on this host; a format whose library is
     absent prints `"skipped"`;
 21. `cli.train --model bigvgan` at the preset's batch 16 x 128 frames over a
     FLAC + Ogg + MP3 corpus of 16 files, 4 steps, validation at step 4 over FLAC
     clips with the default `run.val_pesq`: a PESQ in [1, 4.65], K1 91 a step,
     K2 in validation, native FLAC decodes, the input wait, the validation split
     into eval forwards (CUDA events) and host PESQ, the media PNG;
 22. `cli.infer` from that workdir over the FLAC clips, then `cli.evaluate
     val synth --sr 44100 --glob-pattern '*.flac'` on the card with `--workers 1`
     and `4` (PESQ and SI-SDR equal, spec_diff and MCD within 1e-4), an
     identity run at PESQ's fixed points, seconds per pair;
 23. one BigVGAN bf16 training step (task.compute_dtype=bfloat16, b2 x 65,536
     samples, full width) through K1 against the same step through the plain
     versions; the run's floor first (the plain bf16 step against the plain fp32
     step): the kernel step's losses and generator gradients (relative L2 of the
     vectors) within twice that floor, capped at 2e-2 and 5e-2; K1 and its
     backward 91 launches each;
 24. K1's bf16 route under autograd at phase 10's shapes (bf16 x, alpha, beta cast
     from fp32 leaves): dx, d alpha, d beta against the plain version's, within
     twice the plain bf16-vs-fp32 distance (capped at 5e-2); then the backward
     kernel against `aa_snake_plain_vjp` in bf16 as in phase 10;
 25. an fp32 b16 BigVGAN step with task.generator.checkpointing=True against the
     step without it: losses within 1e-5, gradients within rel L2 1e-4, K1 91 and
     181 launches, its backward 91 in each, the peak memory of each;
 26. the bf16 step at b16 by phase, rate, peak memory and card-time shares
     (tools/profile_train.py);
 27. `cli.train task.compute_dtype=bfloat16` over phase 21's corpus, 6 steps with the
     default validation at steps 3 and 6: steps 3-6 and their input wait through the
     DevicePrefetcher, K1 and K2's bf16 route launched (K2 fp32 not), each
     validation's first fake within rel L2 5e-3 of the plain bf16 eval of the same
     weights (the weights change between them: K2's plan cache must follow);
 28. `run.profile_steps=(2,3)`: the Chrome trace under <workdir>/profile/ names K1;
 29. `cli.bench_train` for BigVGAN in bf16 and HiFiGAN in bf16 and fp32 at b16 with
     --memory-stats, one timed step each (a smoke of the CLI; phase 13 times BigVGAN's fp32 step);
 30. `cli.bench_input --prefetch` over phase 21's corpus at 1 and 4 workers, the
     consumer holding each batch for phase 27's step time: host batches/s, the wait;
 31. the ssl family's frozen HuBERT (the port's own, 12 layers, 768 wide, the random
     backbone of seed 0) on the card against the same weights on the CPU, fp32 with
     TF32 off, b2 x 20,480 samples: rel L2 <= 1e-4, the max relative error, the TF32
     flags restored after the call; then its ms a b16 x 20,480 batch (CUDA events);
 32. one ssl training step at the 16 kHz preset's full width (post-net, a 4,096 x 512
     codebook, the 512-channel decoder at hop 640), b2, on the card against the same
     step on the CPU with the same features and draws, by phase 17's rules;
 33. `cli.train --family ssl --resolution 16000_640_2048` at the preset's batch 16 x 32
     frames: 4 steps with validation every 2, a resume to 6 with the codebooks
     checkpointed; the steps' ms, audio-s/s and the backbone's share of each;
 34. `cli.codec --family ssl` as phase 15: encode and decode on the card and `encode
     --device cpu`, codes equal above the margin, each WAV the eval forward; audio-s/s;
 35. `cli.bench_infer` for BigVGAN, HiFiGAN and Vocos at b16 x 256 frames in bf16 and
     fp32, each within 15% of `profile_forward`'s generator ms in the same run;
 36-37 run in child processes beside phases 17, 18, 23, 24 and 25 (all checks, none a timing), started
 after 15 and read after 25 (23-25 run right after 18):
 36. `torchrun --standalone --nproc_per_node 1 -m vocoder_tpu_torch.cli.train` (NCCL at world size 1)
     with phase 12's first run's arguments over its corpus (BigVGAN at full width, b16 x 128 frames, 3
     steps, a validation at 2): its metrics.jsonl against that one-process run's within DP_CLI_REL;
     K1 and K2 launched in the child;
 37. two processes on the one card over gloo, each BigVGAN's training step at full width on b2 through K1,
     against one process's b4 step on the concatenated batch: losses, grad norms, every gradient, the
     updated weights, the ranks' weights equal; then the same two as one model group of tensor
     parallelism (parallel/tp.py), each against one process on the card: (a) BigVGAN at the preset,
     folded, b4 x 256 frames, fp32 twice, with lengths and bf16, each stage K2 on the gathered stage (90
     K2 launches a rank a forward, the gathered stages' plans packed once) and K1; (b) vocos-huge (650 M)
     and (c) HiFiGAN at the preset, fp32, and a rank's share of vocos-huge's bytes; (d) BigVGAN's b2
     step at full width, K1 under autograd on channel shards, the MPD in storage shards: losses, grad
     norms, every gathered gradient, the weights after AdamW, the ranks' whole states equal to the bit;
     (e) one vqvae step at the preset's width (2 WaveNet layers, one resblock a stage), b2 x 8,192
     samples, a 4,096-sample crop, every large tensor (the codebook too) in storage shards: as (d), and
     the EMA codebook; (f) Firefly-GAN at the preset through `cli.infer.load_generator` with the model
     group (folded, in storage shards), b4 x 256 frames, fp32; each rank's bytes held for (d)-(f) against
     one process's.  Their times are of two gloo ranks sharing one card;
 38. `cli.bench_scaling --meshes 1,2` under torchrun: the line of dp 1 alone (one card); during the
     build (0), before phase 16.

A `timeline` line gives the seconds from the start to the end of each phase.

Prints the card's name and power limit first, one JSON line per check and
timing, a `{"kernels": [...]}` line and, last, `{"ok": true, "device": {...}}`.
The kernel and model comparisons run with TF32 off (cuDNN and matmul), so
the plain versions are full fp32; every CLI phase starts from PyTorch's
default flags (cuDNN TF32 on), so that it checks the CLI's own setting.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import itertools
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet) for the roofline bound.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # CUDA cores
BF16_TC_FLOPS = 989e12  # dense bf16 tensor cores
TF32_TC_FLOPS = 495e12  # dense tf32 tensor cores; the fp32 route makes three passes (3xTF32)

F_FRAMES = 256
SEED = 0

# Tolerances, each with its reason.
K1_FP32_MAX_ABS = 1e-5  # the same function in fp32 FMAs against separately rounded operations
K2_FP32_RTOL, K2_FP32_ATOL = 2e-4, 2e-5  # the JAX fused-stage test's (tests/test_amp_fused.py:66)
GEN_FP32_REL_L2 = 1e-4  # 90 kernel convs and 5 cuDNN convs deep, fp32 throughout
BF16_REL_L2 = 2e-2  # K1 in bf16: bf16 inputs/outputs (8 mantissa bits) against the same rounded inputs
# bf16 K2 against the plain stage that rounds the same conv inputs to bf16: what is
# left is the order of fp32 sums and rare bf16 rounding flips.
K2_BF16_REL_L2 = 1e-3
# The bf16 generator: each bf16 rounding of a conv input turns a last-bit difference in an fp32
# sum into a whole bf16 step, and the next conv spreads it; through 90 convs two plain versions
# that differ only in the order of fp32 sums (cuDNN against PyTorch's own conv) already disagree
# by ~1e-2.  So the kernel path passes at 5e-3, or within that floor as this run measures it,
# capped at 2e-2.
GEN_BF16_REL_L2, GEN_BF16_CAP = 5e-3, 2e-2

GEN_BATCH_REL_L2 = 1e-5  # a padded batch against per-item runs, fp32: the same kernels, other sum orders in cuDNN
# Training.  K1's VJP takes sin(2 a v) from the sine polynomial, autograd through the plain version the
# derivative of the sin^2 polynomial: ~1e-7 apart; the parameter gradients are sums over B * T.
K1_GRAD_DX_REL_L2, K1_GRAD_PARAM_REL_L2 = 1e-5, 1e-4
# A step with K1 (fp32 FMAs, ~1e-6 from the plain version) against the plain step.
STEP_LOSS_REL, STEP_NORM_REL, STEP_GRAD_REL_L2 = 1e-5, 1e-4, 1e-3
# The plain step's autograd keeps every intermediate of the plain aa-snake (~25 tensors of 2T samples
# an activation): ~30 GB at b2, so the step checks run at b2; the CLI and the timing run the preset's b16.
TRAIN_CHECK_BATCH = 2
K1_PER_BIGVGAN_FORWARD = 91  # 5 stages x 3 blocks x 3 dilations x 2, and activation_post
K2_PER_BIGVGAN_FORWARD, STAGES_PER_BIGVGAN = 90, 5  # 18 convs a stage
WAV_TOL = 2.0 / 32768  # a WAV of the batched CLI against the per-file run's: two 16-bit steps

# Names of K2's two routes (both csrc/amp_conv_mma.cu) in the kernels line and the launch counts.
FP32_K2, BF16_K2 = "amp_conv_mma_3xtf32", "amp_conv_mma"
K1_TILE = 3968  # csrc/aa_snake.cu: kThreads * kRun outputs a block
CLI_TIMED_FILES = 16  # WAVs of 0.5-3 s in the CLI timings of phases 7 and 9
HALO = 12  # the aa-snake's reach in x at the 1x rate, both sides together
# (C, T, B) of the K1 autograd checks: BigVGAN's widths up to the 512 of a wide config, T at K1's tile
# edges, under the halo and at the 65,536 samples of a training crop.
K1_AUTOGRAD_SHAPES = list(itertools.product((16, 256, 512), (K1_TILE - 1, K1_TILE + 1, HALO - 5, 65536), (1, 4)))
K1_BWD_TILE = 1274  # csrc/aa_snake_bwd.cu: kThreads * kRun - 6 outputs a block
# (C, T, B) of the backward kernel's checks against the plain VJP: as above, T also 1 and 2 and at the backward
# kernel's own tile edges.
K1_BWD_SHAPES = list(itertools.product((16, 256, 512), (1, 2, HALO - 5, K1_BWD_TILE - 1, K1_BWD_TILE + 1, 65536),
                                       (1, 4)))
# The backward kernel against ``aa_snake_plain_vjp`` on the same inputs.  fp32: the same function in FMAs and
# other sum orders (dx ~1e-7 apart; the parameter gradients are sums over B * 2T).  bf16: both compute in fp32
# and round once, so they part only where the two fp32 values straddle a bf16 rounding: dx in a few elements,
# each parameter gradient by at most one bf16 step (2^-7 of it).
K1_BWD_FP32_DX, K1_BWD_FP32_PARAM = 1e-5, 1e-4
K1_BWD_BF16_DX, K1_BWD_BF16_PARAM = 2e-3, 1e-2


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def stage_shapes(cfg, frames: int = F_FRAMES):
    """(C, T) of each AMP stage at `frames` frames."""
    t, out = frames, []
    for i, u in enumerate(cfg.upsample_rates):
        t *= u
        out.append((cfg.upsample_initial_channel // 2 ** (i + 1), t))
    return out


def k1_cost(b, c, t, itemsize):
    """(compute s, memory s) of K1 on (b, c, t): its FMA form's operations, x read and z written once."""
    from vocoder_tpu_torch.ops.aa_snake import FLOPS_PER_SAMPLE

    flops = FLOPS_PER_SAMPLE * b * c * t
    nbytes = 2 * b * c * t * itemsize + 2 * c * itemsize
    return flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S


def k2_flops(blocks, b, c, t):
    """(conv, aa-snake) operations of one AMP stage: 2 C^2 K per sample and conv,
    EXACT_FLOPS_PER_SAMPLE (the prologue's order) per input element and conv."""
    from vocoder_tpu_torch.ops.aa_snake import EXACT_FLOPS_PER_SAMPLE

    n_convs = sum(2 * len(blk.dilations) for blk in blocks)
    conv_flops = sum(2 * len(blk.dilations) * 2 * c * c * blk.kernel_size for blk in blocks) * b * t
    return conv_flops, n_convs * EXACT_FLOPS_PER_SAMPLE * b * c * t


def k2_cost(blocks, b, c, t, itemsize):
    """(compute s, memory s, CUDA-core compute s) of one AMP stage.  The convs
    run on the tensor cores, one bf16 pass or three tf32 passes (3xTF32, for
    fp32), and the aa-snake prologues on the CUDA cores at once, so compute is
    the larger of the two times.  The CUDA-core figure puts both on the CUDA
    cores, as a plain fp32-FMA kernel runs them.  x read once, the weights read
    once, the output written once."""
    conv_flops, snake_flops = k2_flops(blocks, b, c, t)
    weights = sum(p.numel() for blk in blocks for p in blk.parameters())
    nbytes = (2 * b * c * t + weights) * itemsize
    tensor = conv_flops / BF16_TC_FLOPS if itemsize == 2 else 3 * conv_flops / TF32_TC_FLOPS
    compute = max(tensor, snake_flops / FP32_FLOPS)
    return compute, nbytes / HBM_BYTES_PER_S, (conv_flops + snake_flops) / FP32_FLOPS


def k2_design_bytes(blocks, b, c, t, x_itemsize):
    """Bytes the per-conv design moves between its launches (ops/amp_block.py's
    order): each launch reads its x, residual and running sum and writes its
    fp32 output, running sum or the stage output once.  174 B per stage element
    for BigVGAN's (3, 7, 11) x (1, 3, 5) with a bf16 x."""
    per, n_k = 0, len(blocks)
    for kb, blk in enumerate(blocks):
        cur, n_d = x_itemsize, len(blk.dilations)
        for i in range(n_d):
            per += cur + 4  # conv1: x -> y
            if i + 1 < n_d:
                per += 4 + cur + 4  # conv2: y, residual -> fp32 stream
                cur = 4
            else:  # conv2: y, residual, running sum -> running sum or the stage output
                per += 4 + cur + (4 if kb else 0) + (x_itemsize if kb + 1 == n_k else 4)
    return per * b * c * t


def library_convs(blocks, a):
    """The stage's convs alone, in cuDNN, on one ready activation (yardstick only)."""
    import torch.nn.functional as F

    from vocoder_tpu_torch.nn import get_padding

    for blk in blocks:
        k = blk.kernel_size
        for c1, c2, d in zip(blk.convs1, blk.convs2, blk.dilations):
            F.conv1d(a, c1.weight, c1.bias, padding=get_padding(k, d), dilation=d)
            F.conv1d(a, c2.weight, c2.bias, padding=get_padding(k))


def time_k2(model, dtype, b: int, gen, stamp: dict) -> dict:
    """CUDA-event times of the five AMP stages of `model` at batch b and F_FRAMES frames, on
    random stage inputs, beside the plain stage, the stage's convs alone in cuDNN (conv_library_ms),
    the bound, the per-conv design's traffic floor and the host time per launch.  Logs one line
    per stage and returns the forward's totals.

    The forward's bound is the sum of the stages' bounds; it is set by operations or bytes as
    the stages bound by each weigh in that sum."""
    import torch

    from vocoder_tpu_torch.ops.amp_block import ROUTES, amp_stage_kernel, amp_stage_plain, launch_shape
    from vocoder_tpu_torch.tools.timing import cuda_ms

    cfg = model.cfg
    n_k = len(cfg.resblock_kernel_sizes)
    itemsize = torch.empty((), dtype=dtype).element_size()
    tot = {"ms": 0.0, "plain_ms": 0.0, "conv_library_ms": 0.0, "design_floor_ms": 0.0, "host_s": 0.0,
           "launches": 0, "operations": 0.0, "bytes": 0.0, "cuda_cores_s": 0.0}
    for i, (c, t) in enumerate(stage_shapes(cfg)):
        blocks = list(model.resblocks[i * n_k : (i + 1) * n_k])
        xs = torch.randn(b, c, t, device="cuda", generator=gen).to(dtype)
        iters = 5 if b == 1 else 2
        ms = cuda_ms(lambda: amp_stage_kernel(blocks, xs, cfg.snake_logscale), iters)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(iters):
            amp_stage_kernel(blocks, xs, cfg.snake_logscale)
        host_s = time.perf_counter() - h0
        torch.cuda.synchronize()
        n_launch = iters * sum(2 * len(blk.dilations) for blk in blocks)
        plain_ms = cuda_ms(lambda: amp_stage_plain(blocks, xs, cfg.snake_logscale), iters)
        act = torch.randn(b, c, t, device="cuda", generator=gen).to(dtype)
        conv_ms = cuda_ms(lambda: library_convs(blocks, act), iters)
        comp_s, mem_s, cores_s = k2_cost(blocks, b, c, t, itemsize)
        conv_flops, snake_flops = k2_flops(blocks, b, c, t)
        floor_ms = 1e3 * k2_design_bytes(blocks, b, c, t, itemsize) / HBM_BYTES_PER_S
        by = "operations" if comp_s >= mem_s else "bytes"
        tile, n_blocks = launch_shape(dtype, c, b, t)
        log({"metric": "k2_stage_ms", "batch": b, "stage": i, "shape": [b, c, t], "dtype": str(dtype)[6:],
             "ms": ms, "plain_ms": plain_ms, "conv_library_ms": conv_ms, "bound_ms": 1e3 * max(comp_s, mem_s),
             "bound_by": by, "bound_ms_cuda_cores": 1e3 * max(cores_s, mem_s), "design_floor_ms": floor_ms,
             "host_us_per_launch": 1e6 * host_s / n_launch, "conv_tflops": conv_flops / (ms * 1e9),
             "snake_gflop": snake_flops / 1e9, "time_tile": tile, "blocks_per_launch": n_blocks, **stamp})
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("conv_library_ms", conv_ms),
                         ("design_floor_ms", floor_ms), ("host_s", host_s), ("launches", n_launch),
                         (by, max(comp_s, mem_s)), ("cuda_cores_s", max(cores_s, mem_s))):
            tot[key] += val
    rec = {"metric": "k2_forward_ms", "batch": b, "frames": F_FRAMES, "dtype": str(dtype)[6:],
           "route": ROUTES[dtype], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
           "conv_library_ms": tot["conv_library_ms"], "library_ms": None,
           "bound_ms": 1e3 * (tot["operations"] + tot["bytes"]),
           "bound_by": "operations" if tot["operations"] >= tot["bytes"] else "bytes",
           "bound_ms_cuda_cores": 1e3 * tot["cuda_cores_s"],
           "design_floor_ms": tot["design_floor_ms"], "host_us_per_launch": 1e6 * tot["host_s"] / tot["launches"],
           **stamp}
    log(rec)
    return rec


def write_inputs(root: Path, task, rng) -> dict[str, int]:
    """Generated WAVs (one at another rate, one long) and one .npy mel; name -> expected samples."""
    import numpy as np

    from vocoder_tpu_torch.data.audio_io import write_wav

    sr, hop = task.sampling_rate, task.hop_length
    expected = {}
    for name, rate, seconds in (("tone.wav", sr, 1.0), ("low_rate.wav", 22050, 0.5), ("long.wav", sr, 9.0)):
        n = int(rate * seconds)
        t = np.arange(n) / rate
        audio = 0.3 * np.sin(2 * np.pi * 220.0 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3.0 * t))
        audio += 0.01 * rng.standard_normal(n)
        write_wav(root / name, audio.astype(np.float32), rate)
        n_out = -(-n * sr // rate) if rate != sr else n
        expected[name] = -(-n_out // hop) * hop
    mel = (rng.standard_normal((task.num_mels, 200)) - 5.0).astype(np.float32)
    np.save(root / "mel.npy", mel)
    expected["mel.wav"] = 200 * hop
    return expected


def dtag(dtype) -> str:
    return "bf16" if "bfloat16" in str(dtype) else "fp32"


def tf32_off() -> None:
    """Both TF32 flags off, for the kernel and model comparisons: the plain versions in full fp32."""
    import torch

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


def tf32_defaults() -> None:
    """PyTorch's default flags (cuDNN convolutions may round to TF32, matmuls may not), before each
    CLI phase: the CLI has to turn TF32 off itself."""
    import torch

    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False


def run_cli(infer, argv: list[str]) -> float:
    """`cli.infer.main(argv)` from PyTorch's default TF32 flags; its seconds.  Fails unless the CLI
    left both flags off."""
    import torch

    tf32_defaults()
    t0 = time.perf_counter()
    infer.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("the inference CLI left TF32 on: its fp32 convs would not be fp32")
    return seconds


def launch_counts() -> dict[str, int]:
    """Each kernel's launches (``ops.launch_counts``), and the AMP stages run block by block (not a kernel)."""
    from vocoder_tpu_torch import ops
    from vocoder_tpu_torch.models.bigvgan import BigVGAN

    return {**ops.launch_counts(), "blockwise_stages": BigVGAN.blockwise_stages}


def drive_path(name: str, fn, need: tuple[str, ...], paths: dict, blockwise: int = 0):
    """Drive one main path with every count set to 0 just before and read just after; record the
    counts under `name` and fail if a kernel in `need` was not launched, or if other than `blockwise`
    AMP stages ran block by block (0 on every preset's inference path: K2 takes every stage)."""
    import torch

    from vocoder_tpu_torch.models.bigvgan import BigVGAN
    from vocoder_tpu_torch.ops.aa_snake import aa_snake
    from vocoder_tpu_torch.ops.amp_block import amp_stage

    aa_snake.launches = aa_snake.bwd_launches = amp_stage.launches = amp_stage.mma_launches = 0
    BigVGAN.blockwise_stages = 0
    out = fn()
    torch.cuda.synchronize()
    paths[name] = launch_counts()
    if any(paths[name][k] <= 0 for k in need):
        raise SystemExit(f"path {name} did not launch every kernel it runs: {paths[name]}")
    if paths[name]["blockwise_stages"] != blockwise:
        raise SystemExit(f"path {name} ran {paths[name]['blockwise_stages']} AMP stages block by block, "
                         f"expected {blockwise}")
    return out


def spread_lengths(t: int, tile: int, rng, n: int = 16) -> list[int]:
    """n item lengths for a padded batch of T-long rows: T, 0, 1, one under the 12-sample halo, the
    first two tile edges +- 1, and random lengths in [1, T]."""
    fixed = [t, 0, 1, HALO - 5, tile - 1, tile + 1, 2 * tile - 1, 2 * tile + 1]
    return [min(v, t) for v in fixed] + sorted(int(v) for v in rng.integers(1, t + 1, n - len(fixed)))


def past_lengths_zero(got, lengths) -> bool:
    return all(not bool(got[i, :, n:].any()) for i, n in enumerate(lengths))


def check_masked_kernels(model, model_bf16, c_post: int, t_post: int, dev, errs_masked: dict) -> None:
    """K1 at activation_post's (16, 16, T) and K2 at every AMP stage at b16, fp32 and bf16, with per-item
    lengths, against the masked plain versions at the unmasked checks' tolerances; 0 past each length.
    Inputs from generators of their own, so the unmasked checks' inputs stay those of earlier runs."""
    import numpy as np
    import torch

    from vocoder_tpu_torch.ops.aa_snake import aa_snake_kernel
    from vocoder_tpu_torch.ops.amp_block import amp_stage_kernel, amp_stage_plain, launch_shape
    from vocoder_tpu_torch.ops.antialias import aa_snake_plain, snake_params

    cfg = model.cfg
    n_k = len(cfg.resblock_kernel_sizes)
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    models = ((torch.float32, model), (torch.bfloat16, model_bf16))
    lengths = spread_lengths(t_post, K1_TILE, rng)
    lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
    x32 = torch.randn(len(lengths), c_post, t_post, device=dev, generator=gen)
    for dtype, m in models:
        p = m.activation_post.activation
        x = x32.to(dtype)
        got = aa_snake_kernel(x, p.alpha, p.beta, True, lens)
        want = aa_snake_plain(x, *snake_params(p.alpha, p.beta, True), lens)
        torch.cuda.synchronize()
        zeros = past_lengths_zero(got, lengths)
        if dtype == torch.float32:
            err = float((got - want).abs().max())
            errs_masked["aa_snake"] = max(errs_masked["aa_snake"], err)
            ok = zeros and err <= K1_FP32_MAX_ABS
            rec = {"max_abs_err": err}
        else:
            err = rel_l2(got.float(), want.float())
            ok = zeros and err <= BF16_REL_L2
            rec = {"rel_l2": err}
        log({"phase": "k1_masked_check", "shape": list(x.shape), "dtype": dtag(dtype), "lengths": lengths,
             **rec, "zeros_past_lengths": zeros, "ok": ok})
        if not ok:
            raise SystemExit(f"K1 with lengths disagrees with its masked plain version ({dtype})")
    for i, (c, t) in enumerate(stage_shapes(cfg)):
        x32 = torch.randn(16, c, t, device=dev, generator=gen)
        for dtype, m in models:
            blocks = list(m.resblocks[i * n_k : (i + 1) * n_k])
            tile, _ = launch_shape(dtype, c, 16, t)
            lengths = spread_lengths(t, tile, rng)
            lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
            x = x32.to(dtype)
            got = amp_stage_kernel(blocks, x, cfg.snake_logscale, lens)
            want = amp_stage_plain(blocks, x, cfg.snake_logscale, lens)
            torch.cuda.synchronize()
            zeros = past_lengths_zero(got, lengths)
            name = FP32_K2 if dtype == torch.float32 else BF16_K2
            abs_err = float((got.float() - want.float()).abs().max())
            errs_masked[name] = max(errs_masked[name], abs_err)
            if dtype == torch.float32:
                ok = zeros and bool(torch.allclose(got, want, rtol=K2_FP32_RTOL, atol=K2_FP32_ATOL))
                rec = {"max_abs_err": abs_err}
            else:
                err = rel_l2(got.float(), want.float())
                ok = zeros and err <= K2_BF16_REL_L2
                rec = {"rel_l2": err, "max_abs_err": abs_err}
            log({"phase": "k2_masked_check", "stage": i, "shape": [16, c, t], "dtype": dtag(dtype),
                 "time_tile": tile, "lengths": lengths, **rec, "zeros_past_lengths": zeros, "ok": ok})
            if not ok:
                raise SystemExit(f"K2 with lengths disagrees with its masked plain stage at stage {i} {dtype}")


def padded_mels(num_mels: int, frames: list[int], rng, dev):
    """One mel per length, log-mel-like, and their right-zero-padded batch with its lengths."""
    import numpy as np
    import torch

    mels = [torch.from_numpy((rng.standard_normal((1, num_mels, n)) - 5.0).astype(np.float32)).to(dev)
            for n in frames]
    batch = torch.zeros(len(frames), num_mels, max(frames), device=dev)
    for i, m in enumerate(mels):
        batch[i, :, : m.shape[-1]] = m[0]
    return mels, batch, torch.tensor(frames, device=dev, dtype=torch.int32)


def batch_vs_items(model, mels, batch, lens, frames, hop: int):
    """(rows of the padded batch cut to their items' samples, the items' own forwards, the batch):
    concatenated over the items."""
    import torch

    out = model(batch, lens)
    rows = torch.cat([out[i, 0, : n * hop] for i, n in enumerate(frames)]).float()
    alone = torch.cat([model(m)[0, 0] for m in mels]).float()
    return rows, alone, out


MASKED_FRAMES = [64, 101, 137, 173, 209, 240, 271, 300]


def check_masked_generator(model, model_bf16, hop: int, dev, paths: dict) -> None:
    """BigVGAN.forward(mel, frame_lengths) on 8 mels of different lengths against each mel's own forward:
    fp32 within GEN_BATCH_REL_L2; bf16 within GEN_BF16_REL_L2, or the plain-vs-plain floor (cuDNN
    convs against PyTorch's own, per item) capped at GEN_BF16_CAP, measured only when needed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 3)
    mels, batch, lens = padded_mels(model.cfg.num_mels, MASKED_FRAMES, rng, dev)
    for dtype, m, route in ((torch.float32, model, FP32_K2), (torch.bfloat16, model_bf16, BF16_K2)):
        tag = dtag(dtype)
        drive_path(f"masked_forward_{tag}", lambda: m(batch.to(dtype), lens), ("aa_snake", route), paths)
        rows, alone, out = batch_vs_items(m, [x.to(dtype) for x in mels], batch.to(dtype), lens, MASKED_FRAMES, hop)
        err = rel_l2(rows, alone)
        zeros = past_lengths_zero(out, [n * hop for n in MASKED_FRAMES])
        floor = None
        if dtype == torch.float32:
            limit = GEN_BATCH_REL_L2
        else:
            limit = GEN_BF16_REL_L2
            if err > limit:
                plain = torch.cat([m.forward_plain(x.to(dtype))[0, 0] for x in mels]).float()
                torch.backends.cudnn.enabled = False
                native = torch.cat([m.forward_plain(x.to(dtype))[0, 0] for x in mels]).float()
                torch.backends.cudnn.enabled = True
                floor = rel_l2(native, plain)
                limit = max(limit, min(floor, GEN_BF16_CAP))
        ok = err <= limit and zeros and bool(torch.isfinite(out).all())
        log({"phase": "masked_generator_check", "model": "bigvgan", "dtype": tag, "frames": MASKED_FRAMES,
             "rel_l2_batch_vs_items": err, "plain_vs_plain_rel_l2": floor, "limit": limit,
             "zeros_past_lengths": zeros, "launches": paths[f"masked_forward_{tag}"], "ok": ok})
        if not ok:
            raise SystemExit(f"BigVGAN's padded {tag} batch disagrees with its per-item runs")


def library_models(dev) -> dict:
    """HiFiGAN and Vocos at the 44.1 kHz presets, full width, random weights from numpy seed 0: name ->
    (task, fp32 state_dict, fp32 model on the card)."""
    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models import hifigan, vocos
    from vocoder_tpu_torch.nn import fold_weight_norm

    out = {}
    for name, mod in (("hifigan", hifigan), ("vocos", vocos)):
        task = build_task_config(name, "44100_512_2048")
        sd = mod.random_state_dict(task.generator, SEED)
        model = {"hifigan": hifigan.HiFiGAN, "vocos": vocos.Vocos}[name](task.generator)
        model.load_state_dict(sd)
        out[name] = (task, sd, fold_weight_norm(model).to(dev).eval())
    return out


def check_library_models(models: dict, dev) -> None:
    """HiFiGAN and Vocos on the card: finite outputs, and a padded fp32 batch against per-item runs."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 4)
    for name, (task, _, model) in models.items():
        mels, batch, lens = padded_mels(task.num_mels, MASKED_FRAMES, rng, dev)
        rows, alone, out = batch_vs_items(model, mels, batch, lens, MASKED_FRAMES, task.hop_length)
        err = rel_l2(rows, alone)
        finite = bool(torch.isfinite(rows).all() and torch.isfinite(alone).all())
        ok = finite and err <= GEN_BATCH_REL_L2 and float(alone.abs().max()) > 1e-3
        log({"phase": "masked_generator_check", "model": name, "dtype": "fp32", "frames": MASKED_FRAMES,
             "rel_l2_batch_vs_items": err, "limit": GEN_BATCH_REL_L2, "finite": finite,
             "peak": float(alone.abs().max()), "rms": float(alone.pow(2).mean().sqrt()), "ok": ok})
        if not ok:
            raise SystemExit(f"{name}: non-finite output, or its padded batch disagrees with its per-item runs")


def write_batch_inputs(root: Path, task, rng) -> None:
    """WAVs of different lengths (one stereo, one at 22.05 kHz, one past --chunk-frames) and one .npy mel."""
    import numpy as np

    from vocoder_tpu_torch.data.audio_io import write_wav

    sr = task.sampling_rate
    for name, rate, seconds, ch in (("a.wav", sr, 0.25, 1), ("b.wav", sr, 0.6, 1), ("c.wav", sr, 0.93, 1),
                                    ("d.wav", sr, 1.4, 1), ("e.wav", sr, 2.1, 1), ("stereo.wav", sr, 0.7, 2),
                                    ("low_rate.wav", 22050, 0.5, 1), ("long.wav", sr, 9.0, 1)):
        n = int(rate * seconds)
        t = np.arange(n) / rate
        audio = 0.3 * np.sin(2 * np.pi * 220.0 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3.0 * t))
        audio = audio[None] + 0.01 * rng.standard_normal((ch, n))
        write_wav(root / name, audio.astype(np.float32), rate)
    np.save(root / "mel.npy", (rng.standard_normal((task.num_mels, 150)) - 5.0).astype(np.float32))


def check_batched_cli(infer, root: Path, ckpts: dict, paths: dict) -> None:
    """`--batch 4` against `--batch 1` for each model over the same inputs; each WAV within WAV_TOL.
    The bigvgan batched run is a main path: the kernels' counts > 0."""
    import numpy as np

    from vocoder_tpu_torch.data.audio_io import read_wav

    for name, ckpt in ckpts.items():
        wavs, seconds = {}, {}
        for batch in (4, 1):
            out = root / f"out_{name}_b{batch}"
            argv = ["--model", name, "--resolution", "44100_512_2048", "--ckpt", str(ckpt), "--input",
                    str(root / "batch_in"), "--output", str(out), "--chunk-frames", "512", "--batch", str(batch)]
            if name == "bigvgan" and batch == 4:
                seconds[batch] = drive_path("cli_bigvgan_batch4", lambda: run_cli(infer, argv),
                                            ("aa_snake", FP32_K2), paths)
            else:
                seconds[batch] = run_cli(infer, argv)
            wavs[batch] = {p.name: read_wav(p)[0] for p in sorted(out.iterdir())}
        names = sorted(wavs[1])
        errs = {f: float(np.abs(wavs[4][f] - wavs[1][f]).max()) if wavs[4][f].shape == wavs[1][f].shape
                else float("inf") for f in names if f in wavs[4]}
        ok = (sorted(wavs[4]) == names and len(names) == 9 and max(errs.values()) <= WAV_TOL
              and all(np.isfinite(w).all() and np.abs(w).max() > 1e-3 for w in wavs[4].values()))
        log({"phase": "cli_batch_check", "model": name, "files": names, "max_abs_vs_batch1": errs,
             "seconds": {f"batch{b}": s for b, s in seconds.items()},
             "launches": paths.get("cli_bigvgan_batch4") if name == "bigvgan" else None, "ok": ok})
        if not ok:
            raise SystemExit(f"{name}: the batched CLI's WAVs differ from the per-file run's")


def time_masked_generator(model, model_bf16, task, dev, stamp: dict) -> None:
    """BigVGAN at b16, F_FRAMES frames: the forward with frame_lengths (lengths spread over
    F_FRAMES / 4 ... F_FRAMES) against the unmasked forward at the same padded shape."""
    import numpy as np
    import torch

    from vocoder_tpu_torch.tools.timing import cuda_ms

    rng = np.random.default_rng(SEED + 5)
    frames = [F_FRAMES] + sorted(int(v) for v in rng.integers(F_FRAMES // 4, F_FRAMES + 1, 15))
    mel = torch.from_numpy((rng.standard_normal((16, task.num_mels, F_FRAMES)) - 5.0).astype(np.float32)).to(dev)
    for i, n in enumerate(frames):
        mel[i, :, n:] = 0.0
    lens = torch.tensor(frames, device=dev, dtype=torch.int32)
    for dtype, m in ((torch.bfloat16, model_bf16), (torch.float32, model)):
        mel_d = mel.to(dtype)
        unmasked = cuda_ms(lambda: m(mel_d), 2, warmup=1)
        masked = cuda_ms(lambda: m(mel_d, lens), 2, warmup=1)
        log({"metric": "masked_generator_ms", "model": "bigvgan", "batch": 16, "frames": F_FRAMES,
             "dtype": dtag(dtype), "lengths": frames, "filled": sum(frames) / (16 * F_FRAMES),
             "ms": masked, "unmasked_ms": unmasked, "masked_over_unmasked": masked / unmasked,
             "audio_s_per_s": sum(frames) * task.hop_length / task.sampling_rate / (masked / 1e3), **stamp})


def time_library_models(models: dict, dev, stamp: dict) -> dict:
    """HiFiGAN's and Vocos' forward ms and audio-s/s at b1 and b16, F_FRAMES frames, bf16 and fp32, as
    the host queues the calls (at b1 the host sets the pace: tools/profile_forward.py gives the card's
    busy time)."""
    import torch

    from vocoder_tpu_torch.tools.timing import cuda_ms

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    out = {}
    for name, (task, _, model) in models.items():
        m_bf16 = copy.deepcopy(model).to(torch.bfloat16)
        for b in (1, 16):
            mel = torch.randn(b, task.num_mels, F_FRAMES, device=dev, generator=gen) - 5.0
            for dtype, m in ((torch.bfloat16, m_bf16), (torch.float32, model)):
                mel_d = mel.to(dtype)
                y = m(mel_d)
                ms = cuda_ms(lambda: m(mel_d), 5 if b == 1 else 2, warmup=2)
                audio_s = b * F_FRAMES * task.hop_length / task.sampling_rate
                rec = {"metric": "generator_ms", "model": name, "batch": b, "frames": F_FRAMES,
                       "dtype": dtag(dtype), "ms": ms, "audio_s_per_s": audio_s / (ms / 1e3),
                       "finite": bool(torch.isfinite(y).all()), **stamp}
                log(rec)
                if not rec["finite"]:
                    raise SystemExit(f"{name} {dtype}: non-finite output")
                out[(name, b, rec["dtype"])] = rec
    return out


def time_cli(infer, root: Path, ckpt: Path, task, rng, stamp: dict) -> None:
    """The CLI's seconds over the same CLI_TIMED_FILES WAVs (0.5 ... 3 s) at --batch 1 and --batch 16, BigVGAN
    fp32."""
    import numpy as np

    from vocoder_tpu_torch.data.audio_io import write_wav

    src = root / "cli_timed"
    src.mkdir()
    audio_s = 0.0
    for i, seconds in enumerate(rng.uniform(0.5, 3.0, CLI_TIMED_FILES)):
        n = int(task.sampling_rate * seconds)
        t = np.arange(n) / task.sampling_rate
        audio = 0.3 * np.sin(2 * np.pi * (110.0 + 10 * i) * t) + 0.01 * rng.standard_normal(n)
        write_wav(src / f"{i:02d}.wav", audio[None].astype(np.float32), task.sampling_rate)
        audio_s += -(-n // task.hop_length) * task.hop_length / task.sampling_rate
    for batch in (1, 16):
        argv = ["--model", "bigvgan", "--resolution", "44100_512_2048", "--ckpt", str(ckpt), "--input", str(src),
                "--output", str(root / f"cli_timed_b{batch}"), "--batch", str(batch)]
        seconds = run_cli(infer, argv)
        log({"metric": "cli_seconds", "model": "bigvgan", "dtype": "fp32", "batch": batch, "files": CLI_TIMED_FILES,
             "audio_s": audio_s, "seconds": seconds, "audio_s_per_s": audio_s / seconds, **stamp})


def rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def check_k1_autograd(dev) -> dict:
    """K1 under autograd (the kernel forward, the backward kernel) against autograd through the plain
    version, from the same upstream gradient; the worst of each of dx, d alpha, d beta and the forward."""
    import numpy as np
    import torch

    from vocoder_tpu_torch.ops.aa_snake import aa_snake
    from vocoder_tpu_torch.ops.antialias import aa_snake_plain, snake_params

    rng = np.random.default_rng(SEED + 8)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    worst = {"dx_rel_l2": 0.0, "d_alpha_rel_l2": 0.0, "d_beta_rel_l2": 0.0, "forward_max_abs": 0.0}
    for c, t, b in K1_AUTOGRAD_SHAPES:
        alpha = torch.tensor(0.3 * rng.standard_normal(c), dtype=torch.float32, device=dev, requires_grad=True)
        beta = torch.tensor(0.3 * rng.standard_normal(c), dtype=torch.float32, device=dev, requires_grad=True)
        x = torch.randn(b, c, t, device=dev, generator=gen).requires_grad_(True)
        gz = torch.randn(b, c, t, device=dev, generator=gen)
        z = aa_snake(x, alpha, beta, True)
        before = aa_snake.bwd_launches
        got = torch.autograd.grad(z, (x, alpha, beta), gz)
        bwd_launched = aa_snake.bwd_launches - before
        z_plain = aa_snake_plain(x, *snake_params(alpha, beta, True))
        want = torch.autograd.grad(z_plain, (x, alpha, beta), gz)
        rec = {"dx_rel_l2": rel_l2(got[0], want[0]), "d_alpha_rel_l2": rel_l2(got[1], want[1]),
               "d_beta_rel_l2": rel_l2(got[2], want[2]), "forward_max_abs": float((z - z_plain).detach().abs().max())}
        ok = (rec["dx_rel_l2"] <= K1_GRAD_DX_REL_L2 and rec["d_alpha_rel_l2"] <= K1_GRAD_PARAM_REL_L2
              and rec["d_beta_rel_l2"] <= K1_GRAD_PARAM_REL_L2 and rec["forward_max_abs"] <= K1_FP32_MAX_ABS
              and bwd_launched == 1 and all(bool(torch.isfinite(g).all()) for g in got))
        log({"phase": "k1_autograd_check", "shape": [b, c, t], **rec, "ok": ok})
        if not ok:
            raise SystemExit(f"K1 under autograd disagrees with autograd through its plain version at {(b, c, t)}")
        worst = {k: max(worst[k], rec[k]) for k in worst}
        del x, z, z_plain, got, want, gz
    log({"phase": "k1_autograd_worst", **worst,
         "limits": {"dx_rel_l2": K1_GRAD_DX_REL_L2, "d_param_rel_l2": K1_GRAD_PARAM_REL_L2}})
    return worst


def check_k1_bwd(dev, dtype) -> dict:
    """10 (fp32) and 24 (bf16): the backward kernel (``aa_snake_bwd_kernel``) against ``aa_snake_plain_vjp`` on
    the same inputs at K1_BWD_SHAPES, with the upstream gradient contiguous and as a channel shard's view (the
    second half of a 2C-channel tensor, as tensor parallelism hands it): dx, d alpha and d beta within the
    dtype's limits, each call one count of ``aa_snake.bwd_launches``; the worst of each."""
    import torch

    from vocoder_tpu_torch.ops.aa_snake import aa_snake, aa_snake_bwd_kernel
    from vocoder_tpu_torch.ops.antialias import aa_snake_plain_vjp

    fp32 = dtype == torch.float32
    lim_dx, lim_param = (K1_BWD_FP32_DX, K1_BWD_FP32_PARAM) if fp32 else (K1_BWD_BF16_DX, K1_BWD_BF16_PARAM)
    gen = torch.Generator(device=dev).manual_seed(SEED + (10 if fp32 else 24))
    worst = {"dx": 0.0, "d_alpha": 0.0, "d_beta": 0.0}
    for (c, t, b), shard in itertools.product(K1_BWD_SHAPES, (False, True)):
        params = [torch.exp(0.3 * torch.randn(c, device=dev, generator=gen)).to(dtype) for _ in range(2)]
        wide = 2 * c if shard else c
        x = torch.randn(b, wide, t, device=dev, generator=gen).to(dtype)[:, wide - c :].contiguous()
        gz = torch.randn(b, wide, t, device=dev, generator=gen).to(dtype)[:, wide - c :]
        before = aa_snake.bwd_launches
        got = aa_snake_bwd_kernel(x, *params, gz)
        launched = aa_snake.bwd_launches - before
        want = aa_snake_plain_vjp(x, *params, gz)
        rec = {name: rel_l2(g, w) for name, g, w in zip(worst, got, want)}
        ok = (launched == 1 and rec["dx"] <= lim_dx and max(rec["d_alpha"], rec["d_beta"]) <= lim_param
              and all(g.dtype == w.dtype and bool(torch.isfinite(g).all()) for g, w in zip(got, want)))
        log({"phase": "k1_bwd_check", "dtype": dtag(dtype), "shape": [b, c, t], "gz_shard_view": shard, **rec,
             "ok": ok})
        if not ok:
            raise SystemExit(f"the backward kernel disagrees with the plain VJP at {(b, c, t)}, {dtag(dtype)}")
        worst = {k: max(worst[k], rec[k]) for k in worst}
        del x, gz, got, want
    log({"phase": "k1_bwd_worst", "dtype": dtag(dtype), **worst, "limits": {"dx": lim_dx, "d_param": lim_param}})
    return worst


def time_k1_bwd(dev, stamp: dict) -> dict:
    """The backward kernel's card time (``device_time``) at the five AMP stage shapes of the 44.1 kHz preset's
    training step (b16 x 128 frames), fp32 and bf16, beside its bound (the larger of BWD_FLOPS_PER_SAMPLE on the
    CUDA cores and x, gz read and dx written once) and the plain VJP's time; and a step's 91 calls (18 a stage,
    activation_post at the last stage's shape) summed from them."""
    import torch

    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.ops.aa_snake import BWD_FLOPS_PER_SAMPLE, aa_snake_bwd_kernel
    from vocoder_tpu_torch.ops.antialias import aa_snake_plain_vjp
    from vocoder_tpu_torch.tools.timing import cuda_ms, device_time

    task = build_task_config("bigvgan", "44100_512_2048")
    shapes = stage_shapes(task.generator, task.num_frames)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        rows, step = [], {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0}
        for i, (c, t) in enumerate(shapes):
            params = [torch.exp(0.3 * torch.randn(c, device=dev, generator=gen)).to(dtype) for _ in range(2)]
            x = torch.randn(16, c, t, device=dev, generator=gen).to(dtype)
            gz = torch.randn(16, c, t, device=dev, generator=gen).to(dtype)
            ms, host_us = device_time(lambda: aa_snake_bwd_kernel(x, *params, gz), 20)
            plain_ms = cuda_ms(lambda: aa_snake_plain_vjp(x, *params, gz), 3, 1)
            n = x.numel()
            compute_s, memory_s = BWD_FLOPS_PER_SAMPLE * n / FP32_FLOPS, 3 * n * x.element_size() / HBM_BYTES_PER_S
            bound_ms = 1e3 * max(compute_s, memory_s)
            rows.append({"stage": i, "shape": [16, c, t], "ms": ms, "bound_ms": bound_ms,
                         "bound_by": "operations" if compute_s > memory_s else "bytes",
                         "share_of_bound": bound_ms / ms, "plain_ms": plain_ms, "host_us_per_call": host_us})
            calls = 18 + (i == len(shapes) - 1)
            for key, v in (("ms", ms), ("bound_ms", bound_ms), ("plain_ms", plain_ms)):
                step[key] += calls * v
            del x, gz
        out[dtag(dtype)] = {"stages": rows, "step_91_calls": step}
        log({"phase": "k1_bwd_timing", "dtype": dtag(dtype), "stages": rows, "step_91_calls": step, **stamp})
    torch.cuda.empty_cache()
    return out


def check_eval_after_step(state, task, batch: dict, fake_before) -> None:
    """Validation (K2 stages, eval mode) on the weights a training step has just updated in place
    (AdamW on the weight-norm parameters), against the plain forward on the same weights: K2's packed
    weights, built before the step, must follow the update.  The step must have moved the fake by
    more than 10 times that distance, so that a stale pack would show."""
    import torch

    from vocoder_tpu_torch.ops.amp_block import amp_stage
    from vocoder_tpu_torch.train import gan

    launches = amp_stage.launches
    metrics, fake = gan.make_eval_step(task)(state, batch)
    launched = amp_stage.launches - launches
    with torch.no_grad():
        mask = gan.sequence_mask(batch["lengths"], batch["audio"].shape[2])
        want = gan.generator_forward(state.generator, batch["audio"], task, plain=True)[0] * mask
    err, moved = rel_l2(fake, want), rel_l2(fake, fake_before)
    val_mel = float(metrics["val/metrics/mel"])
    ok = launched > 0 and err <= GEN_FP32_REL_L2 and moved > 10 * err and math.isfinite(val_mel)
    log({"phase": "eval_after_train_step", "model": "bigvgan", "batch": TRAIN_CHECK_BATCH, "k2_launches": launched,
         "rel_l2_vs_plain": err, "limit": GEN_FP32_REL_L2, "rel_l2_moved_by_step": moved,
         "val_mel": val_mel, "ok": ok})
    if not ok:
        raise SystemExit("validation after a training step disagrees with the plain forward on the updated weights")


def check_train_steps(dev, paths: dict) -> int:
    """One training step of BigVGAN, HiFiGAN and BigVGAN with an f0 template (its batch carrying each
    sine's template) at the 44.1 kHz presets, b2 x 65,536 samples: the kernel path (BigVGAN: K1 under
    autograd) against the plain path from the same weights (numpy seed 0), batch (one item shorter, so the
    mask counts) and crop start.  K1's launches in the BigVGAN steps.  BigVGAN's validation runs before
    and after its kernel-path step (``check_eval_after_step``)."""
    import dataclasses

    import torch

    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models import bigvgan, hifigan
    from vocoder_tpu_torch.tools.profile_train import synthetic_batch
    from vocoder_tpu_torch.train import gan

    k1_step = 0
    for name, weights in (("bigvgan", bigvgan.random_state_dict), ("hifigan", hifigan.random_state_dict),
                          ("bigvgan_template", bigvgan.random_state_dict)):
        family = name.split("_")[0]
        task = build_task_config(family, "44100_512_2048")
        if name == "bigvgan_template":
            task = task.replace(generator=dataclasses.replace(task.generator, use_template=True))
        t = task.hop_length * task.num_frames
        batch = synthetic_batch(TRAIN_CHECK_BATCH, t, task.sampling_rate, SEED, dev,
                                task.hop_length if gan.needs_template(task) else None)
        batch["lengths"][1] = t * 4 // 5
        batch["audio"][1, :, t * 4 // 5 :] = 0.0
        runs = {}
        for plain in (False, True):
            state = gan.create_train_state(task, SEED, dev)
            state.generator.load_state_dict(weights(task.generator, SEED))
            start = gan.draw_crop_start(state, task, t)
            step = gan.make_train_step(task, plain=plain)
            if plain:
                metrics = step(state, batch, start)
            else:
                need = ("aa_snake",) if family == "bigvgan" else ()
                blockwise = len(task.generator.upsample_rates) if family == "bigvgan" else 0
                if name == "bigvgan":
                    _, fake_before = gan.make_eval_step(task)(state, batch)  # builds K2's packed weights
                metrics = drive_path(f"train_step_{name}", lambda: step(state, batch, start), need, paths, blockwise)
            grads = {n: p.grad.detach().clone() for n, p in state.generator.named_parameters()}
            runs[plain] = ({k: float(v) for k, v in metrics.items()}, grads)
            if name == "bigvgan" and not plain:
                check_eval_after_step(state, task, batch, fake_before)
                del fake_before
            del state
        (mk, gk), (mp, gp) = runs[False], runs[True]
        norms = [k for k in mk if "grad_norm" in k]
        losses = [k for k in mk if k not in norms and k != "lr"]
        loss_rel = {k: rel(mk[k], mp[k]) for k in losses}
        norm_rel = {k: rel(mk[k], mp[k]) for k in norms}
        grad_rel = {n: rel_l2(gk[n], gp[n]) for n in gk}
        worst_grad = max(grad_rel, key=grad_rel.get)
        launches = paths[f"train_step_{name}"]
        ok = (max(loss_rel.values()) <= STEP_LOSS_REL and max(norm_rel.values()) <= STEP_NORM_REL
              and grad_rel[worst_grad] <= STEP_GRAD_REL_L2
              and all(map(math.isfinite, list(mk.values()) + list(mp.values()))))
        if family == "bigvgan":
            ok = (ok and launches["aa_snake"] == K1_PER_BIGVGAN_FORWARD
                  and launches["aa_snake_bwd"] == K1_PER_BIGVGAN_FORWARD)
        if name == "bigvgan":
            k1_step = launches["aa_snake"]
        log({"phase": "train_step_check", "model": name, "batch": TRAIN_CHECK_BATCH, "samples": t,
             "crop_start": start, "metrics_kernel": mk, "metrics_plain": mp, "loss_rel": loss_rel,
             "grad_norm_rel": norm_rel, "max_grad_rel_l2": grad_rel[worst_grad], "worst_grad": worst_grad,
             "grad_tensors": len(grad_rel), "launches": launches,
             "limits": {"loss_rel": STEP_LOSS_REL, "grad_norm_rel": STEP_NORM_REL, "grad_rel_l2": STEP_GRAD_REL_L2},
             "ok": ok})
        if not ok:
            raise SystemExit(f"{name}: the training step with the kernels disagrees with the plain step")
        torch.cuda.empty_cache()
    return k1_step


def write_train_corpus(root: Path, sr: int, rng) -> None:
    """32 training WAVs of 1-4 s and 2 validation WAVs: sines with a vibrato, plus noise."""
    import numpy as np

    from vocoder_tpu_torch.data.audio_io import write_wav

    for sub, n in (("train", 32), ("val", 2)):
        (root / sub).mkdir(parents=True)
        for i, seconds in enumerate(rng.uniform(1.0, 4.0, n)):
            t = np.arange(int(sr * seconds)) / sr
            f0 = rng.uniform(100.0, 400.0)
            audio = 0.3 * np.sin(2 * np.pi * f0 * t + 2.0 * np.sin(2 * np.pi * 5.0 * t))
            write_wav(root / sub / f"{i:02d}.wav", (audio + 0.01 * rng.standard_normal(t.size)).astype(np.float32), sr)


def run_train_cli(argv: list[str]) -> tuple[object, str]:
    """`cli.train.main(argv)` with its log captured (and echoed): (final state, log)."""
    import contextlib
    import io

    from vocoder_tpu_torch.cli import train as train_cli

    buf = io.StringIO()
    try:
        with contextlib.redirect_stderr(buf):
            state = train_cli.main(argv)
    finally:
        print(buf.getvalue(), end="", flush=True)
    return state, buf.getvalue()


def check_cli_train(root: Path, infer, paths: dict) -> dict:
    """cli.train at the BigVGAN preset's batch 16 x 128 frames: 3 steps with a validation at 2 and a
    checkpoint every 2 (and at the end), then a resume to 4, then cli.infer from the run's workdir.  The
    first run's arguments but the workdir and its metrics.jsonl records (phase 36 runs them again under
    torchrun)."""
    import numpy as np
    import torch

    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.data.audio_io import read_wav

    task = build_task_config("bigvgan", "44100_512_2048")
    write_train_corpus(root, task.sampling_rate, np.random.default_rng(SEED + 9))
    work = root / "run"
    args = ["--model", "bigvgan", "--device", "cuda", f"data.train_roots=('{root / 'train'}',)",
            f"data.val_root={root / 'val'}", "run.log_interval=1", "run.val_interval=2", "run.ckpt_interval=2",
            "run.val_pesq=False"]
    base = [*args, f"run.workdir={work}"]
    steps = 3
    tf32_defaults()
    state, _ = drive_path("cli_train_bigvgan", lambda: run_train_cli([*base, f"run.max_steps={steps}"]),
                          ("aa_snake", FP32_K2), paths, blockwise=steps * len(task.generator.upsample_rates))
    counts = paths["cli_train_bigvgan"]
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    train_recs = [r for r in records if "train/generator/all" in r]
    val_recs = [r for r in records if "val/metrics/mel" in r]
    finite = all(math.isfinite(v) for r in records for v in r.values())
    ckpts = sorted(p.name for p in (work / "checkpoints").iterdir())
    ok = (state.step == steps and finite and [r["step"] for r in train_recs] == [2, 3]
          and [r["step"] for r in val_recs] == [2] and {"2.pt", "3.pt"} <= set(ckpts)
          and counts["aa_snake"] >= K1_PER_BIGVGAN_FORWARD * steps and counts[FP32_K2] > 0
          and not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32))
    log({"phase": "cli_train", "model": "bigvgan", "batch": 16, "frames": 128, "steps": steps,
         "launches": counts, "k1_launches_per_step": counts["aa_snake"] / steps, "checkpoints": ckpts,
         "train_records": train_recs, "val_records": val_recs, "finite": finite, "ok": ok})
    if not ok:
        raise SystemExit("cli.train: the run did not train, validate and checkpoint as asked")

    tf32_defaults()
    state, text = drive_path("cli_train_resume", lambda: run_train_cli([*base, "run.max_steps=4"]),
                             ("aa_snake",), paths, blockwise=len(task.generator.upsample_rates))
    ok = state.step == 4 and "auto-resumed from step 3" in text and (work / "checkpoints" / "4.pt").is_file()
    log({"phase": "cli_train_resume", "step": state.step, "launches": paths["cli_train_resume"], "ok": ok})
    if not ok:
        raise SystemExit("cli.train did not resume from step 3 and end at step 4")

    wav = root / "val" / "00.wav"
    n = read_wav(wav)[0].shape[-1]
    argv = ["--model", "bigvgan", "--ckpt", str(work), "--input", str(wav), "--output", str(root / "synth")]
    run_cli(infer, argv)
    tf32_off()
    audio, sr = read_wav(root / "synth" / "00.wav")
    want = -(-n // task.hop_length) * task.hop_length
    ok = sr == task.sampling_rate and audio.shape == (1, want) and bool(np.isfinite(audio).all())
    log({"phase": "cli_infer_from_training", "samples": audio.shape[-1], "expected": want,
         "peak": float(np.abs(audio).max()), "ok": ok})
    if not ok:
        raise SystemExit("cli.infer did not synthesise from the trained checkpoint")
    return {"argv": [*args, f"run.max_steps={steps}"], "records": records}


def time_train_step(dev, stamp: dict) -> dict:
    """The BigVGAN preset's training step at b16 x 65,536 samples, fp32, TF32 off: ms by phase, rate,
    peak memory and card-time shares (tools/profile_train.py)."""
    import torch

    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models.bigvgan import random_state_dict
    from vocoder_tpu_torch.tools.profile_train import measure_step, synthetic_batch
    from vocoder_tpu_torch.train import gan

    tf32_off()
    task = build_task_config("bigvgan", "44100_512_2048")
    state = gan.create_train_state(task, SEED, dev)
    state.generator.load_state_dict(random_state_dict(task.generator, SEED))
    batch = synthetic_batch(16, task.hop_length * task.num_frames, task.sampling_rate, SEED, dev)
    rec = {"metric": "train_step_ms", "model": "bigvgan", "batch": 16, "samples": task.hop_length * task.num_frames,
           "dtype": "fp32", **measure_step(state, gan.make_train_step(task), batch, task, TIMED_STEPS), **stamp}
    log(rec)
    del state
    torch.cuda.empty_cache()
    return rec


def f0_contour_template(frames: int, task, seed: int):
    """(frames,) f0 gliding 140 -> 320 Hz with an unvoiced stretch, and its template (F * hop,)."""
    import numpy as np

    from vocoder_tpu_torch.data.f0 import template_from_f0

    rng = np.random.default_rng(seed)
    f0 = np.linspace(140.0, 320.0, frames) * (1 + 0.02 * rng.standard_normal(frames))
    f0[frames // 3 : frames // 3 + frames // 8] = 0.0
    return template_from_f0(f0, task.sampling_rate, task.hop_length)


def template_bigvgan():
    """The 44.1 kHz BigVGAN preset with use_template=True, random weights from numpy seed 0: (task, fp32
    state_dict, fp32 model on the card, bf16 copy)."""
    import torch

    from vocoder_tpu_torch.tools.profile_forward import build

    task, sd, model = build("bigvgan", torch.float32, template=True, seed=SEED)
    return task, sd, model, copy.deepcopy(model).to(torch.bfloat16)


def check_template_generator(task, model, model_bf16, dev, paths: dict) -> None:
    """BigVGAN with an f0 template through BigVGAN.forward against forward_plain on the same mel and
    template, fp32 and bf16, at the generator limits; K1 and the dtype's K2 route launched, no stage
    block by block; and the template reaches the output (a zero template moves it)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 10)
    frames = 200
    mel32 = torch.from_numpy((rng.standard_normal((2, task.num_mels, frames)) - 5.0).astype(np.float32)).to(dev)
    tpl32 = torch.from_numpy(np.stack([f0_contour_template(frames, task, SEED + 10 + i) for i in range(2)])[:, None])
    tpl32 = tpl32.to(dev)
    for dtype, m, route in ((torch.float32, model, FP32_K2), (torch.bfloat16, model_bf16, BF16_K2)):
        tag = dtag(dtype)
        mel, tpl = mel32.to(dtype), tpl32.to(dtype)
        got = drive_path(f"template_forward_{tag}", lambda: m(mel, template=tpl), ("aa_snake", route), paths)
        want = m.forward_plain(mel, template=tpl)
        err, floor = rel_l2(got.float(), want.float()), None
        limit = GEN_FP32_REL_L2 if dtype == torch.float32 else GEN_BF16_REL_L2
        if dtype == torch.bfloat16 and err > limit:
            torch.backends.cudnn.enabled = False
            native = m.forward_plain(mel, template=tpl)
            torch.backends.cudnn.enabled = True
            floor = rel_l2(native.float(), want.float())
            limit = max(limit, min(floor, GEN_BF16_CAP))
        moved = rel_l2(m(mel, template=torch.zeros_like(tpl)).float(), got.float())
        ok = (err <= limit and bool(torch.isfinite(got).all()) and got.shape == (2, 1, frames * task.hop_length)
              and moved > 1e-3)
        log({"phase": "template_generator_check", "model": "bigvgan", "dtype": tag, "shape": list(got.shape),
             "rel_l2": err, "plain_vs_plain_rel_l2": floor, "limit": limit, "zero_template_moves_rel_l2": moved,
             "launches": paths[f"template_forward_{tag}"], "ok": ok})
        if not ok:
            raise SystemExit(f"BigVGAN with a template: the {tag} kernel path disagrees with its plain path")


def write_template_workdir(work: Path, task, sd: dict) -> None:
    """A training run's workdir as the trainer leaves one: config.json recording the task (use_template
    on) and checkpoints/0.pt holding the generator."""
    import dataclasses

    import torch

    from vocoder_tpu_torch.config import TrainConfig

    (work / "checkpoints").mkdir(parents=True)
    (work / "config.json").write_text(json.dumps(dataclasses.asdict(TrainConfig(task=task)), indent=2, default=str))
    torch.save({"generator": sd}, work / "checkpoints" / "0.pt")


def check_cli_outputs(out_dir: Path, expected: dict, task, phase: str) -> dict:
    """Each expected WAV at the task's rate, of its expected length, finite and not silent; name -> audio."""
    import numpy as np

    from vocoder_tpu_torch.data.audio_io import read_wav

    outs = {}
    for name, n in expected.items():
        audio, sr = read_wav(out_dir / name)
        ok = (sr == task.sampling_rate and audio.shape[-1] == n and bool(np.isfinite(audio).all())
              and float(np.abs(audio).max()) > 1e-3)
        log({"phase": phase, "file": name, "samples": audio.shape[-1], "expected": n,
             "peak": float(np.abs(audio).max()), "ok": ok})
        if not ok:
            raise SystemExit(f"{phase}: {name}: bad output {audio.shape} at {sr} Hz")
        outs[name] = audio
    return outs


def template_wavs(root: Path, task, rng) -> dict[str, int]:
    """Voiced WAVs for a template-consuming CLI run (one at another rate, one stereo); name -> samples."""
    import numpy as np

    from vocoder_tpu_torch.data.audio_io import write_wav

    sr, hop = task.sampling_rate, task.hop_length
    expected = {}
    for name, rate, seconds, ch in (("tone.wav", sr, 1.2, 1), ("low_rate.wav", 22050, 0.6, 1),
                                    ("stereo.wav", sr, 0.8, 2)):
        n = int(rate * seconds)
        t = np.arange(n) / rate
        audio = 0.3 * np.sin(2 * np.pi * (180.0 * t + 40.0 * t * t))[None] + 0.01 * rng.standard_normal((ch, n))
        write_wav(root / name, audio.astype(np.float32), rate)
        expected[name] = -(-(-(-n * sr // rate) if rate != sr else n) // hop) * hop
    return expected


def family_models() -> dict:
    """RefineGAN (24 kHz preset) and Firefly-GAN (44.1 kHz preset) at full width, random weights from numpy
    seed 0: name -> (task, fp32 state_dict, fp32 model on the card)."""
    import torch

    from vocoder_tpu_torch.tools.profile_forward import build

    return {name: build(name, torch.float32, seed=SEED) for name in ("refinegan", "firefly_gan_base")}


def check_family_clis(infer, root: Path, models: dict, paths: dict) -> None:
    """RefineGAN and Firefly-GAN through cli.infer on WAVs: finite output of each file's length; RefineGAN
    twice, equal to the bit (its AdaIN noise comes from the seeded-0 default); Firefly also on a .npy mel
    and a file past --chunk-frames.  Neither runs a kernel of the port: both paths launch 0."""
    import numpy as np
    import torch

    for name, (task, sd, _) in models.items():
        ckpt = root / f"{name}.ckpt"
        torch.save({"state_dict": {f"generator.{k}": v for k, v in sd.items()}}, ckpt)
        rng = np.random.default_rng(SEED + 11)
        (root / f"{name}_in").mkdir()
        if name == "refinegan":
            expected = template_wavs(root / f"{name}_in", task, rng)
        else:
            expected = write_inputs(root / f"{name}_in", task, rng)
        resolution = "24000_256_1024" if name == "refinegan" else "44100_512_2048"
        outs = []
        for run in (1, 2) if name == "refinegan" else (1,):
            argv = ["--model", name, "--resolution", resolution, "--ckpt", str(ckpt), "--input",
                    str(root / f"{name}_in"), "--output", str(root / f"{name}_out{run}"), "--chunk-frames", "512"]
            seconds = drive_path(f"cli_{name}", lambda: run_cli(infer, argv), (), paths)
            log({"phase": "cli", "model": name, "run": run, "seconds": seconds, "launches": paths[f"cli_{name}"]})
            outs.append(check_cli_outputs(root / f"{name}_out{run}", expected, task, f"cli_output_{name}"))
        if name == "refinegan":
            same = all(np.array_equal(outs[0][f], outs[1][f]) for f in expected)
            log({"phase": "refinegan_runs_equal", "files": sorted(expected), "ok": same})
            if not same:
                raise SystemExit("refinegan: two CLI runs on the same input differ")
    tf32_off()


def time_families(models: dict, template_models: tuple, dev, stamp: dict) -> None:
    """Generator ms (CUDA events), audio-s/s and profile_forward's busy share, launches and K2 card ms
    per forward, F_FRAMES frames: BigVGAN with a template at b1 and b16 in bf16 and fp32 (K2's share of
    the forward), RefineGAN and Firefly-GAN at b16 in fp32."""
    import torch

    from vocoder_tpu_torch.tools.profile_forward import inputs, profile

    task, model, model_bf16 = template_models
    runs = [("bigvgan_template", task, m, b, dt) for b in (1, 16)
            for dt, m in ((torch.bfloat16, model_bf16), (torch.float32, model))]
    runs += [(name, t, m, 16, torch.float32) for name, (t, _, m) in models.items()]
    for name, t, m, b, dtype in runs:
        # b1's host-paced ms over 10 forwards; the card's busy ms is read from the same number traced.
        rec = profile(m, inputs(t, b, F_FRAMES, dtype, SEED + 12), iters=10 if b == 1 else 2, top=4)
        audio_s = b * F_FRAMES * t.hop_length / t.sampling_rate
        log({"metric": "generator_ms", "model": name, "batch": b, "frames": F_FRAMES, "dtype": dtag(dtype),
             "ms": rec["ms"], "audio_s_per_s": audio_s / (rec["ms"] / 1e3), "busy_ms": rec["busy_ms"],
             "busy_share": rec["busy_share"], "launches_per_forward": rec["launches_per_forward"],
             "k2_ms": rec["k2_ms"], "k2_share_of_forward": rec["k2_ms"] / rec["ms"], "top": rec["top"], **stamp})


def time_refinegan_cli(infer, root: Path, models: dict, stamp: dict) -> None:
    """The CLI's seconds over CLI_TIMED_FILES WAVs of 0.5-3 s at 24 kHz, refinegan fp32, split into the host's f0
    templates (``infer.templates``), the forwards (``infer.synthesize``, synchronised) and the rest
    (checkpoint, reads, log-mel, writes)."""
    import numpy as np
    import torch

    from vocoder_tpu_torch.data.audio_io import write_wav

    task, sd, _ = models["refinegan"]
    ckpt = root / "refinegan.ckpt"
    torch.save({"state_dict": {f"generator.{k}": v for k, v in sd.items()}}, ckpt)
    rng = np.random.default_rng(SEED + 13)
    src = root / "refinegan_timed"
    src.mkdir()
    audio_s = 0.0
    for i, seconds in enumerate(rng.uniform(0.5, 3.0, CLI_TIMED_FILES)):
        n = int(task.sampling_rate * seconds)
        t = np.arange(n) / task.sampling_rate
        audio = 0.3 * np.sin(2 * np.pi * (110.0 + 10 * i) * t) + 0.01 * rng.standard_normal(n)
        write_wav(src / f"{i:02d}.wav", audio[None].astype(np.float32), task.sampling_rate)
        audio_s += -(-n // task.hop_length) * task.hop_length / task.sampling_rate
    spent = {"f0": 0.0, "forward": 0.0}
    originals = {"f0": infer.templates, "forward": infer.synthesize}

    def timed(key):
        def fn(*a, **kw):
            t0 = time.perf_counter()
            out = originals[key](*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return fn

    infer.templates, infer.synthesize = timed("f0"), timed("forward")
    try:
        seconds = run_cli(infer, ["--model", "refinegan", "--resolution", "24000_256_1024", "--ckpt", str(ckpt),
                                  "--input", str(src), "--output", str(root / "refinegan_timed_out")])
    finally:
        infer.templates, infer.synthesize = originals["f0"], originals["forward"]
    log({"metric": "cli_seconds", "model": "refinegan", "dtype": "fp32", "batch": 1, "files": CLI_TIMED_FILES,
         "audio_s": audio_s,
         "seconds": seconds, "audio_s_per_s": audio_s / seconds, "f0_seconds": spent["f0"],
         "forward_seconds": spent["forward"], "other_seconds": seconds - spent["f0"] - spent["forward"], **stamp})


def check_cli_train_refinegan(root: Path, infer, paths: dict) -> dict:
    """cli.train --model refinegan at the 24 kHz preset's batch 16 x 128 frames on 32 generated WAVs, the
    preset's data workers: 2 steps with a validation at 2, a resume to 3 (its final checkpoint), then
    cli.infer --ckpt <workdir>.  Returns the first run's last log record (input wait included)."""
    import numpy as np

    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.data.audio_io import read_wav

    task = build_task_config("refinegan", "24000_256_1024")
    write_train_corpus(root, task.sampling_rate, np.random.default_rng(SEED + 14))
    work = root / "run_refinegan"
    base = ["--model", "refinegan", "--resolution", "24000_256_1024", "--device", "cuda",
            f"data.train_roots=('{root / 'train'}',)", f"data.val_root={root / 'val'}",
            "run.log_interval=1", "run.val_interval=2", "run.ckpt_interval=2", "run.val_pesq=False",
            f"run.workdir={work}"]
    tf32_defaults()
    state, _ = drive_path("cli_train_refinegan", lambda: run_train_cli([*base, "run.max_steps=2"]), (), paths)
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    train_recs = [r for r in records if "train/generator/all" in r]
    val_recs = [r for r in records if "val/metrics/mel" in r]
    finite = all(math.isfinite(v) for r in records for v in r.values())
    ckpts = sorted(p.name for p in (work / "checkpoints").iterdir())
    ok = (state.step == 2 and finite and [r["step"] for r in train_recs] == [2]
          and [r["step"] for r in val_recs] == [2] and {"2.pt"} <= set(ckpts)
          and state.noise.device.type == "cuda")
    log({"phase": "cli_train", "model": "refinegan", "batch": 16, "frames": 128, "steps": 2, "checkpoints": ckpts,
         "train_records": train_recs, "val_records": val_recs, "finite": finite, "ok": ok})
    if not ok:
        raise SystemExit("cli.train --model refinegan: the run did not train, validate and checkpoint as asked")

    tf32_defaults()
    state, text = drive_path("cli_train_refinegan_resume", lambda: run_train_cli([*base, "run.max_steps=3"]), (),
                             paths)
    ok = state.step == 3 and "auto-resumed from step 2" in text and (work / "checkpoints" / "3.pt").is_file()
    log({"phase": "cli_train_resume", "model": "refinegan", "step": state.step, "ok": ok})
    if not ok:
        raise SystemExit("cli.train --model refinegan did not resume from step 2 and end at step 3")

    wav = root / "val" / "00.wav"
    n = read_wav(wav)[0].shape[-1]
    run_cli(infer, ["--model", "refinegan", "--resolution", "24000_256_1024", "--ckpt", str(work), "--input", str(wav),
                    "--output", str(root / "synth_refinegan")])
    tf32_off()
    check_cli_outputs(root / "synth_refinegan", {"00.wav": -(-n // task.hop_length) * task.hop_length}, task,
                      "cli_infer_from_training")
    return train_recs[-1]


def time_refinegan_step(dev, stamp: dict, cli_record: dict) -> dict:
    """The RefineGAN preset's training step at b16 x 32,768 samples (24 kHz), fp32, TF32 off: ms by phase,
    rate, peak memory, card-time parts (tools/profile_train.py); beside it the host's f0 seconds for the
    batch's 16 templates, one after another as ``batch_iterator`` makes them, and the CLI run's input wait
    a step."""
    import torch

    from vocoder_tpu_torch.data.f0 import f0_template
    from vocoder_tpu_torch.tools.profile_train import measure_step, training_setup
    from vocoder_tpu_torch.train import gan

    tf32_off()
    task, state, batch = training_setup("refinegan", 16, SEED, dev)
    t0 = time.perf_counter()
    for a in batch["audio"][:, 0].cpu().numpy():
        f0_template(a, task.sampling_rate, task.hop_length)
    f0_s = time.perf_counter() - t0
    rec = {"metric": "train_step_ms", "model": "refinegan", "batch": 16, "samples": task.hop_length * task.num_frames,
           "dtype": "fp32", **measure_step(state, gan.make_train_step(task), batch, task, TIMED_STEPS),
           "f0_seconds_per_batch": f0_s,
           "cli_input_wait_s_per_step": cli_record.get("perf/input_wait_s"),
           "cli_audio_s_per_s": cli_record.get("perf/audio_s_per_s"), **stamp}
    log(rec)
    del state
    torch.cuda.empty_cache()
    return rec


# Phases 15-18: the vae and vqvae families, and Vocos and Firefly-GAN training.
# (name, the gan preset or the family's model argument, family) of each newly trainable generator.
FAMILY_STEPS = (("vae", "hifigan", "vae"), ("vqvae", "hifigan", "vqvae"), ("vocos", "vocos", "gan"),
                ("firefly_gan_base", "firefly_gan_base", "gan"))
# A frame's VQ code is held equal across devices where its margin (second-best minus best squared
# distance) exceeds this share of its squared norm: fp32 sums over 512 dimensions, and the 16 WaveNet
# layers' convs summed in another order, move a distance by ~1e-6 of that.
CODEC_MARGIN_REL = 1e-4
# One reduced-depth step on the card against the same step on the CPU, TF32 off: the same operations in
# fp32, summed in other orders.
FAMILY_LOSS_REL, FAMILY_GRAD_REL_L2, FAMILY_EMA_REL_L2 = 1e-5, 1e-3, 1e-5


def fit_codebook(model, inputs, seed: int) -> None:
    """Put the first codebook where a trained one would sit: on latent frames of ``inputs`` (a vqvae's
    spectrogram, an ssl codec's HuBERT features) plus noise of 0.3 of their spread (``embed_avg`` with it).
    A random encoder's latents vary little about their mean, so against a unit-normal codebook every frame
    would take the same code."""
    import torch

    with torch.no_grad():
        frames = model.encode(inputs).transpose(1, 2).reshape(-1, model.cfg.vq.dim)
        gen = torch.Generator().manual_seed(seed)
        k = model.cfg.vq.codebook_size
        idx = torch.randint(0, frames.shape[0], (k,), generator=gen).to(inputs.device)
        noise = torch.randn(k, frames.shape[1], generator=gen).to(inputs.device)
        rows = frames[idx] + 0.3 * frames.std(0) * noise
        model.vq.layers[0].embed.copy_(rows)
        model.vq.layers[0].embed_avg.copy_(rows)


def codec_margins(model, inputs):
    """(codes (F,), margin over squared norm (F,)) of the first quantiser for one item's inputs, float64."""
    import torch

    with torch.no_grad():
        x = model.encode(inputs)[0].T.double()
        d = torch.cdist(x, model.vq.layers[0].embed.double()).square()
        best = torch.topk(d, 2, dim=1, largest=False).values
    return torch.argmin(d, dim=1), (best[:, 1] - best[:, 0]) / x.square().sum(1)


def codec_wavs(root: Path, sr: int, rng) -> dict[str, float]:
    """Speech-like WAVs for the codec (vibrato tones under a syllable envelope, noise bursts), one stereo
    and one at 22.05 kHz; name -> seconds."""
    import numpy as np

    from vocoder_tpu_torch.data.audio_io import write_wav

    out = {}
    for i, (rate, seconds, ch) in enumerate(((sr, 3.0, 1), (sr, 2.2, 1), (sr, 1.3, 2), (22050, 1.7, 1))):
        n = int(rate * seconds)
        t = np.arange(n) / rate
        f0 = rng.uniform(110.0, 260.0)
        env = np.clip(np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t), 0.0, None)
        tone = sum(np.sin(2 * np.pi * k * f0 * t + 2.0 * np.sin(2 * np.pi * 5.0 * t)) / k for k in range(1, 6))
        audio = 0.2 * env * tone + 0.05 * (1 - env) * rng.standard_normal(n)
        write_wav(root / f"{i}.wav", np.stack([audio, np.roll(audio, 7)][:ch]).astype(np.float32), rate)
        out[f"{i}.wav"] = n / rate
    return out


def check_codec(root: Path, dev, paths: dict, stamp: dict, family: str = "vqvae", extractors: dict | None = None):
    """cli.codec at a codec preset's full width: a seeded training state (random weights from numpy, the codebook
    fitted to the inputs' latents) saved as a workdir, then `encode` and `decode` on the card over the WAVs,
    and `encode --device cpu`.  vqvae (15): 44.1 kHz, a 16-layer WaveNet of 256 over the linear spectrogram, a
    4,096 x 512 codebook, a 512-channel HiFiGAN decoder.  ssl (34): 16 kHz, the frozen HuBERT's features (the
    CLI's random backbone of seed 0; ``extractors``, device -> extractor, hold the same for this check), a
    768 -> 512 post-net, the same codebook and a decoder at hop 640.  The card's codes equal the CPU's on every
    frame whose margin exceeds CODEC_MARGIN_REL of its squared norm; each decoded WAV equals the generator's
    eval forward on the card within WAV_TOL.  Encode and decode audio-s/s and seconds."""
    import numpy as np
    import torch

    from vocoder_tpu_torch.cli import codec
    from vocoder_tpu_torch.config import TrainConfig, build_task_config
    from vocoder_tpu_torch.data.audio_io import read_audio, read_wav
    from vocoder_tpu_torch.data.resample import resample
    from vocoder_tpu_torch.models.vae import ssl_random_state_dict, vqvae_random_state_dict
    from vocoder_tpu_torch.ops.spectral import linear_spectrogram
    from vocoder_tpu_torch.train import gan
    from vocoder_tpu_torch.utils.checkpoint import CheckpointManager

    tf32_off()
    ssl = family == "ssl"
    resolution = "16000_640_2048" if ssl else "44100_512_2048"
    task = build_task_config(family=family, resolution=resolution)
    (root / "in").mkdir()
    seconds = codec_wavs(root / "in", task.sampling_rate, np.random.default_rng(SEED + (34 if ssl else 16)))

    def inputs_of(name: str, device) -> torch.Tensor:  # the CLI's preprocessing of one file
        audio, sr = read_audio(root / "in" / name)
        a = resample(audio.mean(0), sr, task.sampling_rate)
        a = torch.from_numpy(np.pad(a, (0, (-len(a)) % task.hop_length)).astype(np.float32))[None].to(device)
        if ssl:
            return extractors[str(device)](a)
        return linear_spectrogram(a, n_fft=task.n_fft, hop_length=task.hop_length, win_length=task.win_length)

    state = gan.create_train_state(task, SEED, dev)
    weights = ssl_random_state_dict if ssl else vqvae_random_state_dict
    state.generator.load_state_dict(weights(task.generator, SEED))
    fit_codebook(state.generator, torch.cat([inputs_of(n, dev) for n in ("0.wav", "1.wav")], dim=1 if ssl else 2),
                 SEED + 16)
    work = root / "run"
    CheckpointManager(work / "checkpoints").save(0, state, force=True)
    (work / "config.json").write_text(json.dumps(dataclasses.asdict(TrainConfig(task=task)), default=str))
    del state
    torch.cuda.empty_cache()
    tag = "_ssl" if ssl else ""

    def run(mode: str, src: Path, dst: Path, device: str, path: str | None = None) -> float:
        """The CLI from PyTorch's default TF32 flags; its seconds.  ``path``: a main path on the card."""
        argv = [mode, "--family", family, "--resolution", resolution, "--ckpt", str(work), "--input", str(src),
                "--output", str(dst), "--device", device]
        tf32_defaults()
        t0 = time.perf_counter()
        if path is None:
            codec.main(argv)
        else:
            drive_path(path, lambda: codec.main(argv), (), paths)
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise SystemExit("cli.codec left TF32 on")
        return time.perf_counter() - t0

    encode_s = run("encode", root / "in", root / "codes", str(dev), f"codec_encode{tag}")
    decode_s = run("decode", root / "codes", root / "out", str(dev), f"codec_decode{tag}")
    cpu_s = run("encode", root / "in", root / "codes_cpu", "cpu")
    tf32_off()
    cpu_model = codec.load_codec(work, task, torch.device("cpu"))
    card_model = codec.load_codec(work, task, torch.device(dev))
    total = {"frames": 0, "under_margin": 0, "differ": 0, "differ_above_margin": 0, "codes_used": set()}
    worst_wav = 0.0
    for name in seconds:
        stem = name[: -len(".wav")]
        card = np.load(root / "codes" / f"{stem}.codes.npy")
        cpu = np.load(root / "codes_cpu" / f"{stem}.codes.npy")
        _, rel_margin = codec_margins(cpu_model, inputs_of(name, "cpu"))
        clear = rel_margin.numpy() > CODEC_MARGIN_REL
        differ = card[0, 0] != cpu[0, 0]
        total["frames"] += differ.size
        total["under_margin"] += int((~clear).sum())
        total["differ"] += int(differ.sum())
        total["differ_above_margin"] += int((differ & clear).sum())
        total["codes_used"] |= set(card[0, 0].tolist())
        with torch.no_grad():
            want = card_model(inputs_of(name, dev))[0][0, 0].cpu().numpy()
        wav, sr = read_wav(root / "out" / f"{stem}.wav")
        err = float(np.abs(wav[0] - want).max()) if wav.shape == (1, want.size) else float("inf")
        worst_wav = max(worst_wav, err)
        log({"phase": f"codec_file{tag}", "file": name, "frames": int(card.shape[-1]),
             "codes_shape": list(card.shape),
             "differ": int(differ.sum()), "under_margin": int((~clear).sum()), "wav_vs_forward_max_abs": err,
             "decoded_peak": float(np.abs(wav).max()) if wav.size else None})
    audio_s = sum(seconds.values())
    ok = (total["differ_above_margin"] == 0 and worst_wav <= WAV_TOL and len(total["codes_used"]) > 10
          and total["under_margin"] < total["frames"])
    log({"phase": "codec", "model": family, "files": len(seconds), "audio_s": audio_s, "frames": total["frames"],
         "codes_used": len(total["codes_used"]), "share_under_margin": total["under_margin"] / total["frames"],
         "margin_rel": CODEC_MARGIN_REL, "codes_differ_card_vs_cpu": total["differ"],
         "codes_differ_above_margin": total["differ_above_margin"], "wav_vs_forward_max_abs": worst_wav,
         "wav_limit": WAV_TOL, "ok": ok})
    log({"metric": "codec_seconds", "model": family, "audio_s": audio_s, "encode_seconds": encode_s,
         "decode_seconds": decode_s, "encode_audio_s_per_s": audio_s / encode_s,
         "decode_audio_s_per_s": audio_s / decode_s, "cpu_encode_seconds": cpu_s, **stamp})
    if not ok:
        raise SystemExit(f"cli.codec --family {family}: the card's codes or decoded audio disagree, or the codes "
                         "did not vary")
    del cpu_model, card_model
    torch.cuda.empty_cache()


def time_family_steps(dev, stamp: dict) -> None:
    """The training step of vae, vqvae, Vocos (base) and Firefly-GAN at their presets' widths and the
    trainer's default batch 16 (44.1 kHz; 128 frames, the vqvae's 32), fp32, TF32 off: ms by phase of the third
    step, audio-s/s, peak memory, card busy and top kernels (tools/profile_train.py).  None of them launches
    a hand kernel, so this runs during the build."""
    import torch

    from vocoder_tpu_torch.tools.profile_train import measure_step, training_setup
    from vocoder_tpu_torch.train import gan

    tf32_off()
    for name, model, family in FAMILY_STEPS:
        task, state, batch = training_setup(model, 16, SEED, dev, family)
        rec = measure_step(state, gan.make_train_step(task), batch, task, 3)
        log({"metric": "train_step_ms", "model": name, "batch": 16, "samples": task.hop_length * task.num_frames,
             "dtype": "fp32", "params": sum(p.numel() for p in state.generator.parameters()),
             "busy_share_of_step": rec["profiled_busy_ms"] / rec["ms"], **rec, **stamp})
        del state, batch
        torch.cuda.empty_cache()


def reduced_family_task(name: str, model: str, family: str):
    """The preset's task at full width and reduced depth (ConvNeXt one block a stage, WaveNet 2 layers,
    each HiFiGAN stage one resblock of kernel 3), 16 frames and a 4,096-sample crop: for a CPU step."""
    from vocoder_tpu_torch.config import build_task_config

    task = build_task_config(model, "44100_512_2048", family)
    gen = task.generator
    one_block = dict(resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
    if name == "vae":
        gen = dataclasses.replace(gen, encoder=dataclasses.replace(gen.encoder, depths=(1, 1, 1, 1)),
                                  decoder=dataclasses.replace(gen.decoder, **one_block))
    elif name == "vqvae":
        gen = dataclasses.replace(gen, encoder=dataclasses.replace(gen.encoder, n_layers=2),
                                  decoder=dataclasses.replace(gen.decoder, **one_block))
    elif name == "vocos":
        gen = dataclasses.replace(gen, backbone=dataclasses.replace(gen.backbone, depths=(1, 1, 1, 1)))
    else:
        gen = dataclasses.replace(gen, backbone=dataclasses.replace(gen.backbone, depths=(1, 1, 1, 1)),
                                  head=dataclasses.replace(gen.head, **one_block))
    return task.replace(generator=gen, num_frames=16, crop_length=4096)


def adam_step_close(new_card, new_cpu, old, grad_cpu, grad_err: float, lr: float, wd: float) -> bool:
    """Updated parameters under Adam's first-step caveat: a step moves each element by about lr * sign(g),
    so where the gradient lies within 100x its card-vs-CPU difference of 0 the sign may flip (within
    2 lr + lr * wd * |p| + 2 ulps); elsewhere the steps agree to 1e-3 relative (+ 2 ulps)."""
    import torch

    step_card, step_cpu = new_card - old, new_cpu - old
    ulps = 2 * torch.abs(old) * 2.0 ** -23
    clear = grad_cpu.abs() > 100 * max(grad_err, 1e-6)
    diff = (step_card - step_cpu).abs()
    return bool((diff[clear] <= 1e-3 * step_cpu[clear].abs() + ulps[clear]).all()
                and (diff[~clear] <= 2 * lr + lr * wd * old[~clear].abs() + ulps[~clear]).all())


def check_family_steps_cpu(dev, paths: dict) -> None:
    """One step of each family at full width and reduced depth (``reduced_family_task``), b2, TF32 off, on
    the card and on the CPU from the same weights, batch, crop start and draws (``step_card_vs_cpu``), the
    vqvae's EMA codebook fitted to the batch's latents first, so that the step touches many codes."""
    from vocoder_tpu_torch.models.vae import vae_random_state_dict, vqvae_random_state_dict
    from vocoder_tpu_torch.tools.profile_forward import RANDOM_WEIGHTS
    from vocoder_tpu_torch.tools.profile_train import synthetic_batch
    from vocoder_tpu_torch.train import gan

    tf32_off()
    weights = {**RANDOM_WEIGHTS, "vae": vae_random_state_dict, "vqvae": vqvae_random_state_dict}
    for name, model, family in FAMILY_STEPS:
        task = reduced_family_task(name, model, family)
        t = task.hop_length * task.num_frames
        batch = synthetic_batch(TRAIN_CHECK_BATCH, t, task.sampling_rate, SEED, "cpu")
        batch["lengths"][1] = t * 4 // 5
        batch["audio"][1, :, t * 4 // 5:] = 0.0
        sd = weights[task.generator_name](task.generator, SEED)
        if name == "vqvae":  # one fitted codebook for both devices
            from vocoder_tpu_torch.models.vae import VQVAEGenerator

            m = VQVAEGenerator(task.generator)
            m.load_state_dict(sd)
            fit_codebook(m, gan.input_transform(task, batch["audio"][:, 0]), SEED)
            sd = m.state_dict()
        step_card_vs_cpu(name, task, batch, sd, dev, paths)


def step_card_vs_cpu(name: str, task, batch: dict, sd: dict, dev, paths: dict) -> dict:
    """One training step of ``task`` from the generator weights ``sd`` on the CPU batch ``batch``, on the
    card (the main path ``train_step_<name>``) and on the CPU, from the same crop start and draws (the noise
    generator a CPU one on both sides: drop_path and eps draw on their generator's device): every loss, every
    generator gradient, the updated generator parameters, and any EMA codebook."""
    import torch

    from vocoder_tpu_torch.train import gan

    t = batch["audio"].shape[2]
    runs = {}
    for device in ("cpu", dev):
        state = gan.create_train_state(task, SEED, device)
        state.generator.load_state_dict(sd)
        state.noise = torch.Generator().manual_seed(SEED)
        b = {k: v.to(device) for k, v in batch.items()}
        old = {k: v.detach().cpu().clone() for k, v in state.generator.state_dict().items()}
        start = gan.draw_crop_start(state, task, t)
        step = gan.make_train_step(task)
        if device == "cpu":
            metrics = step(state, b, start)
        else:
            metrics = drive_path(f"train_step_{name}", lambda: step(state, b, start), (), paths)
        runs[device] = ({k: float(v) for k, v in metrics.items()},
                        {n: p.grad.detach().cpu().clone() for n, p in state.generator.named_parameters()},
                        {k: v.detach().cpu().clone() for k, v in state.generator.state_dict().items()}, old)
        del state
    (mk, gk, nk, _), (mc, gc, nc, old) = runs[dev], runs["cpu"]
    lr = mc["lr"]
    loss_rel = {k: rel(mk[k], mc[k]) for k in mk if "grad_norm" not in k and k != "lr"}
    grad_rel = {n: rel_l2(gk[n], gc[n]) for n in gc}
    worst = max(grad_rel, key=grad_rel.get)
    params_ok = all(adam_step_close(nk[n], nc[n], old[n], gc[n], float((gk[n] - gc[n]).abs().max()), lr,
                                    task.weight_decay) for n in gc)
    ema = {k: rel_l2(nk[k], nc[k]) for k in nc if ".vq." in f".{k}" and "layers" in k}
    ema_moved = {k: rel_l2(nc[k], old[k]) for k in ema}
    ok = (max(loss_rel.values()) <= FAMILY_LOSS_REL and grad_rel[worst] <= FAMILY_GRAD_REL_L2 and params_ok
          and all(v <= FAMILY_EMA_REL_L2 for v in ema.values()) and all(v > 0 for v in ema_moved.values())
          and all(map(math.isfinite, list(mk.values()) + list(mc.values()))))
    rec = {"phase": "family_step_card_vs_cpu", "model": name, "batch": batch["audio"].shape[0], "samples": t,
           "generator": dataclasses.asdict(task.generator), "metrics_card": mk, "loss_rel": loss_rel,
           "max_grad_rel_l2": grad_rel[worst], "worst_grad": worst, "params_adam_close": params_ok,
           "ema_rel_l2": ema, "ema_moved_rel_l2": ema_moved, "launches": paths[f"train_step_{name}"],
           "limits": {"loss_rel": FAMILY_LOSS_REL, "grad_rel_l2": FAMILY_GRAD_REL_L2,
                      "ema_rel_l2": FAMILY_EMA_REL_L2},
           "ok": ok}
    log(rec)
    if not ok:
        raise SystemExit(f"{name}: the training step on the card disagrees with the step on the CPU")
    torch.cuda.empty_cache()
    return rec


def check_cli_train_codec(root: Path, dev, paths: dict, family: str = "vqvae", stamp: dict | None = None) -> None:
    """cli.train --family vqvae (18; 44.1 kHz) or ssl (33; --resolution 16000_640_2048, the backbone's
    features made on the card a step) at the preset's batch 16 x 32 frames on 32 generated WAVs: 4 steps
    with validation every 2 and a checkpoint every 2, then a resume to 6; the codebooks move from step 2 to
    4, step 4's checkpoint holds the run's last codebook, and the resumed run moves it on.  For ssl, the
    steps' ms and audio-s/s from the log and the backbone's share of each (``perf/ssl_features_s``)."""
    import numpy as np
    import torch

    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.utils.checkpoint import CheckpointManager

    ssl = family == "ssl"
    resolution = SSL_RESOLUTION if ssl else "44100_512_2048"
    task = build_task_config(family=family, resolution=resolution)
    write_train_corpus(root, task.sampling_rate, np.random.default_rng(SEED + (33 if ssl else 17)))
    work = root / f"run_{family}"
    base = ["--family", family, "--resolution", resolution, "--device", str(dev),
            f"data.train_roots=('{root / 'train'}',)", f"data.val_root={root / 'val'}", "run.log_interval=1",
            "run.val_interval=2", "run.ckpt_interval=2", "run.val_pesq=False", f"run.workdir={work}"]
    tf32_defaults()
    state, _ = drive_path(f"cli_train_{family}", lambda: run_train_cli([*base, "run.max_steps=4"]), (), paths)
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    train_recs = [r for r in records if "train/generator/all" in r]
    val_recs = [r for r in records if "val/metrics/mel" in r]
    finite = all(math.isfinite(v) for r in records for v in r.values())
    ckpts = sorted(p.name for p in (work / "checkpoints").iterdir())
    embed = state.generator.vq.layers[0].embed.detach().cpu()
    saved = CheckpointManager(work / "checkpoints").load(4)["generator"]["vq.layers.0.embed"]
    first = CheckpointManager(work / "checkpoints").load(2)["generator"]["vq.layers.0.embed"]
    ok = (state.step == 4 and finite and [r["step"] for r in train_recs] == [2, 3, 4]
          and [r["step"] for r in val_recs] == [2, 4] and {"2.pt", "4.pt"} <= set(ckpts)
          and all("train/generator/vq" in r for r in train_recs) and torch.equal(saved, embed)
          and not torch.equal(first, embed) and all(("perf/ssl_features_s" in r) == ssl for r in train_recs))
    log({"phase": "cli_train", "model": family, "batch": 16, "frames": 32, "steps": 4, "checkpoints": ckpts,
         "train_records": train_recs, "val_records": val_recs, "finite": finite,
         "codebook_moved_rel_l2_2_to_4": rel_l2(embed, first), "ok": ok})
    if not ok:
        raise SystemExit(f"cli.train --family {family}: the run did not train, validate and checkpoint as asked")

    tf32_defaults()
    state, text = drive_path(f"cli_train_{family}_resume", lambda: run_train_cli([*base, "run.max_steps=6"]), (),
                             paths)
    ok = (state.step == 6 and "auto-resumed from step 4" in text and (work / "checkpoints" / "6.pt").is_file()
          and not torch.equal(state.generator.vq.layers[0].embed.detach().cpu(), embed))
    log({"phase": "cli_train_resume", "model": family, "step": state.step, "ok": ok})
    if not ok:
        raise SystemExit(f"cli.train --family {family} did not resume from step 4 and end at step 6")
    if ssl:  # steps 3 (after step 2's validation and checkpoint), 4 and 6 (each the only step of its window)
        records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
        for r in records:
            if "perf/steps_per_s" in r and r["step"] in (3, 4, 6):
                step_s = 1.0 / r["perf/steps_per_s"]
                log({"metric": "cli_train_step", "model": "ssl", "batch": 16, "frames": 32, "step": r["step"],
                     "ms": 1e3 * step_s, "audio_s_per_s": r["perf/audio_s_per_s"],
                     "backbone_ms": 1e3 * r["perf/ssl_features_s"],
                     "backbone_share": r["perf/ssl_features_s"] / step_s, "input_wait_s": r["perf/input_wait_s"],
                     "after_validation": r["step"] == 3, **stamp})


# Slice 9: the host's audio decoders, training over FLAC/Ogg/MP3 with validation PESQ, and evaluation.
FLAC_FIXTURES = list(itertools.product((16, 24), (1, 2), (44100, 22050)))  # bits, channels, rate
VORBIS_ATOL = 5e-6  # tests/test_vorbis_native.py: the numpy Vorbis decoder against libvorbisfile
MP3_SNR_DB = 25.0  # tests/test_mp3.py:32: a transparent-bitrate bound on tonal content
PESQ_RANGE = (1.0, 4.65)  # the MOS-LQO scale of P.862.1 / P.862.2
IDENTITY_NB, IDENTITY_WB = 4.5486, 4.6439  # the maps at raw 4.5 (tests/test_pesq.py:33), to 4 decimals
SPEC_RTOL = 1e-4  # spec_diff and MCD, card against CPU
EVAL_KEYS = {"pesq_nb", "pesq_wb", "spec_diff", "si_sdr", "mcd"}
# Training files' seconds, uniform: from the crop (65,536 samples) to a mean of 5.85 s, near LibriTTS
# train-clean-100's mean utterance (53.78 h over 33,236 utterances, 5.83 s; Zen et al. 2019, Table 1).
TRAIN_SECONDS = (1.5, 10.2)


def tone(sr: int, seconds: float, rng, channels: int = 1):
    """A sine with a vibrato plus a little noise, (channels, T) float32 in [-0.5, 0.5]."""
    import numpy as np

    t = np.arange(int(sr * seconds)) / sr
    out = []
    for _ in range(channels):
        f0 = rng.uniform(100.0, 400.0)
        out.append(0.3 * np.sin(2 * np.pi * f0 * t + 2.0 * np.sin(2 * np.pi * 5.0 * t))
                   + 0.1 * np.sin(2 * np.pi * 3 * f0 * t) + 0.01 * rng.standard_normal(t.size))
    return np.stack(out).astype(np.float32)


def host_audio() -> dict:
    """19. Build the host audio library (csrc/audio_host.cc, the system C++ compiler) and report which codec
    libraries load.  FLAC's native decoder is never optional here."""
    from vocoder_tpu_torch.data import mp3, native, ogg

    built = native.available()
    libs = {"libmpg123": mp3.decoder_available(), "libmp3lame": mp3.encoder_available(),
            "libvorbisfile": ogg.system_decoder_available(), "libvorbisenc": ogg.encoder_available()}
    log({"phase": "host_audio", "built": built, "build_seconds": native.build_seconds,
         "build_error": native.build_error, "codec_libraries": libs, "ok": built})
    if not built:
        raise SystemExit(f"the host audio library did not build: {native.build_error}")
    return libs


def decode_rate(fn, files: list, audio_s: float, rounds: int) -> float:
    """audio-s/s of ``fn`` over ``files`` (their audio seconds together), ``rounds`` times over."""
    t0 = time.perf_counter()
    for _ in range(rounds):
        for f in files:
            fn(f)
    return rounds * audio_s / (time.perf_counter() - t0)


def check_decoders(root: Path, libs: dict, stamp: dict) -> None:
    """20. Fixtures written by the port's own encoders: FLAC at 16 / 24 bit, mono / stereo, 44.1 / 22.05 kHz
    (the native and numpy decodes each equal to the quantised source, bit for bit); Ogg q0.6 (the native
    loop equal to the pull loop, the numpy decoder within VORBIS_ATOL); MP3 (gapless length, SNR); each
    path's decode audio-s/s on this host.  A format whose codec library is absent prints why it skipped.
    The committed Ogg fixture (tools/vorbis_fixture.py) goes through the numpy Vorbis decoder on every host,
    held against its committed decode within VORBIS_ATOL, with its audio-s/s."""
    import numpy as np

    from vocoder_tpu_torch.data import flac, mp3, native, ogg, vorbis
    from vocoder_tpu_torch.tools import vorbis_fixture

    rng = np.random.default_rng(SEED + 19)
    root.mkdir()
    files, audio_s, ok = [], 0.0, True
    before = native.decodes["flac"]
    for bits, ch, sr in FLAC_FIXTURES:
        full = float(1 << (bits - 1))
        pcm = np.clip(np.rint(tone(sr, 1.0, rng, ch) * full), -full, full - 1).astype(np.int64)
        path = root / f"f{bits}_{ch}_{sr}.flac"
        flac.write_flac(path, pcm, sr, bits_per_sample=bits)
        want = (pcm.astype(np.float32) / np.float32(full)).astype(np.float32)
        got, got_sr = flac.read_flac(path)
        pure, pure_sr = flac.read_flac_pure(path)
        case_ok = got_sr == pure_sr == sr and np.array_equal(got, want) and np.array_equal(pure, want)
        log({"phase": "decoders", "format": "flac", "bits": bits, "channels": ch, "rate": sr, "ok": case_ok})
        ok = ok and case_ok
        files.append(path)
        audio_s += pcm.shape[-1] / sr
    native_flac = native.decodes["flac"] - before
    rates = {"flac_native": decode_rate(flac.read_flac, files, audio_s, 20),
             "flac_numpy": decode_rate(flac.read_flac_pure, files, audio_s, 1)}
    ok = ok and native_flac == len(FLAC_FIXTURES)

    # The committed fixture: the numpy Vorbis decoder is what reads Ogg on a host without libvorbisfile.
    want = np.load(vorbis_fixture.EXPECTED)
    pure, pure_sr = vorbis.read_ogg_pure(vorbis_fixture.FIXTURE)
    err = float(np.abs(pure - want).max()) if pure.shape == want.shape else None
    case_ok = pure_sr == vorbis_fixture.RATE and err is not None and err < VORBIS_ATOL
    log({"phase": "decoders", "format": "ogg", "fixture": vorbis_fixture.FIXTURE.name,
         "quality": vorbis_fixture.QUALITY, "channels": int(want.shape[0]), "rate": pure_sr,
         "numpy_vs_expected_max_abs": err, "ok": case_ok})
    ok = ok and case_ok
    rates["ogg_numpy_fixture"] = decode_rate(vorbis.read_ogg_pure, [vorbis_fixture.FIXTURE],
                                             vorbis_fixture.SECONDS, 4)

    if libs["libvorbisenc"]:
        files, audio_s = [], 0.0
        for ch, sr in ((1, 44100), (2, 22050)):
            x = tone(sr, 1.0, rng, ch)
            path = root / f"o{ch}_{sr}.ogg"
            ogg.write_ogg(path, x, sr, quality=0.6)
            got = native.ogg_decode(path)
            pull, pull_sr = ogg.read_ogg_pull(path)
            pure, pure_sr = vorbis.read_ogg_pure(path)
            case_ok = (got is not None and got[1] == pull_sr == pure_sr == sr and got[0].shape == x.shape
                       and np.array_equal(got[0], pull) and pure.shape == x.shape
                       and float(np.abs(pure - pull).max()) < VORBIS_ATOL)
            log({"phase": "decoders", "format": "ogg", "quality": 0.6, "channels": ch, "rate": sr,
                 "numpy_vs_pull_max_abs": float(np.abs(pure - pull).max()), "ok": case_ok})
            ok = ok and case_ok
            files.append(path)
            audio_s += x.shape[-1] / sr
        rates["ogg_native"] = decode_rate(native.ogg_decode, files, audio_s, 20)
        rates["ogg_pull"] = decode_rate(ogg.read_ogg_pull, files, audio_s, 5)
        rates["ogg_numpy"] = decode_rate(vorbis.read_ogg_pure, files, audio_s, 1)
    else:
        log({"phase": "decoders", "format": "ogg", "encoded_here": "skipped", "skipped": "libvorbisenc absent"})

    if libs["libmp3lame"] and libs["libmpg123"]:
        files, audio_s = [], 0.0
        for ch, sr in ((1, 44100), (2, 32000)):
            x = tone(sr, 1.0, rng, ch)
            path = root / f"m{ch}_{sr}.mp3"
            mp3.write_mp3(path, x, sr)
            y, y_sr = mp3.read_mp3(path)
            snr = (float(min(10 * np.log10(np.mean(x[c] ** 2) / np.mean((y[c] - x[c]) ** 2)) for c in range(ch)))
                   if y.shape == x.shape else None)
            case_ok = y_sr == sr and y.shape == x.shape and snr > MP3_SNR_DB
            log({"phase": "decoders", "format": "mp3", "channels": ch, "rate": sr, "samples": y.shape[-1],
                 "expected": x.shape[-1], "snr_db": snr, "ok": case_ok})
            ok = ok and case_ok
            files.append(path)
            audio_s += x.shape[-1] / sr
        rates["mp3"] = decode_rate(mp3.read_mp3, files, audio_s, 5)
    else:
        log({"phase": "decoders", "format": "mp3",
             "skipped": f"{'libmp3lame' if not libs['libmp3lame'] else 'libmpg123'} absent"})
    log({"metric": "decode_audio_s_per_s", "host": "the card machine's host, one thread", **rates,
         "native_flac_decodes": native_flac, **stamp})
    if not ok:
        raise SystemExit("a decoder disagrees with its source or with another path")


def write_formats_corpus(root: Path, sr: int, libs: dict, rng) -> dict:
    """16 training files (FLAC 16 and 24 bit, Ogg q0.6 and MP3 where their encoders load, else FLAC) of
    TRAIN_SECONDS and 4 validation FLAC clips of 2 s; the count of each format."""
    from vocoder_tpu_torch.data import flac, mp3, ogg

    counts = {}
    for sub, n in (("train", 16), ("val", 4)):
        (root / sub).mkdir(parents=True)
        for i in range(n):
            x = tone(sr, rng.uniform(*TRAIN_SECONDS) if sub == "train" else 2.0, rng)
            kind = "flac" if sub == "val" else ("flac", "flac24", "ogg", "mp3")[i % 4]
            if kind == "ogg" and not libs["libvorbisenc"] or kind == "mp3" and not libs["libmp3lame"]:
                kind = "flac"
            if kind == "ogg":
                ogg.write_ogg(root / sub / f"{i:02d}.ogg", x, sr, quality=0.6)
            elif kind == "mp3":
                mp3.write_mp3(root / sub / f"{i:02d}.mp3", x, sr)
            else:
                flac.write_flac(root / sub / f"{i:02d}.flac", x, sr, bits_per_sample=24 if kind == "flac24" else 16)
            counts[f"{sub}_{kind}"] = counts.get(f"{sub}_{kind}", 0) + 1
    return counts


def check_cli_train_formats(root: Path, libs: dict, paths: dict, stamp: dict) -> Path:
    """21. cli.train --model bigvgan at the preset's batch 16 x 128 frames over a FLAC + Ogg + MP3 corpus of
    LibriTTS-long files, 4 steps logged one by one, validation at step 4 over 4 FLAC clips with the default
    run.val_pesq: a finite PESQ in range, K1 at least 91 a step and K2 in validation, native FLAC decodes,
    each step's time and input wait, the validation's seconds split into the eval forwards (CUDA events)
    and host PESQ, and the media PNG where matplotlib imports.  The workdir."""
    import importlib.util

    import numpy as np
    import torch

    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.data import native

    task = build_task_config("bigvgan", "44100_512_2048")
    counts = write_formats_corpus(root, task.sampling_rate, libs, np.random.default_rng(SEED + 21))
    work = root / "run"
    steps = 4
    argv = ["--model", "bigvgan", "--device", "cuda", f"data.train_roots=('{root / 'train'}',)",
            f"data.val_root={root / 'val'}", "run.log_interval=1", f"run.val_interval={steps}",
            f"run.ckpt_interval={steps}", f"run.max_steps={steps}", f"run.workdir={work}"]
    flac_before, ogg_before = native.decodes["flac"], native.decodes["ogg"]
    tf32_defaults()
    t0 = time.perf_counter()
    state, _ = drive_path("cli_train_formats", lambda: run_train_cli(argv), ("aa_snake", FP32_K2), paths,
                          blockwise=steps * len(task.generator.upsample_rates))
    seconds = time.perf_counter() - t0
    native_flac, native_ogg = native.decodes["flac"] - flac_before, native.decodes["ogg"] - ogg_before
    launches = paths["cli_train_formats"]
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    train_rec = [r for r in records if "train/generator/all" in r]  # steps 2..4: the first is taken apart
    val_rec = [r for r in records if "val/metrics/mel" in r]
    pesq = val_rec[0].get("val/metrics/pesq") if val_rec else None
    media = sorted(p.name for p in (work / "media").glob("*.png")) if (work / "media").is_dir() else []
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    val_pesq_default = json.loads((work / "config.json").read_text())["run"]["val_pesq"]
    ok = (state.step == steps and val_pesq_default and len(train_rec) == steps - 1 and len(val_rec) == 1
          and all(math.isfinite(v) for r in records for v in r.values())
          and pesq is not None and PESQ_RANGE[0] <= pesq <= PESQ_RANGE[1]
          and launches["aa_snake"] >= K1_PER_BIGVGAN_FORWARD * steps and launches[FP32_K2] > 0
          and native_flac > 0 and all("perf/input_wait_s" in r for r in train_rec)
          and (media == [f"val_mel_{steps:08d}.png"] if has_mpl else media == [])
          and not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32))
    v = val_rec[0] if val_rec else {}
    step_s = [1.0 / r["perf/steps_per_s"] for r in train_rec]
    wait_s = [r.get("perf/input_wait_s") for r in train_rec]
    log({"phase": "cli_train_formats", "model": "bigvgan", "batch": 16, "frames": 128, "steps": steps,
         "corpus": counts, "train_file_seconds": TRAIN_SECONDS, "val_pesq_default": val_pesq_default,
         "val_pesq": pesq, "val_mel": v.get("val/metrics/mel"), "launches": launches,
         "native_flac_decodes": native_flac, "native_ogg_decodes": native_ogg,
         "logged_steps": [r["step"] for r in train_rec], "step_s": step_s, "input_wait_s": wait_s,
         "step_s_median_3_on": float(np.median(step_s[1:])) if len(step_s) > 1 else None,
         "input_wait_s_median_3_on": float(np.median(wait_s[1:])) if len(wait_s) > 1 else None,
         "val_forward_s": v.get("perf/val_forward_s"), "val_pesq_s": v.get("perf/val_pesq_s"),
         "run_seconds": seconds, "media": media,
         "media_case": "matplotlib imports: a PNG required" if has_mpl else "no matplotlib: no PNG expected",
         "ok": ok, **stamp})
    if not ok:
        raise SystemExit("cli.train over FLAC/Ogg/MP3 did not train, validate with PESQ and log as asked")
    return work


def check_cli_evaluate(root: Path, work: Path, infer, paths: dict, stamp: dict) -> None:
    """22. cli.infer from the cli_train_formats workdir over its FLAC validation clips, then cli.evaluate
    val synth --sr 44100 --glob-pattern '*.flac' with --workers 1 on the card (--device cuda) and then
    --workers 4, whose spawned processes score on the CPU (--device cpu): the same keys, PESQ and SI-SDR
    equal, spec_diff and MCD within SPEC_RTOL (card against CPU); an identity run on the card gives the
    PESQ fixed points and spectral distances of 0; seconds per pair for each worker count."""
    from vocoder_tpu_torch.cli import evaluate

    synth = root / "synth"
    argv = ["--model", "bigvgan", "--ckpt", str(work), "--input", str(root / "val"), "--output", str(synth),
            "--device", "cuda"]
    seconds = drive_path("cli_infer_flac", lambda: run_cli(infer, argv), ("aa_snake", FP32_K2), paths)
    n_pairs = len(list((root / "val").glob("*.flac")))
    ok = len(list(synth.glob("*.wav"))) == n_pairs
    log({"phase": "cli_infer_flac", "files": n_pairs, "seconds": seconds, "launches": paths["cli_infer_flac"],
         "ok": ok})
    base = [str(root / "val"), str(synth), "--sr", "44100", "--glob-pattern", "*.flac"]
    runs = {}
    for workers, device in ((1, "cuda"), (4, "cpu")):
        t0 = time.perf_counter()
        runs[workers] = drive_path(f"cli_evaluate_w{workers}", lambda: evaluate.main(
            [*base, "--workers", str(workers), "--device", device]), (), paths)
        runs[workers] = (runs[workers], (time.perf_counter() - t0) / n_pairs)
    (one, s1), (four, s4) = runs[1], runs[4]
    t0 = time.perf_counter()
    ident = evaluate.main([str(root / "val"), str(root / "val"), *base[2:], "--workers", "1", "--device", "cuda"])
    s_ident = (time.perf_counter() - t0) / n_pairs
    same = (set(one) == set(four) == set(ident) == EVAL_KEYS
            and all(one[k] == four[k] for k in ("pesq_nb", "pesq_wb", "si_sdr"))
            and all(math.isclose(one[k], four[k], rel_tol=SPEC_RTOL) for k in ("spec_diff", "mcd")))
    fixed = (set(ident) == EVAL_KEYS and abs(ident["pesq_nb"] - IDENTITY_NB) <= 5e-5
             and abs(ident["pesq_wb"] - IDENTITY_WB) <= 5e-5 and ident["spec_diff"] == 0.0 and ident["mcd"] == 0.0)
    ok = ok and same and fixed and all(math.isfinite(v) for v in one.values())
    log({"phase": "cli_evaluate", "pairs": n_pairs, "workers_1": one, "workers_4": four, "identity": ident,
         "devices": {"workers_1": "cuda", "workers_4": "cpu", "identity": "cuda"},
         "seconds_per_pair": {"workers_1": s1, "workers_4": s4, "identity_workers_1": s_ident},
         "workers_agree": same, "identity_fixed_points": fixed, "ok": ok, **stamp})
    if not ok:
        raise SystemExit("cli.evaluate: worker counts disagree, the identity run missed its fixed points, or a "
                         "synthesised file is missing")


# Phases 23-30: bf16 training, checkpointing, the profiler window, the bench CLIs and the native resample.
# The kernel-vs-plain steps run at TRAIN_CHECK_BATCH for the memory of the plain aa-snake's autograd (its
# intermediates are fp32 in either dtype); the timings, the CLI and the bench CLIs at the preset's b16.
BF16_LOSS_CAP, BF16_GRAD_CAP = 2e-2, 5e-2  # the bf16 rule's caps: kernel path within 2x the run's floor
CKPT_LOSS_REL, CKPT_GRAD_REL_L2 = 1e-5, 1e-4  # a checkpointed step against the same step without
K1_RECOMPUTED_PER_STEP = 90  # the AMP blocks' activations, run again in the backward (not activation_post)
TIMED_STEPS = 3  # measure_step's steps in phases 13, 14 and 26: the third is timed
RESAMPLE_SECONDS = 30.0  # audio for the native resample's speed-up (44.1 -> 16 kHz, the PESQ path)


def bf16_loss_keys(metrics: dict) -> list[str]:
    return sorted(k for k in metrics if k.startswith("train/") and "grad_norm" not in k)


def step_distance(a: tuple, b: tuple) -> dict:
    """(metrics, generator gradients) of two steps -> the relative L2 of their loss vectors and of their
    gradient vectors (every generator parameter's gradient in one vector)."""
    import torch

    keys = bf16_loss_keys(b[0])
    la, lb = (torch.tensor([m[k] for k in keys], dtype=torch.float64) for m in (a[0], b[0]))
    ga, gb = (torch.cat([g[n].double().flatten() for n in sorted(b[1])]) for g in (a[1], b[1]))
    return {"losses": float((la - lb).norm() / lb.norm()), "gradients": float((ga - gb).norm() / gb.norm())}


def check_bf16_step(dev, paths: dict) -> dict:
    """23. One BigVGAN bf16 training step (44.1 kHz preset, full width, b2 x 65,536 samples, TF32 off) through
    K1 against the same step through the plain versions, from equal weights, batch and crop.  The run's
    floor first: the plain bf16 step against the plain fp32 step.  The kernel step within twice that floor of
    the plain bf16 step (losses, generator gradients; capped), K1 launched 91 times, the masters fp32."""
    import torch

    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models import bigvgan
    from vocoder_tpu_torch.tools.profile_train import synthetic_batch
    from vocoder_tpu_torch.train import gan

    tf32_off()
    task32 = build_task_config("bigvgan", "44100_512_2048")
    t = task32.hop_length * task32.num_frames
    batch = synthetic_batch(TRAIN_CHECK_BATCH, t, task32.sampling_rate, SEED, dev)
    batch["lengths"][1] = t * 4 // 5
    batch["audio"][1, :, t * 4 // 5 :] = 0.0
    runs = {}
    for name, dtype, plain in (("plain_fp32", "float32", True), ("plain_bf16", "bfloat16", True),
                               ("kernel_bf16", "bfloat16", False)):
        task = task32.replace(compute_dtype=dtype)
        state = gan.create_train_state(task, SEED, dev)
        state.generator.load_state_dict(bigvgan.random_state_dict(task.generator, SEED))
        start = gan.draw_crop_start(state, task, t)
        step = gan.make_train_step(task, plain=plain)
        if plain:
            metrics = step(state, batch, start)
        else:
            metrics = drive_path("train_step_bigvgan_bf16", lambda: step(state, batch, start), ("aa_snake",), paths,
                                 len(task.generator.upsample_rates))
        masters = all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in state.generator.parameters())
        runs[name] = ({k: float(v) for k, v in metrics.items()},
                      {n: p.grad.detach().clone() for n, p in state.generator.named_parameters()}, masters, start)
        del state
        torch.cuda.empty_cache()
    floor = step_distance(runs["plain_bf16"][:2], runs["plain_fp32"][:2])
    dist = step_distance(runs["kernel_bf16"][:2], runs["plain_bf16"][:2])
    bound = {"losses": min(2 * floor["losses"], BF16_LOSS_CAP), "gradients": min(2 * floor["gradients"], BF16_GRAD_CAP)}
    launches = paths["train_step_bigvgan_bf16"]
    ok = (all(dist[k] <= bound[k] for k in bound)
          and launches["aa_snake"] == launches["aa_snake_bwd"] == K1_PER_BIGVGAN_FORWARD
          and all(r[2] for r in runs.values()) and len({r[3] for r in runs.values()}) == 1
          and all(math.isfinite(v) for r in runs.values() for v in r[0].values()))
    rec = {"phase": "train_step_check_bf16", "model": "bigvgan", "batch": TRAIN_CHECK_BATCH, "samples": t,
           "kernel_vs_plain_bf16": dist, "plain_bf16_vs_plain_fp32": floor, "bound": bound,
           "metrics_kernel_bf16": runs["kernel_bf16"][0], "metrics_plain_bf16": runs["plain_bf16"][0],
           "launches": launches, "masters_fp32": all(r[2] for r in runs.values()), "ok": ok}
    log(rec)
    if not ok:
        raise SystemExit("bigvgan bf16: the training step with the kernels is farther from the plain bf16 step "
                         "than the rule allows, or K1 or its backward did not run 91 times")
    return rec


def check_k1_autograd_bf16(dev) -> dict:
    """24. K1's bf16 route under autograd at the K1 autograd shapes: bf16 x, alpha and beta cast from fp32
    leaves (as bf16 training casts them), dx, d alpha and d beta at the leaves against autograd through the
    plain version on the same bf16 inputs, within twice the plain bf16 gradients' distance from the plain
    fp32 ones (capped at BF16_GRAD_CAP); the worst of each."""
    import numpy as np
    import torch

    from vocoder_tpu_torch.ops.aa_snake import aa_snake
    from vocoder_tpu_torch.ops.antialias import aa_snake_plain, snake_params

    rng = np.random.default_rng(SEED + 24)
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    worst = {"dx": 0.0, "d_alpha": 0.0, "d_beta": 0.0}
    ratio = dict(worst)
    for c, t, b in K1_AUTOGRAD_SHAPES:
        leaves = [torch.tensor(0.3 * rng.standard_normal(c), dtype=torch.float32, device=dev, requires_grad=True)
                  for _ in range(2)]
        x32 = torch.randn(b, c, t, device=dev, generator=gen).requires_grad_(True)
        gz = torch.randn(b, c, t, device=dev, generator=gen)

        def grads(fn, dtype):
            z = fn(x32.to(dtype), *(p.to(dtype) for p in leaves))
            return z.dtype, torch.autograd.grad(z, (x32, *leaves), gz.to(dtype))

        def plain(x, a, be):
            return aa_snake_plain(x, *snake_params(a, be, True))

        before = aa_snake.launches
        zdt, got = grads(lambda x, a, be: aa_snake(x, a, be, True), torch.bfloat16)
        launched = aa_snake.launches - before
        _, want = grads(plain, torch.bfloat16)
        _, want32 = grads(plain, torch.float32)
        rec = {}
        ok = launched == 1 and zdt == torch.bfloat16
        for name, g, w, w32 in zip(worst, got, want, want32):
            d, f = rel_l2(g, w), rel_l2(w, w32)
            rec[name] = {"kernel_vs_plain_bf16": d, "plain_bf16_vs_fp32": f}
            ok = ok and d <= min(2 * f, BF16_GRAD_CAP) and bool(torch.isfinite(g).all())
            worst[name] = max(worst[name], d)
            ratio[name] = max(ratio[name], d / max(f, 1e-30))
        log({"phase": "k1_autograd_check_bf16", "shape": [b, c, t], **rec, "ok": ok})
        if not ok:
            raise SystemExit(f"K1's bf16 route under autograd disagrees with its plain version at {(b, c, t)}")
        del x32, gz, got, want, want32
    log({"phase": "k1_autograd_bf16_worst", "rel_l2": worst,
         "worst_share_of_2x_floor": {k: v / 2 for k, v in ratio.items()}})
    return worst


def check_checkpointing(dev, paths: dict, stamp: dict) -> dict:
    """25. One fp32 BigVGAN step at the preset's b16 x 65,536 samples with checkpointing=True against the
    same step without it (same weights, batch and crop; both through K1): losses within CKPT_LOSS_REL, each
    generator gradient within CKPT_GRAD_REL_L2; K1's launches per step (91 and 91 + 90), its backward's (91
    in each) and the peak memory of each step."""
    import dataclasses

    import torch

    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models import bigvgan
    from vocoder_tpu_torch.tools.profile_train import synthetic_batch
    from vocoder_tpu_torch.train import gan

    tf32_off()
    base = build_task_config("bigvgan", "44100_512_2048")
    t = base.hop_length * base.num_frames
    batch = synthetic_batch(16, t, base.sampling_rate, SEED, dev)
    runs = {}
    for remat in (False, True):
        task = base.replace(generator=dataclasses.replace(base.generator, checkpointing=remat))
        state = gan.create_train_state(task, SEED, dev)
        state.generator.load_state_dict(bigvgan.random_state_dict(task.generator, SEED))
        start = gan.draw_crop_start(state, task, t)
        step = gan.make_train_step(task)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        name = f"train_step_bigvgan_{'checkpointed' if remat else 'b16'}"
        metrics = drive_path(name, lambda: step(state, batch, start), ("aa_snake",), paths,
                             len(task.generator.upsample_rates))
        peak = torch.cuda.max_memory_allocated()
        runs[remat] = ({k: float(v) for k, v in metrics.items()},
                       {n: p.grad.detach().clone() for n, p in state.generator.named_parameters()}, peak,
                       (paths[name]["aa_snake"], paths[name]["aa_snake_bwd"]))
        del state
        torch.cuda.empty_cache()
    (m0, g0, peak0, k0), (m1, g1, peak1, k1) = runs[False], runs[True]
    loss_rel = {k: rel(m1[k], m0[k]) for k in bf16_loss_keys(m0)}
    grad_rel = {n: rel_l2(g1[n], g0[n]) for n in g0}
    worst = max(grad_rel, key=grad_rel.get)
    ok = (max(loss_rel.values()) <= CKPT_LOSS_REL and grad_rel[worst] <= CKPT_GRAD_REL_L2
          and (k0[0], k1[0]) == (K1_PER_BIGVGAN_FORWARD, K1_PER_BIGVGAN_FORWARD + K1_RECOMPUTED_PER_STEP)
          and k0[1] == k1[1] == K1_PER_BIGVGAN_FORWARD)
    rec = {"phase": "checkpointing_check", "model": "bigvgan", "batch": 16, "samples": t, "dtype": "fp32",
           "max_loss_rel": max(loss_rel.values()), "max_grad_rel_l2": grad_rel[worst], "worst_grad": worst,
           "k1_launches_per_step": {"without": k0[0], "with": k1[0]},
           "k1_bwd_calls_per_step": {"without": k0[1], "with": k1[1]},
           "peak_memory_bytes": {"without": peak0, "with": peak1}, "peak_ratio": peak1 / peak0,
           "limits": {"loss_rel": CKPT_LOSS_REL, "grad_rel_l2": CKPT_GRAD_REL_L2}, "ok": ok, **stamp}
    log(rec)
    if not ok:
        raise SystemExit("checkpointing: the checkpointed step disagrees with the step without it, or K1's "
                         "launches are not 91 and 181, or its backward's not 91 in each")
    return rec


def time_train_step_bf16(dev, stamp: dict) -> dict:
    """26. The BigVGAN preset's step at b16 x 65,536 samples by phase, its rate, peak memory and card-time
    shares (tools/profile_train.py) in bf16, TF32 off (the checkpointed fp32 step's stand in PERF.md; phase
    25 holds checkpointing's memory and launches)."""
    import torch

    from vocoder_tpu_torch.tools.profile_train import measure_step, training_setup
    from vocoder_tpu_torch.train import gan

    tf32_off()
    task, state, batch = training_setup("bigvgan", 16, SEED, dev, compute_dtype="bfloat16")
    rec = {"metric": "train_step_ms", "model": "bigvgan", "batch": 16, "samples": task.hop_length * task.num_frames,
           "dtype": "bf16", "checkpointing": False,
           **measure_step(state, gan.make_train_step(task), batch, task, TIMED_STEPS), **stamp}
    log(rec)
    del state
    torch.cuda.empty_cache()
    return rec


def check_cli_train_bf16(root: Path, paths: dict, stamp: dict) -> float:
    """27. cli.train --model bigvgan task.compute_dtype=bfloat16 at the preset's b16 x 128 frames over phase
    21's LibriTTS-length FLAC corpus, 6 steps logged one by one, the default validation (PESQ) at steps 3
    and 6: steps 3-6 by time, perf/input_wait_s through the prefetcher, K1 and K2's bf16 route launched.
    Each validation's first fake is held, inside the run, to the plain bf16 eval of the same weights
    (rel L2 <= GEN_BF16_REL_L2): the weights change between the two, so a stale K2 plan would show.
    The median of steps 3-6 in seconds."""
    import numpy as np
    import torch

    from vocoder_tpu_torch.config import build_train_config
    from vocoder_tpu_torch.train import gan, trainer

    work = root / "run_bf16"
    steps = 6
    argv = ["--model", "bigvgan", "--device", "cuda", f"data.train_roots=('{root / 'train'}',)",
            f"data.val_root={root / 'val'}", "run.log_interval=1", "run.val_interval=3", f"run.ckpt_interval={steps}",
            f"run.max_steps={steps}", f"run.workdir={work}", "task.compute_dtype=bfloat16"]
    checks = []
    validate = trainer.validate

    def checked(state, eval_fn, val_batches, pesq_fn, device):
        scalars, first = validate(state, eval_fn, val_batches, pesq_fn, device)
        vb = trainer.to_device(first[1], device)
        with torch.no_grad():
            copy = gan.eval_generator(state.generator, task).eval()
            mask = gan.sequence_mask(vb["lengths"], vb["audio"].shape[2])
            want = (gan.generator_forward(copy, vb["audio"], task, plain=True)[0] * mask).cpu().numpy()
        got = first[0]
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        checks.append({"step": state.step, "rel_l2_vs_plain_bf16": err, "fake": got})
        return scalars, first

    task = build_train_config("bigvgan", overrides=["task.compute_dtype=bfloat16"]).task
    trainer.validate = checked
    tf32_defaults()
    try:
        state, _ = drive_path("cli_train_bf16", lambda: run_train_cli(argv), ("aa_snake", BF16_K2), paths,
                              blockwise=steps * len(task.generator.upsample_rates))
    finally:
        trainer.validate = validate
    launches = paths["cli_train_bf16"]
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    train_rec = [r for r in records if "train/generator/all" in r]
    val_rec = [r for r in records if "val/metrics/mel" in r]
    step_s = [1.0 / r["perf/steps_per_s"] for r in train_rec]
    wait_s = [r.get("perf/input_wait_s") for r in train_rec]
    moved = (float(np.linalg.norm(checks[1]["fake"] - checks[0]["fake"]) / np.linalg.norm(checks[0]["fake"]))
             if len(checks) == 2 else 0.0)
    errs = [c["rel_l2_vs_plain_bf16"] for c in checks]
    ok = (state.step == steps and [c["step"] for c in checks] == [3, 6] and all(e <= GEN_BF16_REL_L2 for e in errs)
          and moved > 10 * max(errs) and launches["aa_snake"] >= K1_PER_BIGVGAN_FORWARD * steps
          and launches[BF16_K2] > 0 and launches[FP32_K2] == 0 and len(val_rec) == 2
          and all(math.isfinite(v) for r in records for v in r.values())
          and all(p.dtype == torch.float32 for p in state.generator.parameters()))
    log({"phase": "cli_train_bf16", "model": "bigvgan", "batch": 16, "frames": 128, "steps": steps,
         "launches": launches, "logged_steps": [r["step"] for r in train_rec], "step_s": step_s, "input_wait_s": wait_s,
         "step_s_median_3_on": float(np.median(step_s[1:])), "input_wait_s_median_3_on": float(np.median(wait_s[1:])),
         "validations": [{k: v for k, v in c.items() if k != "fake"} for c in checks],
         "val_moved_rel_l2": moved, "val_pesq": [r.get("val/metrics/pesq") for r in val_rec],
         "val_forward_s": [r.get("perf/val_forward_s") for r in val_rec], "limit": GEN_BF16_REL_L2, "ok": ok, **stamp})
    if not ok:
        raise SystemExit("cli.train in bf16: the run did not train through K1 and validate through K2's bf16 route "
                         "on the weights it had, or a validation disagrees with the plain bf16 eval")
    return float(np.median(step_s[1:]))


def check_profile_steps(root: Path, paths: dict) -> None:
    """28. cli.train in bf16 with run.profile_steps=(2,3) over the same corpus, 3 steps and no validation:
    the Chrome trace of the third step under <workdir>/profile/ exists and names K1's kernel."""
    from vocoder_tpu_torch.config import build_task_config

    work = root / "run_profile"
    steps = 3
    argv = ["--model", "bigvgan", "--device", "cuda", f"data.train_roots=('{root / 'train'}',)",
            "run.log_interval=1", f"run.max_steps={steps}", f"run.ckpt_interval={steps}", f"run.workdir={work}",
            "task.compute_dtype=bfloat16", "run.profile_steps=(2,3)"]
    tf32_defaults()
    stages = len(build_task_config("bigvgan").generator.upsample_rates)
    _, text = drive_path("cli_train_profile", lambda: run_train_cli(argv), ("aa_snake",), paths,
                         blockwise=steps * stages)
    trace = work / "profile" / "trace_2_3.json"
    body = trace.read_text() if trace.is_file() else ""
    ok = bool(body) and "aa_snake_kernel" in body and str(trace) in text
    log({"phase": "profile_steps", "trace": trace.name, "trace_bytes": len(body),
         "names_k1": "aa_snake_kernel" in body, "k1_events": body.count("aa_snake_kernel"),
         "launches": paths["cli_train_profile"], "ok": ok})
    if not ok:
        raise SystemExit("run.profile_steps did not write a trace that names K1's kernel")


def run_bench_train(stamp: dict) -> list:
    """29. cli.bench_train for BigVGAN in bf16 and HiFiGAN in bf16 and fp32 at b16, with --memory-stats, as a smoke of
    the CLI: --iters 1 (a warm-up step, one timed step, one generator phase); phases 13 and 26 time
    BigVGAN's steps over more."""
    import contextlib
    import io

    from vocoder_tpu_torch.cli import bench_train

    out = []
    for model, dtype in (("bigvgan", "bfloat16"), ("hifigan", "bfloat16"), ("hifigan", "float32")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench_train.main(["--model", model, "--batch", "16", "--compute-dtype", dtype, "--iters", "1",
                              "--memory-stats"])
        lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
        step = next(r for r in lines if r["metric"] == "gan_train_step")
        mem = next(r for r in lines if r["metric"] == "hbm_stats")
        rec = {"phase": "bench_train", **step, "max_memory_allocated": mem["max_memory_allocated"],
               "hbm_stats_keys": len(mem), "ok": step["backend"] == "cuda" and step["total_ms"] > 0, **stamp}
        log(rec)
        out.append(rec)
        if not rec["ok"]:
            raise SystemExit(f"cli.bench_train --model {model} --compute-dtype {dtype} failed")
    return out


def run_bench_input(root: Path, step_s: float, stamp: dict) -> list:
    """30. cli.bench_input --prefetch over phase 21's LibriTTS-length FLAC corpus at b16 x 128 frames, 1 and 4
    workers, the consumer holding each batch for the bf16 run's step time: host batches/s, and through
    DevicePrefetcher onto the card the wait a batch."""
    import contextlib
    import io

    from vocoder_tpu_torch.cli import bench_input

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recs = bench_input.main(["--corpus", str(root / "train"), "--workers", "1,4", "--batch", "16",
                                 "--batches", "2", "--prefetch", "--device", "cuda", "--step-ms", str(1e3 * step_s)])
    out = []
    for r in recs:
        rec = {"phase": "bench_input", **r, "ok": r["batch_on_device"].startswith("cuda") and r["value"] > 0, **stamp}
        log(rec)
        out.append(rec)
        if not rec["ok"]:
            raise SystemExit("cli.bench_input --prefetch did not deliver batches to the card")
    return out


def time_native_resample(stamp: dict) -> dict:
    """The host library's resample (csrc/audio_host.cc resample_poly) against the numpy path on this host:
    RESAMPLE_SECONDS of 44.1 kHz audio to 16 kHz (validation PESQ's and cli.evaluate's path), the best of
    three calls each, equal within the parity test's rtol 1e-4 / atol 1e-5, counted in native.resamples,
    and faster than numpy (1-D audio takes the native path only because it is)."""
    import numpy as np

    from vocoder_tpu_torch.data import native, resample

    x = tone(44100, RESAMPLE_SECONDS, np.random.default_rng(SEED + 30))[0]
    resample.resample(x, 44100, 16000)  # warm: the kernel table

    def best(signal):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = resample.resample(signal, 44100, 16000)
            times.append(time.perf_counter() - t0)
        return out, min(times)

    before = native.resamples
    got, native_s = best(x)
    counted = native.resamples - before
    want, numpy_s = best(x[None])  # 2-D: the numpy path
    ok = counted == 3 and bool(np.allclose(got, want[0], rtol=1e-4, atol=1e-5)) and native_s < numpy_s
    rec = {"phase": "native_resample", "audio_seconds": RESAMPLE_SECONDS, "native_s": native_s, "numpy_s": numpy_s,
           "speedup": numpy_s / native_s, "native_audio_s_per_s": RESAMPLE_SECONDS / native_s,
           "max_abs_diff": float(np.abs(got - want[0]).max()), "native_resamples": counted, "ok": ok, **stamp}
    log(rec)
    if not ok:
        raise SystemExit("the native resample disagrees with the numpy path, was not counted or is slower")
    return rec


# Phases 31-35: the ssl family (a HuBERT semantic codec) and cli.bench_infer.
SSL_RESOLUTION = "16000_640_2048"  # the ssl preset's 16 kHz and hop 640 (two HuBERT frames)
HUBERT_SAMPLES = 20480  # one training crop of the ssl preset (32 frames of 640): 63 HuBERT frames
# The backbone on the card against the CPU, fp32 with TF32 off: 7 convs, 12 post-LN layers and their attention
# summed in other orders (efficient attention's fp32 route on the card).
HUBERT_REL_L2 = 1e-4
BENCH_INFER_REL = 0.15  # cli.bench_infer against profile_forward's CUDA-event ms: same model, shape, dtype, run
BENCH_INFER_ITERS = 10
HOST_PACED = 0.95  # below this card-busy share of a forward, the host's launches pace it (in part)
HOST_PACED_ITERS = 40  # a host-paced forward's calls a timing: 0.3-0.9 s windows for Vocos
HOST_PACED_ROUNDS = 5  # timings of a host-paced forward by each method, in turn; their medians compared


def check_hubert(dev, stamp: dict) -> dict:
    """31. The full-width HuBERT (the random backbone of seed 0 that cli.train and cli.codec build) on the card
    against the same weights on the CPU, b2 x HUBERT_SAMPLES, from PyTorch's default TF32 flags (the extractor
    turns TF32 off for the call and restores the flags): rel L2 and max relative error; then the card's ms a
    b16 batch (CUDA events) and audio-s/s.  -> {device: extractor} for phases 32 and 34."""
    import torch

    from vocoder_tpu_torch.models.ssl_encoders import HubertEncoderConfig, HubertFeatureExtractor
    from vocoder_tpu_torch.tools.profile_train import synthetic_batch
    from vocoder_tpu_torch.tools.timing import cuda_ms

    cfg = HubertEncoderConfig()
    extractors = {"cpu": HubertFeatureExtractor(cfg, "cpu"), str(dev): HubertFeatureExtractor(cfg, dev)}
    card = extractors[str(dev)]
    audio = synthetic_batch(2, HUBERT_SAMPLES, 16000, SEED + 31, "cpu")["audio"][:, 0]
    tf32_defaults()
    got = card(audio.to(dev)).cpu()
    flags_restored = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, False)
    want = extractors["cpu"](audio)
    err = rel_l2(got, want)
    max_rel = float((got - want).abs().max() / want.abs().max())
    ok = (err <= HUBERT_REL_L2 and tuple(got.shape) == (2, 63, 768) and bool(torch.isfinite(got).all())
          and flags_restored and got.dtype == torch.float32)
    log({"phase": "hubert_card_vs_cpu", "shape": list(got.shape), "rel_l2": err, "max_rel_err": max_rel,
         "max_abs_err": float((got - want).abs().max()), "limit_rel_l2": HUBERT_REL_L2,
         "tf32_flags_restored": flags_restored, "params": sum(p.numel() for p in card.model.parameters()), "ok": ok})
    if not ok:
        raise SystemExit("HuBERT on the card disagrees with the CPU, or left the TF32 flags changed")
    x16 = synthetic_batch(16, HUBERT_SAMPLES, 16000, SEED + 31, dev)["audio"][:, 0]
    ms = cuda_ms(lambda: card(x16), 5)
    tf32_off()
    log({"metric": "hubert_ms", "batch": 16, "samples": HUBERT_SAMPLES, "frames": 63, "dtype": "fp32", "ms": ms,
         "audio_s_per_s": 16 * HUBERT_SAMPLES / 16000 / (ms / 1e3), **stamp})
    return extractors


def check_ssl_step_cpu(dev, extractors: dict, paths: dict) -> dict:
    """32. One ssl training step at the 16 kHz preset's full width and depth (a 768 -> 512 post-net, a 4,096 x
    512 codebook fitted to the batch's latents, the 512-channel decoder at hop 640), b2 x 20,480 samples (the
    second 4/5 long), TF32 off, on the card and on the CPU from the same weights, features (the CPU backbone's)
    and draws: phase 17's rules (``step_card_vs_cpu``)."""
    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models.vae import SSLCodecGenerator, ssl_random_state_dict
    from vocoder_tpu_torch.tools.profile_train import synthetic_batch

    tf32_off()
    task = build_task_config(family="ssl", resolution=SSL_RESOLUTION)
    t = task.hop_length * task.num_frames
    batch = synthetic_batch(TRAIN_CHECK_BATCH, t, task.sampling_rate, SEED, "cpu")
    batch["lengths"][1] = t * 4 // 5
    batch["audio"][1, :, t * 4 // 5:] = 0.0
    batch["ssl_features"] = extractors["cpu"](batch["audio"][:, 0])
    m = SSLCodecGenerator(task.generator)
    m.load_state_dict(ssl_random_state_dict(task.generator, SEED))
    fit_codebook(m, batch["ssl_features"], SEED)
    return step_card_vs_cpu("ssl", task, batch, m.state_dict(), dev, paths)


def check_bench_infer(dev, stamp: dict) -> list:
    """35. cli.bench_infer for BigVGAN, HiFiGAN and Vocos at b16 x 256 frames in bf16 and fp32, BENCH_INFER_ITERS
    calls each, against profile_forward's generator ms (CUDA events over as many forwards of the same model,
    shape and dtype, as that tool builds it: ``build``, ``inputs``, ``profile``; the bf16 model a cast copy of
    the fp32 one, which is what ``build`` makes): within BENCH_INFER_REL.  The
    host paces Vocos (the card 42-79% busy in bf16, 80-92% in fp32): on the H100 machine its bf16 ms moved
    between 6.2 and 16.4 from one timing to the next by either method, also over 40 calls (the tool's six
    timings in one run: 6.9, 10.4, 16.4, 9.2, 10.2 and 7.9 ms), and its fp32 tool and CLI figures lay 9.3%
    apart.  So the tool is timed first (``profile``, which also finds the card's busy share), and a forward it
    finds the host pacing (the card busy under HOST_PACED of the time) is timed HOST_PACED_ROUNDS times more by
    each, CLI and tool (``forward_ms``, ``profile``'s timing without its trace) in turn, over HOST_PACED_ITERS
    calls, and the medians are compared.  Each timing runs with the garbage collector run before it and off
    during it, and the collections that ran anyway are counted."""
    import contextlib
    import gc
    import io
    import statistics

    import torch

    from vocoder_tpu_torch.cli import bench_infer
    from vocoder_tpu_torch.tools.profile_forward import build, forward_ms, inputs, profile

    def collector_off(fn, counts: list):
        """fn() with the collector run before it and off during it; the collections that ran appended."""
        gc.collect()
        before = sum(s["collections"] for s in gc.get_stats())
        gc.disable()
        try:
            result = fn()
        finally:
            gc.enable()
        counts.append(sum(s["collections"] for s in gc.get_stats()) - before)
        return result

    tf32_off()
    out = []
    for model in ("bigvgan", "hifigan", "vocos"):
        task, _, m32 = build(model, torch.float32)  # the tool's model; in bf16 a cast copy, as build casts
        for dtype in ("bfloat16", "float32"):
            torch_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
            collections = []

            def cli(iters: int) -> dict:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rec = collector_off(lambda: bench_infer.main(
                        ["--model", model, "--batch", "16", "--frames", str(F_FRAMES), "--dtype", dtype, "--iters",
                         str(iters)]), collections)
                lines = [x for x in buf.getvalue().splitlines() if x.startswith("{")]
                return {**rec, "one_json_line": len(lines) == 1 and json.loads(lines[0]) == rec}

            m = m32 if dtype == "float32" else copy.deepcopy(m32).to(torch_dtype)
            kw = inputs(task, 16, F_FRAMES, torch_dtype)
            pfs = [collector_off(lambda: profile(m, kw, BENCH_INFER_ITERS), collections)]
            busy = pfs[0]["busy_share"]
            if busy >= HOST_PACED:
                clis = [cli(BENCH_INFER_ITERS)]
            else:
                clis, pfs = [], []
                for _ in range(HOST_PACED_ROUNDS):
                    clis.append(cli(HOST_PACED_ITERS))
                    pfs.append({"ms": collector_off(lambda: forward_ms(m, kw, HOST_PACED_ITERS), collections)})
            last = clis[-1]
            cli_ms = statistics.median(c["ms_per_call"] for c in clis)
            pf_ms = statistics.median(p["ms"] for p in pfs)
            gap = abs(cli_ms - pf_ms) / pf_ms
            ok = (all(c["one_json_line"] for c in clis) and last["backend"] == "cuda" and gap <= BENCH_INFER_REL)
            audio_s = 16 * F_FRAMES * task.hop_length / task.sampling_rate
            r = {"phase": "bench_infer", **last, "ms_per_call": cli_ms,
                 "audio_s_per_s_per_chip": audio_s / cli_ms * 1e3, "calls": len(clis),
                 "cli_ms_runs": [c["ms_per_call"] for c in clis], "profile_forward_ms": pf_ms,
                 "profile_forward_ms_runs": [p["ms"] for p in pfs], "profile_forward_busy_share": busy,
                 "gc_collections_in_timings": collections, "rel_gap": gap, "limit": BENCH_INFER_REL, "ok": ok,
                 **stamp}
            log(r)
            out.append(r)
            if not ok:
                raise SystemExit(f"cli.bench_infer --model {model} --dtype {dtype} disagrees with profile_forward")
            del m, kw
        del m32
        torch.cuda.empty_cache()
    return out


# 36-38: data parallelism.  Phase 36's run and phase 12's take the same branches (one rank: every share is
# the whole), so only cuDNN's run-to-run sums can part them; phase 37's ranks take b2 where one process takes
# b4, so cuDNN may pick other algorithms, and the sums run in another order.
DP_CLI_REL = 1e-4  # each logged loss, grad norm and validation figure of the torchrun run against phase 12's
DP_RANKS, DP_STEP_BATCH = 2, 4
DP_LOSS_REL, DP_NORM_REL, DP_GRAD_REL_L2 = 1e-5, 1e-4, 1e-4
DP_TIMEOUT = 600  # seconds a phase's child processes may take


def child_env() -> dict:
    """The environment of a child process that imports the port from this checkout."""
    root = str(Path(__file__).resolve().parent)
    return dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))


def start_torchrun(args: list[str]) -> subprocess.Popen:
    """``torchrun --standalone --nproc_per_node 1 -m <args>`` from this checkout, started, its output going to
    two temporary files (``proc.logs``) that no pipe's buffer can fill while it runs."""
    logs = (tempfile.TemporaryFile(mode="w+"), tempfile.TemporaryFile(mode="w+"))
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                             "-m", *args], stdout=logs[0], stderr=logs[1], text=True, env=child_env(),
                            cwd=Path(__file__).resolve().parent)
    proc.logs = logs
    return proc


def finish(proc: subprocess.Popen) -> tuple[str, str]:
    """A started child's (stdout, stderr) once it ended within DP_TIMEOUT (echoed); killed past it."""
    try:
        proc.wait(timeout=DP_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    texts = []
    for f in proc.logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    print(texts[0][-6000:], texts[1][-6000:], sep="", end="", flush=True)
    return texts[0], texts[1]


def start_cli_train_torchrun(root: Path, one_process: dict) -> tuple:
    """36's child, started: ``torchrun --standalone --nproc_per_node 1 -m vocoder_tpu_torch.cli.train`` with phase
    12's first run's arguments over its corpus.  -> (the process, its start time)."""
    argv = ["vocoder_tpu_torch.cli.train", *one_process["argv"], f"run.workdir={root / 'torchrun'}"]
    return start_torchrun(argv), time.perf_counter()


def check_cli_train_torchrun(started: tuple, root: Path, one_process: dict, paths: dict, stamp: dict) -> dict:
    """36. ``torchrun --standalone --nproc_per_node 1 -m vocoder_tpu_torch.cli.train`` (NCCL at world size 1)
    with phase 12's first run's arguments (BigVGAN at full width, b16 x 128 frames, 3 steps, a validation at
    2) over its corpus: the same metrics.jsonl records as that one-process run, every loss, grad norm and
    validation figure within DP_CLI_REL; the child's log names NCCL and counts K1 and K2's fp32 route launched
    (its last line, ``ops.launch_counts``).  ``started``: ``start_cli_train_torchrun``'s."""
    proc, t0 = started
    _, err = finish(proc)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"torchrun cli.train exited {proc.returncode}")
    tagged = [ln.split("kernel launches: ", 1)[1] for ln in err.splitlines() if "kernel launches: " in ln]
    counts = json.loads(tagged[-1]) if tagged else {}
    paths["cli_train_torchrun"] = {k: counts.get(k, 0) for k in ("aa_snake", "aa_snake_bwd", FP32_K2, BF16_K2)}
    runs = [one_process["records"],
            [json.loads(ln) for ln in (root / "torchrun" / "metrics.jsonl").read_text().splitlines()]]
    shape = [[(r["step"], sorted(r)) for r in recs] for recs in runs]
    rels = {f"{a['step']}:{k}": rel(b[k], a[k]) for a, b in zip(*runs) for k in a
            if k != "step" and not k.startswith("perf/") and k in b}
    worst = max(rels, key=rels.get) if rels else None
    nccl = "processes (nccl)" in err
    ok = (shape[0] == shape[1] and any("val/metrics/mel" in r for r in runs[1]) and worst is not None
          and rels[worst] <= DP_CLI_REL and nccl and paths["cli_train_torchrun"]["aa_snake"] > 0
          and paths["cli_train_torchrun"][FP32_K2] > 0)
    rec = {"phase": "cli_train_torchrun", "model": "bigvgan", "batch": 16, "world_size": 1,
           "backend": "nccl" if nccl else None, "max_rel": rels.get(worst), "worst": worst, "compared": len(rels),
           "limit": DP_CLI_REL, "launches": paths["cli_train_torchrun"], "seconds": seconds, "records": runs[1],
           "ok": ok, **stamp}
    log(rec)
    if not ok:
        raise SystemExit("torchrun's cli.train (NCCL, one rank) differs from one process or skipped a kernel")
    return rec


def _dp_rank(rank: int, port: int, out: str) -> None:
    """37, one of DP_RANKS processes sharing the one card over gloo: BigVGAN's step at full width on its
    rows of a b4 batch (K1 under autograd; counts kept), then the weights gathered to show that the ranks
    agree; rank 0 then takes one process's step on the whole batch and compares.  Writes rank<r>.json."""
    os.environ.update(RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE=str(DP_RANKS), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch

    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models.bigvgan import random_state_dict
    from vocoder_tpu_torch.ops import launch_counts
    from vocoder_tpu_torch.ops.aa_snake import aa_snake
    from vocoder_tpu_torch.ops.amp_block import amp_stage
    from vocoder_tpu_torch.parallel import dist
    from vocoder_tpu_torch.tools.profile_train import synthetic_batch
    from vocoder_tpu_torch.train import gan

    dev = dist.init_from_env("cuda", backend="gloo")
    tf32_off()
    task = build_task_config("bigvgan", "44100_512_2048")
    t = task.hop_length * task.num_frames
    full = synthetic_batch(DP_STEP_BATCH, t, task.sampling_rate, SEED, dev)
    full["lengths"][1] = t * 4 // 5
    full["audio"][1, :, t * 4 // 5 :] = 0.0
    b = DP_STEP_BATCH // DP_RANKS
    mine = {k: v[rank * b : (rank + 1) * b] for k, v in full.items()}

    def fresh():
        state = gan.create_train_state(task, SEED, dev)
        state.generator.load_state_dict(random_state_dict(task.generator, SEED))
        return state

    def named(state):
        return [(f"{m}.{n}", p) for m, mod in (("generator", state.generator), ("discriminators", state.discriminators))
                for n, p in mod.named_parameters()]

    state = fresh()
    dist.broadcast_modules([state.generator, state.discriminators], dist.world_group())
    old = {n: p.detach().clone() for n, p in named(state)} if rank == 0 else None
    start = gan.draw_crop_start(state, task, t)
    aa_snake.launches = aa_snake.bwd_launches = amp_stage.launches = amp_stage.mma_launches = 0
    metrics = {k: float(v) for k, v in gan.make_train_step(task, group=dist.world_group())(state, mine, start).items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    sums = torch.stack([p.detach().double().sum() for _, p in named(state)]).cpu()
    gathered = [torch.zeros_like(sums) for _ in range(DP_RANKS)]
    torch.distributed.all_gather(gathered, sums)
    rec = {"rank": rank, "launches": counts, "metrics": metrics, "crop_start": start,
           "ranks_agree": all(torch.equal(g, gathered[0]) for g in gathered)}
    if rank == 0:
        grads = {n: p.grad.detach().clone() for n, p in named(state) if p.grad is not None}
        new = {n: p.detach().clone() for n, p in named(state)}
        del state
        torch.cuda.empty_cache()
        ref = fresh()
        ref_start = gan.draw_crop_start(ref, task, t)
        want = {k: float(v) for k, v in gan.make_train_step(task)(ref, full, ref_start).items()}
        norms = [k for k in want if "grad_norm" in k]
        losses = [k for k in want if k not in norms and k != "lr"]
        ref_params = dict(named(ref))
        grad_rel = {n: rel_l2(g, ref_params[n].grad) for n, g in grads.items()}
        worst = max(grad_rel, key=grad_rel.get)
        params_ok = all(adam_step_close(new[n], ref_params[n].detach(), old[n], ref_params[n].grad,
                                        float((g - ref_params[n].grad).abs().max()), want["lr"], task.weight_decay)
                        for n, g in grads.items())
        rec.update(compared={
            "same_crop_start": ref_start == start, "loss_rel": {k: rel(metrics[k], want[k]) for k in losses},
            "grad_norm_rel": {k: rel(metrics[k], want[k]) for k in norms}, "max_grad_rel_l2": grad_rel[worst],
            "worst_grad": worst, "grad_tensors": len(grad_rel), "params_adam_close": params_ok,
            "metrics_one_process": want})
    state = ref = None  # the data-parallel step's states go before the tensor-parallel part
    torch.cuda.empty_cache()
    rec["tp"] = _tp_rank(rank, dev, {k: v[:TP_STEP_BATCH] for k, v in full.items()})
    Path(out, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.close()


# 37 (tensor parallelism): the same two gloo children, after their data-parallel step, form one model group
# and hold each full-width model in two shards against one process on the card.  The sharded forwards and
# step differ from one process only in the order of sums (row-parallel partial sums, a row-parallel weight
# norm); K2 takes the whole gathered stage, as one process does.
TP_BATCH, TP_STEP_BATCH = 4, 2
TP_FRAMES = (256, 200, 129, 64)  # the masked forward's lengths
TP_GEN_REL_L2 = GEN_FP32_REL_L2
# bf16: the row-parallel upsamples' partial sums are each rounded to bf16 before the group adds them (as GSPMD's
# partial sums of a bf16 conv are), one more rounding than one process makes; its effect through the stages is
# of the order of the run's plain-vs-plain floor, so the limit is twice that floor (phases 23 and 24's rule for a
# bf16 path against its floor), at least GEN_BF16_REL_L2 and at most GEN_BF16_CAP.
TP_BF16_FLOORS = 2
TP_LOSS_REL, TP_NORM_REL, TP_GRAD_REL_L2 = 1e-5, 1e-4, 1e-4
# The weights after AdamW: Adam's first step moves an element by lr * g / (|g| + eps), so where g lies near 0 a
# last-bit difference in g moves it by up to 2 lr; the weights are held to Adam's first-step rule
# (``adam_step_close``: 1e-3 of the step where g is clear of 0, as phase 37's data-parallel check), and the
# largest absolute difference is reported beside TP_WEIGHT_ABS.
TP_WEIGHT_ABS = 1e-6
TP_SHARE = (0.50, 0.515)  # a rank's share of vocos-huge's parameter bytes


def _timed(fn):
    """(fn(), host ms around it, the card synchronised on both sides)."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    y = fn()
    torch.cuda.synchronize()
    return y, (time.perf_counter() - t) * 1e3


def _every_rank(y, mg) -> list:
    """Each rank's y in the model group, in rank order (all-gathered): rank 0 holds every rank's to the
    reference."""
    import torch
    import torch.distributed as tdist

    got = [torch.empty_like(y) for _ in range(mg.size)]
    tdist.all_gather(got, y.contiguous(), group=mg.group)
    return got


def _tp_bigvgan_forwards(mg, dev, rank: int) -> dict:
    """(a) BigVGAN at the preset (512 channels), folded, b4 x F_FRAMES: fp32 twice (the second reusing the
    gathered stage weights and K2's plans), fp32 with lengths (the masked K2), bf16; each with its K1 and K2
    launches, K2's plans packed and reused, and the gathered stages made; rank 0 then runs one process."""
    import torch

    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models import bigvgan
    from vocoder_tpu_torch.nn import fold_weight_norm
    from vocoder_tpu_torch.ops import launch_counts
    from vocoder_tpu_torch.ops.aa_snake import aa_snake
    from vocoder_tpu_torch.ops.amp_block import amp_stage, stage_plan
    from vocoder_tpu_torch.parallel import tp

    cfg = build_task_config("bigvgan", "44100_512_2048").generator
    sd = bigvgan.random_state_dict(cfg, SEED)

    def build(group):
        m = bigvgan.BigVGAN(cfg)
        m.load_state_dict(sd)
        tp.shard_module(fold_weight_norm(m), bigvgan.param_specs(cfg), group)
        return m.to(dev).eval()

    g = torch.Generator(device=dev).manual_seed(SEED + 37)
    mel = torch.randn(TP_BATCH, cfg.num_mels, F_FRAMES, device=dev, generator=g) - 5.0
    frames = torch.tensor(TP_FRAMES, device=dev)
    masked = mel * (torch.arange(F_FRAMES, device=dev)[None, :] < frames[:, None])[:, None, :]
    runs, out = {}, {}
    model = build(mg)  # outside inference mode: the caches key on the parameters' versions
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    with torch.inference_mode():
        cases = (("fp32", model, mel, {}), ("fp32_again", model, mel, {}),
                 ("fp32_masked", model, masked, {"frame_lengths": frames}), ("bf16", model_bf16, mel.bfloat16(), {}))
        for tag, m, x, kw in cases:
            before = (stage_plan.builds, stage_plan.hits, tp.whole_blocks.builds, tp.whole_blocks.hits)
            aa_snake.launches = aa_snake.bwd_launches = amp_stage.launches = amp_stage.mma_launches = 0
            y, ms = _timed(lambda: m(x, **kw))
            after = (stage_plan.builds, stage_plan.hits, tp.whole_blocks.builds, tp.whole_blocks.hits)
            runs[tag] = _every_rank(y, mg)
            out[tag] = {"launches": launch_counts(), "ms_2_gloo_ranks_on_one_card": ms,
                        **dict(zip(("k2_plans_packed", "k2_plans_reused", "gathered_stages_made", "gathered_stages_reused"),
                                   (a - b for a, b in zip(after, before))))}
    del model, model_bf16
    torch.cuda.empty_cache()
    if rank == 0:
        ref = build(None)
        ref_bf16 = copy.deepcopy(ref).to(torch.bfloat16)
        with torch.inference_mode():
            want = {"fp32": ref(mel)}
            want["fp32_again"] = want["fp32"]
            want["fp32_masked"] = ref(masked, frame_lengths=frames)
            want["bf16"], ms_one = _timed(lambda: ref_bf16(mel.bfloat16()))
            plain = ref_bf16.forward_plain(mel.bfloat16())
            torch.backends.cudnn.enabled = False
            plain_native = ref_bf16.forward_plain(mel.bfloat16())
            torch.backends.cudnn.enabled = True
            _, ms_fp32_one = _timed(lambda: ref(mel))
        out["one_process_ms"] = {"fp32": ms_fp32_one, "bf16": ms_one}
        out["bf16_plain_vs_plain_rel_l2"] = rel_l2(plain_native.float(), plain.float())
        for tag, ys in runs.items():
            out[tag]["rel_l2"] = max(rel_l2(y.float(), want[tag].float()) for y in ys)
            out[tag]["max_abs_err"] = max(float((y.float() - want[tag].float()).abs().max()) for y in ys)
            out[tag]["finite"] = all(bool(torch.isfinite(y).all()) for y in ys)
        hop = cfg.hop_length
        out["fp32_masked"]["zero_past_lengths"] = all(
            not y[i, :, n * hop :].any() for y in runs["fp32_masked"] for i, n in enumerate(TP_FRAMES))
        del ref, ref_bf16
        torch.cuda.empty_cache()
    return out


def _card_weights(model, seed: int, dev) -> None:
    """Vocos weights drawn on the card from ``seed`` (every rank draws the same): as
    ``vocos.random_state_dict`` scales them, without 650 M numpy draws on the host."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            n = torch.randn(p.shape, device=dev, generator=gen)
            if name.endswith("gamma"):
                p.copy_(0.1 * (1.0 + 0.1 * n))
            elif name == "head.out.weight":
                p.copy_(0.5 / math.sqrt(p.shape[1]) * n)
            elif p.dim() > 1:
                p.copy_(n / math.sqrt(math.prod(p.shape[1:])))
            elif name.endswith("weight"):  # LayerNorm
                p.copy_(1.0 + 0.1 * n)
            else:
                p.copy_(0.05 * n)


def _tp_library_forwards(mg, dev, rank: int) -> dict:
    """(b) vocos-huge (VocosConfig.huge(), 650 M) and (c) HiFiGAN at the preset, b4 x F_FRAMES, fp32: each
    rank's forward against one process's (rank 0, before it shards its copy), and each rank's share of
    vocos-huge's parameter bytes."""
    import torch

    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models import hifigan, vocos
    from vocoder_tpu_torch.nn import fold_weight_norm
    from vocoder_tpu_torch.parallel import tp

    out = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 38)
    mel = torch.randn(TP_BATCH, 128, F_FRAMES, device=dev, generator=g) - 5.0
    hcfg = build_task_config("hifigan", "44100_512_2048").generator
    hsd = hifigan.random_state_dict(hcfg, SEED)
    vcfg = vocos.VocosConfig.huge()
    for name, specs in (("vocos_huge", vocos.param_specs(vcfg)), ("hifigan", hifigan.param_specs(hcfg))):
        if name == "vocos_huge":
            model = vocos.Vocos(vcfg, device=dev)
            _card_weights(model, SEED, dev)
        else:
            model = hifigan.HiFiGAN(hcfg)
            model.load_state_dict(hsd)
            model = fold_weight_norm(model).to(dev)
        model.eval()
        whole = sum(p.numel() * p.element_size() for p in model.parameters())
        with torch.inference_mode():
            want, ms_one = _timed(lambda: model(mel)) if rank == 0 else (None, None)
        tp.shard_module(model, specs, mg)
        torch.distributed.barrier(group=mg.group)  # rank 1 waits out rank 0's reference before the timing
        with torch.inference_mode():
            y, ms = _timed(lambda: model(mel))
            ys = _every_rank(y, mg)
            held = sum(p.numel() * p.element_size() for p in model.parameters())
            rec = {"ms_2_gloo_ranks_on_one_card": ms, "one_process_ms": ms_one,
                   "param_bytes_whole": whole, "param_bytes_held": held, "param_share": held / whole}
            if rank == 0:
                rec.update(rel_l2=max(rel_l2(v, want) for v in ys), max_abs_err=max(float((v - want).abs().max()) for v in ys),
                           finite=all(bool(torch.isfinite(v).all()) for v in ys), shape=list(y.shape))
        out[name] = rec
        del model, y, ys, want
        torch.cuda.empty_cache()
    return out


def _held(state) -> dict:
    """The bytes a rank holds of each part of a training state, counted from its tensors: the generator's and
    the discriminators' parameters, their AdamW moments, and the codebook buffers."""
    from vocoder_tpu_torch.parallel import tp

    g, d = tp.held_bytes(state.generator, state.opt_g), tp.held_bytes(state.discriminators, state.opt_d)
    return {"generator": g["parameters"], "discriminators": d["parameters"], "opt_g": g["moments"],
            "opt_d": d["moments"], "buffers": g["buffers"]}


def _tp_train_step(mg, dev, rank: int, task, sd: dict, batch: dict) -> dict:
    """One training step of ``task`` on ``batch`` from the generator weights ``sd``, the state sharded over the
    model group (the generator by its specs or in storage shards, the discriminators in storage shards),
    against one process's step (rank 0) from the same weights and crop start: losses, grad norms, every
    gathered gradient, the gathered weights after AdamW and the gathered buffers (the EMA codebook); every rank's
    whole state after the step against rank 0's, bit for bit; the bytes each rank holds and one process holds."""
    import torch

    from vocoder_tpu_torch.ops import launch_counts
    from vocoder_tpu_torch.ops.aa_snake import aa_snake
    from vocoder_tpu_torch.ops.amp_block import amp_stage
    from vocoder_tpu_torch.parallel import tp
    from vocoder_tpu_torch.train import gan

    t = batch["audio"].shape[2]
    modules = ("generator", "discriminators")

    def fresh(group):
        state = gan.create_train_state(task, SEED, dev, group)
        state.generator.load_state_dict(tp.shard_state(state.generator, sd))
        return state

    def whole(state, with_grads: bool = True) -> tuple[dict, dict, dict]:
        """(every gradient, every weight, every buffer), whole."""
        grads, weights, buffers = {}, {}, {}
        for key in modules:
            m = getattr(state, key)
            names = {n for n, _ in m.named_parameters()}
            for n, v in tp.whole_state_dict(m).items():
                (weights if n in names else buffers)[f"{key}.{n}"] = v.detach().clone()
            if with_grads:
                grads.update({f"{key}.{n}": v for n, v in
                              tp.whole_state_dict(m, {n: p.grad for n, p in m.named_parameters()}).items()})
        return grads, weights, buffers

    def words(t) -> torch.Tensor:  # a tensor's bits: the sum of its 32-bit words, and weighted by position
        w = t.detach().contiguous().view(-1).view(torch.int32).long()
        return torch.stack([w.sum(), (w * torch.arange(1, w.numel() + 1, device=w.device)).sum()])

    def state_words(state, weights: dict, buffers: dict) -> torch.Tensor:
        """The bits of the whole state: every whole weight and buffer, and the AdamW moments of each parameter
        that the ranks hold whole (a sharded parameter's are this rank's shard)."""
        tensors = [*weights.values(), *buffers.values()]
        for opt, key in ((state.opt_g, "generator"), (state.opt_d, "discriminators")):
            m = getattr(state, key)
            sharded = getattr(m, "tp_params", {})
            for n, p in m.named_parameters():
                if n not in sharded:
                    tensors += [opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]]
        return torch.cat([words(t) for t in tensors])

    state = fresh(mg)
    start = gan.draw_crop_start(state, task, t)
    aa_snake.launches = aa_snake.bwd_launches = amp_stage.launches = amp_stage.mma_launches = 0
    metrics, ms = _timed(lambda: gan.make_train_step(task)(state, batch, start))
    counts = launch_counts()
    metrics = {k: float(v) for k, v in metrics.items()}
    grads, new, buffers = whole(state)
    bits = _every_rank(state_words(state, new, buffers), mg)
    out = {"launches": counts, "ms_2_gloo_ranks_on_one_card": ms, "crop_start": start, "metrics": metrics,
           "sharded_parameters": {k: len(getattr(getattr(state, k), "tp_params", {})) for k in modules},
           "state_tensors_compared": len(bits[0]) // 2, "bytes_held": _held(state),
           "ranks_state_bit_equal": all(torch.equal(b, bits[0]) for b in bits)}
    del state
    torch.cuda.empty_cache()
    if rank == 0:
        ref = fresh(None)
        _, old, _ = whole(ref, with_grads=False)  # the weights before the step, the sharded state's too
        want, ms_one = _timed(lambda: gan.make_train_step(task)(ref, batch, start))
        want = {k: float(v) for k, v in want.items()}
        ref_grads, ref_new, ref_buffers = whole(ref)
        out["bytes_one_process"] = _held(ref)
        norms = [k for k in want if "grad_norm" in k]
        losses = [k for k in want if k not in norms and k != "lr"]
        grad_rel = {n: rel_l2(g, ref_grads[n]) for n, g in grads.items()}
        worst = max(grad_rel, key=grad_rel.get)
        gains = [n for n in grads if n.endswith("original0") and ".resblocks." in n]
        weight_abs = {n: float((w - ref_new[n]).abs().max()) for n, w in new.items()}
        worst_w = max(weight_abs, key=weight_abs.get)
        out.update(one_process_ms=ms_one, loss_rel={k: rel(metrics[k], want[k]) for k in losses},
                   grad_norm_rel={k: rel(metrics[k], want[k]) for k in norms}, grad_tensors=len(grad_rel),
                   max_grad_rel_l2=grad_rel[worst], worst_grad=worst,
                   max_row_gain_grad_rel_l2=max((grad_rel[n] for n in gains), default=None), row_gains=len(gains),
                   max_weight_abs_err=weight_abs[worst_w], worst_weight=worst_w,
                   buffer_rel_l2={n: rel_l2(b, ref_buffers[n]) for n, b in buffers.items()},
                   codebooks_moved={n: bool((ref_buffers[n] != sd[n[len("generator."):]].to(dev)).any())
                                    for n in buffers if ".vq." in n},
                   params_adam_close=all(adam_step_close(new[n], ref_new[n], old[n], ref_grads[n],
                                                         float((grads[n] - ref_grads[n]).abs().max()), want["lr"],
                                                         task.weight_decay) for n in grads),
                   metrics_one_process=want)
        del ref
        torch.cuda.empty_cache()
    return out


def _tp_step(mg, dev, rank: int, batch: dict) -> dict:
    """(d) BigVGAN's training step at full width on ``batch`` (b2, fp32): the generator by its specs (K1 under
    autograd on each rank's channel shards), the MPD's larger convs in storage shards."""
    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models.bigvgan import random_state_dict

    task = build_task_config("bigvgan", "44100_512_2048")
    return _tp_train_step(mg, dev, rank, task, random_state_dict(task.generator, SEED), batch)


def _tp_vqvae_step(mg, dev, rank: int) -> dict:
    """(e) One vqvae step at the preset's width and reduced depth (``reduced_family_task``: 2 WaveNet layers, one
    resblock a stage), b2 x 8,192 samples, a 4,096-sample crop, the codebook fitted to the batch's latents
    (``fit_codebook``, rank 0's fit on every rank): every tensor of the generator, the codebook and the
    discriminators of 65,536 elements or more in storage shards."""
    import torch

    from vocoder_tpu_torch.models.vae import VQVAEGenerator, vqvae_random_state_dict
    from vocoder_tpu_torch.tools.profile_train import synthetic_batch
    from vocoder_tpu_torch.train import gan

    task = reduced_family_task("vqvae", "hifigan", "vqvae")
    t = task.hop_length * task.num_frames
    batch = synthetic_batch(TP_STEP_BATCH, t, task.sampling_rate, SEED, "cpu")
    batch["lengths"][1] = t * 4 // 5
    batch["audio"][1, :, t * 4 // 5 :] = 0.0
    m = VQVAEGenerator(task.generator)
    m.load_state_dict(vqvae_random_state_dict(task.generator, SEED))
    fit_codebook(m, gan.input_transform(task, batch["audio"][:, 0]), SEED)
    sd = {k: v.detach().clone() for k, v in m.state_dict().items()}
    del m
    # The fit runs on each child's CPU threads, whose sums need not round alike in two processes: every rank
    # takes rank 0's weights (as the trainer broadcasts its modules), and the record says whether they differed.
    mine = torch.cat([v.contiguous().view(-1).view(torch.int32).long().sum().view(1) for v in sd.values()])
    fits = [torch.zeros_like(mine) for _ in range(mg.size)]
    torch.distributed.all_gather(fits, mine, group=mg.group)
    for v in sd.values():
        torch.distributed.broadcast(v, src=torch.distributed.get_global_rank(mg.group, 0), group=mg.group)
    out = _tp_train_step(mg, dev, rank, task, sd, {k: v.to(dev) for k, v in batch.items()})
    out["fits_equal_before_broadcast"] = all(torch.equal(f, fits[0]) for f in fits)
    return out


def _tp_firefly_forward(mg, dev, rank: int) -> dict:
    """(f) Firefly-GAN at the preset through ``cli.infer.load_generator`` with the model group (weight norm
    folded, then every weight of 65,536 elements or more in storage shards, gathered at each forward), b4 x
    F_FRAMES, fp32, against one process's ``load_generator`` (rank 0); the parameter bytes each holds."""
    import torch

    from vocoder_tpu_torch.cli.infer import load_generator
    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models.firefly import random_state_dict
    from vocoder_tpu_torch.parallel import tp

    task = build_task_config("firefly_gan_base", "44100_512_2048")
    g = torch.Generator(device=dev).manual_seed(SEED + 39)
    mel = torch.randn(TP_BATCH, task.num_mels, F_FRAMES, device=dev, generator=g) - 5.0
    with tempfile.TemporaryDirectory() as tmp:
        Path(tmp, "checkpoints").mkdir()
        torch.save({"generator": random_state_dict(task.generator, SEED)}, Path(tmp, "checkpoints", "0.pt"))
        model = load_generator(tmp, task, dev, model_group=mg)
        with torch.inference_mode():
            y, ms = _timed(lambda: model(mel))
            ys = _every_rank(y, mg)
        out = {"ms_2_gloo_ranks_on_one_card": ms, "sharded_tensors": len(getattr(model, "tp_params", {})),
               "param_bytes_held": tp.held_bytes(model)["parameters"]}
        del model
        if rank == 0:
            ref = load_generator(tmp, task, dev)
            with torch.inference_mode():
                want, ms_one = _timed(lambda: ref(mel))
            out.update(one_process_ms=ms_one, param_bytes_whole=tp.held_bytes(ref)["parameters"],
                       rel_l2=max(rel_l2(v, want) for v in ys), max_abs_err=max(float((v - want).abs().max()) for v in ys),
                       finite=all(bool(torch.isfinite(v).all()) for v in ys), shape=list(y.shape))
            del ref, want
    del y, ys
    torch.cuda.empty_cache()
    return out


def _tp_rank(rank: int, dev, batch: dict) -> dict:
    """37's tensor-parallel part on this gloo child: (a)-(f) in the model group of both children."""
    from vocoder_tpu_torch.parallel import tp

    mg = tp.make_grid(DP_RANKS).model
    out, seconds, t = {}, {}, time.perf_counter()
    for part, run in (("a", lambda: {"bigvgan": _tp_bigvgan_forwards(mg, dev, rank)}),
                      ("b-c", lambda: _tp_library_forwards(mg, dev, rank)),
                      ("d", lambda: {"step": _tp_step(mg, dev, rank, batch)}),
                      ("e", lambda: {"vqvae_step": _tp_vqvae_step(mg, dev, rank)}),
                      ("f", lambda: {"firefly": _tp_firefly_forward(mg, dev, rank)})):
        out.update(run())
        seconds[part], t = time.perf_counter() - t, time.perf_counter()
    return {**out, "seconds": seconds}


def start_dp_ranks() -> tuple:
    """37's DP_RANKS processes (``_dp_rank``), started.  -> (the processes, the directory they write to)."""
    import torch

    from vocoder_tpu_torch.parallel import dist

    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    port = dist.free_port()
    tmp = tempfile.TemporaryDirectory()
    procs = [ctx.Process(target=_dp_rank, args=(r, port, tmp.name)) for r in range(DP_RANKS)]
    for p in procs:
        p.start()
    return procs, tmp


def check_dp_step_gloo(started: tuple, paths: dict, stamp: dict) -> dict:
    """37. DP_RANKS processes on the one card over gloo (which moves CUDA tensors; NCCL takes one process a
    card), each BigVGAN's step at full width on b2 through K1, against one process's b4 step on the
    concatenated batch from the same weights and crop start: every loss (DP_LOSS_REL), grad norm
    (DP_NORM_REL), generator and discriminator gradient (DP_GRAD_REL_L2), the updated weights (Adam's
    first-step rule, ``adam_step_close``); the ranks' weights equal; K1 launched 91 times on each rank.
    ``started``: ``start_dp_ranks``'s."""
    procs, tmp = started
    deadline = time.monotonic() + DP_TIMEOUT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        raise SystemExit(f"the gloo ranks exited {[p.exitcode for p in procs]}")
    ranks = [json.loads(Path(tmp.name, f"rank{r}.json").read_text()) for r in range(DP_RANKS)]
    tmp.cleanup()
    cmp = ranks[0]["compared"]
    counts = [r["launches"] for r in ranks]
    paths["dp_step_gloo"] = {k: sum(c[k] for c in counts) for k in ("aa_snake", "aa_snake_bwd", FP32_K2, BF16_K2)}
    ok = (all(r["ranks_agree"] and r["crop_start"] == ranks[0]["crop_start"] for r in ranks)
          and all(c["aa_snake"] == c["aa_snake_bwd"] == K1_PER_BIGVGAN_FORWARD for c in counts)
          and cmp["same_crop_start"]
          and max(cmp["loss_rel"].values()) <= DP_LOSS_REL and max(cmp["grad_norm_rel"].values()) <= DP_NORM_REL
          and cmp["max_grad_rel_l2"] <= DP_GRAD_REL_L2 and cmp["params_adam_close"]
          and all(math.isfinite(v) for r in ranks for v in r["metrics"].values()))
    rec = {"phase": "dp_step_gloo", "model": "bigvgan", "ranks": DP_RANKS, "batch_per_rank": DP_STEP_BATCH // DP_RANKS,
           "batch_one_process": DP_STEP_BATCH, "launches_by_rank": counts, "metrics_dp": ranks[0]["metrics"], **cmp,
           "limits": {"loss_rel": DP_LOSS_REL, "grad_norm_rel": DP_NORM_REL, "grad_rel_l2": DP_GRAD_REL_L2},
           "ok": ok, **stamp}
    log(rec)
    if not ok:
        raise SystemExit("the 2-rank step over gloo differs from one process's step on the whole batch")
    check_tp_gloo([r["tp"] for r in ranks], paths, stamp)
    return rec


def check_tp_gloo(ranks: list, paths: dict, stamp: dict) -> None:
    """37's tensor-parallel part, each child a rank of one model group of two on the one card (gloo):
    (a) BigVGAN's forwards through K2 on gathered stages and K1 (fp32 within TP_GEN_REL_L2, with lengths 0 past
    each, bf16 within TP_BF16_FLOORS times the run's plain-vs-plain floor, at least GEN_BF16_REL_L2 and at most
    GEN_BF16_CAP), 90 K2 launches a child a forward and K2's plans of the gathered stages packed once;
    (b) vocos-huge and (c) HiFiGAN within TP_GEN_REL_L2, a rank holding TP_SHARE of vocos-huge's bytes;
    (d) BigVGAN's b2 step against one process's: losses, grad norms, every gathered gradient (the row-parallel
    convs' replicated gains named apart), the gathered weights after AdamW (Adam's first-step rule), each
    rank's whole state after the step equal to rank 0's to the bit, the discriminators in storage shards;
    (e) the vqvae's step by (d)'s rules, the EMA codebook within FAMILY_EMA_REL_L2 and moved, the generator and
    the discriminators in storage shards; (f) Firefly-GAN's forward through ``load_generator`` within
    TP_GEN_REL_L2, each rank holding fewer parameter bytes; each rank's bytes held for (d)-(f).  The launches
    of each run go to the kernels line.  Times are of 2 gloo ranks sharing one card, not of tensor
    parallelism on cards."""
    zero = {"aa_snake": 0, "aa_snake_bwd": 0, FP32_K2: 0, BF16_K2: 0}
    big = ranks[0]["bigvgan"]
    k2 = {"fp32": FP32_K2, "fp32_again": FP32_K2, "fp32_masked": FP32_K2, "bf16": BF16_K2}
    floor = big["bf16_plain_vs_plain_rel_l2"]
    oks = {}
    for tag, route in k2.items():
        counts = [r["bigvgan"][tag]["launches"] for r in ranks]
        paths[f"tp_bigvgan_{tag}"] = {k: sum(c[k] for c in counts) for k in zero}
        limit = TP_GEN_REL_L2 if route == FP32_K2 else max(GEN_BF16_REL_L2, min(TP_BF16_FLOORS * floor, GEN_BF16_CAP))
        run = big[tag]
        oks[tag] = (run["rel_l2"] <= limit and run["finite"]
                    and all(c[route] == K2_PER_BIGVGAN_FORWARD and c["aa_snake"] == 1 for c in counts)
                    and run.get("zero_past_lengths", True))
        log({"phase": "tp_bigvgan_forward", "run": tag, "ranks": DP_RANKS, "batch": TP_BATCH, "frames": F_FRAMES,
             "rel_l2": run["rel_l2"], "limit": limit, "max_abs_err": run["max_abs_err"],
             "launches_by_rank": counts, **{k: [r["bigvgan"][tag][k] for r in ranks] for k in (
                 "k2_plans_packed", "k2_plans_reused", "gathered_stages_made", "gathered_stages_reused",
                 "ms_2_gloo_ranks_on_one_card")},
             **({"zero_past_lengths": run["zero_past_lengths"]} if "zero_past_lengths" in run else {}),
             "one_process_ms": big["one_process_ms"].get(tag), "ok": oks[tag], **stamp})
    again = [r["bigvgan"]["fp32_again"] for r in ranks]
    oks["plans_once"] = all(a["k2_plans_packed"] == 0 and a["gathered_stages_made"] == 0
                            and a["k2_plans_reused"] == STAGES_PER_BIGVGAN for a in again)
    log({"phase": "tp_bigvgan_k2_plans", "second_forward": again, "bf16_plain_vs_plain_rel_l2": floor,
         "ok": oks["plans_once"], **stamp})
    for name in ("vocos_huge", "hifigan"):
        run = ranks[0][name]
        shares = [r[name]["param_share"] for r in ranks]
        oks[name] = (run["rel_l2"] <= TP_GEN_REL_L2 and run["finite"]
                     and (name != "vocos_huge" or all(TP_SHARE[0] <= v <= TP_SHARE[1] for v in shares)))
        log({"phase": f"tp_{name}_forward", "ranks": DP_RANKS, "batch": TP_BATCH, "frames": F_FRAMES, "shape": run["shape"],
             "rel_l2": run["rel_l2"], "limit": TP_GEN_REL_L2, "max_abs_err": run["max_abs_err"],
             "param_bytes_whole": run["param_bytes_whole"], "param_share_by_rank": shares,
             "ms_2_gloo_ranks_on_one_card": [r[name]["ms_2_gloo_ranks_on_one_card"] for r in ranks],
             "one_process_ms": run["one_process_ms"], "ok": oks[name], **stamp})
    step = ranks[0]["step"]
    counts = [r["step"]["launches"] for r in ranks]
    paths["tp_bigvgan_step"] = {k: sum(c[k] for c in counts) for k in zero}
    want = step["metrics_one_process"]
    norms = list(step["grad_norm_rel"])
    loss_rel = max(rel(r["step"]["metrics"][k], want[k]) for r in ranks for k in step["loss_rel"])
    norm_rel = max(rel(r["step"]["metrics"][k], want[k]) for r in ranks for k in norms)
    oks["step"] = (all(c["aa_snake"] == c["aa_snake_bwd"] == K1_PER_BIGVGAN_FORWARD for c in counts)
                   and all(r["step"]["crop_start"] == step["crop_start"] for r in ranks)
                   and loss_rel <= TP_LOSS_REL and norm_rel <= TP_NORM_REL
                   and step["max_grad_rel_l2"] <= TP_GRAD_REL_L2 and step["row_gains"] > 0
                   and step["params_adam_close"] and all(r["step"]["ranks_state_bit_equal"] for r in ranks)
                   and step["sharded_parameters"]["discriminators"] > 0
                   and all(math.isfinite(v) for v in step["metrics"].values()))
    log({"phase": "tp_bigvgan_step", "ranks": DP_RANKS, "batch": TP_STEP_BATCH, "launches_by_rank": counts,
         "max_loss_rel_any_rank": loss_rel, "max_grad_norm_rel_any_rank": norm_rel,
         "ranks_state_bit_equal": [r["step"]["ranks_state_bit_equal"] for r in ranks],
         "state_tensors_compared": step["state_tensors_compared"],
         **{k: step[k] for k in ("loss_rel", "grad_norm_rel", "grad_tensors", "max_grad_rel_l2", "worst_grad",
                                 "max_row_gain_grad_rel_l2", "row_gains", "max_weight_abs_err", "worst_weight",
                                 "params_adam_close", "sharded_parameters", "one_process_ms", "metrics",
                                 "metrics_one_process")},
         "ms_2_gloo_ranks_on_one_card": [r["step"]["ms_2_gloo_ranks_on_one_card"] for r in ranks],
         "limits": {"loss_rel": TP_LOSS_REL, "grad_norm_rel": TP_NORM_REL, "grad_rel_l2": TP_GRAD_REL_L2,
                    "weights": "adam_step_close"}, "weight_abs_reference": TP_WEIGHT_ABS, "ok": oks["step"], **stamp})
    oks.update(check_tp_storage(ranks, stamp))
    failed = [k for k, v in oks.items() if not v]
    if failed:
        raise SystemExit(f"tensor parallelism over 2 gloo ranks differs from one process: {failed}")


def check_tp_storage(ranks: list, stamp: dict) -> dict:
    """37 (e) and (f), storage sharding on the two gloo children: the vqvae's step and Firefly-GAN's forward
    against one process (``check_tp_gloo``'s rules), then each rank's bytes held for (d)-(f) against one
    process's.  -> {check: ok}."""
    oks = {}
    vq = ranks[0]["vqvae_step"]
    want = vq["metrics_one_process"]
    loss_rel = max(rel(r["vqvae_step"]["metrics"][k], want[k]) for r in ranks for k in vq["loss_rel"])
    norm_rel = max(rel(r["vqvae_step"]["metrics"][k], want[k]) for r in ranks for k in vq["grad_norm_rel"])
    oks["vqvae_step"] = (all(r["vqvae_step"]["crop_start"] == vq["crop_start"] for r in ranks)
                         and loss_rel <= TP_LOSS_REL and norm_rel <= TP_NORM_REL
                         and vq["max_grad_rel_l2"] <= TP_GRAD_REL_L2 and vq["params_adam_close"]
                         and all(v <= FAMILY_EMA_REL_L2 for v in vq["buffer_rel_l2"].values())
                         and vq["codebooks_moved"] and all(vq["codebooks_moved"].values())
                         and all(r["vqvae_step"]["ranks_state_bit_equal"] for r in ranks)
                         and all(v > 0 for v in vq["sharded_parameters"].values())
                         and all(math.isfinite(v) for v in vq["metrics"].values()))
    log({"phase": "tp_vqvae_step", "ranks": DP_RANKS, "batch": TP_STEP_BATCH,
         "max_loss_rel_any_rank": loss_rel, "max_grad_norm_rel_any_rank": norm_rel,
         "ranks_state_bit_equal": [r["vqvae_step"]["ranks_state_bit_equal"] for r in ranks],
         **{k: vq[k] for k in ("state_tensors_compared", "loss_rel", "grad_norm_rel", "grad_tensors", "max_grad_rel_l2",
                               "worst_grad", "max_weight_abs_err", "worst_weight", "params_adam_close",
                               "buffer_rel_l2", "codebooks_moved", "sharded_parameters", "one_process_ms",
                               "fits_equal_before_broadcast",
                               "metrics", "metrics_one_process")},
         "ms_2_gloo_ranks_on_one_card": [r["vqvae_step"]["ms_2_gloo_ranks_on_one_card"] for r in ranks],
         "limits": {"loss_rel": TP_LOSS_REL, "grad_norm_rel": TP_NORM_REL, "grad_rel_l2": TP_GRAD_REL_L2,
                    "ema_rel_l2": FAMILY_EMA_REL_L2, "weights": "adam_step_close"},
         "ok": oks["vqvae_step"], **stamp})
    ff = ranks[0]["firefly"]
    oks["firefly"] = (ff["rel_l2"] <= TP_GEN_REL_L2 and ff["finite"]
                      and all(0 < r["firefly"]["param_bytes_held"] < ff["param_bytes_whole"] for r in ranks))
    log({"phase": "tp_firefly_forward", "ranks": DP_RANKS, "batch": TP_BATCH, "frames": F_FRAMES, "shape": ff["shape"],
         "rel_l2": ff["rel_l2"], "limit": TP_GEN_REL_L2, "max_abs_err": ff["max_abs_err"],
         "sharded_tensors": ff["sharded_tensors"],
         "ms_2_gloo_ranks_on_one_card": [r["firefly"]["ms_2_gloo_ranks_on_one_card"] for r in ranks],
         "one_process_ms": ff["one_process_ms"], "ok": oks["firefly"], **stamp})
    # Each rank's bytes held, counted from its tensors, against one process's (the storage rule at model 2).
    for tag, key in (("d_bigvgan_step", "step"), ("e_vqvae_step", "vqvae_step")):
        one = ranks[0][key]["bytes_one_process"]
        by_rank = [r[key]["bytes_held"] for r in ranks]
        log({"phase": "tp_bytes_held", "run": tag, "bytes_held_by_rank": by_rank, "bytes_one_process": one,
             "share_by_rank": [{k: v / one[k] for k, v in b.items() if one[k]} for b in by_rank], **stamp})
    log({"phase": "tp_seconds_by_part", "seconds_by_rank": [r["seconds"] for r in ranks], **stamp})
    log({"phase": "tp_bytes_held", "run": "f_firefly_forward",
         "bytes_held_by_rank": [{"parameters": r["firefly"]["param_bytes_held"]} for r in ranks],
         "bytes_one_process": {"parameters": ff["param_bytes_whole"]},
         "share_by_rank": [r["firefly"]["param_bytes_held"] / ff["param_bytes_whole"] for r in ranks], **stamp})
    return oks


def check_bench_scaling(stamp: dict) -> list:
    """38. ``torchrun --nproc_per_node 1 -m vocoder_tpu_torch.cli.bench_scaling --meshes 1,2`` (HiFiGAN at the
    44.1 kHz preset, 8 items x 32 frames a rank, 3 timed steps): one line, dp 1, with the JAX package's keys;
    2 is more than the one card and prints nothing.  Scaling efficiency needs more cards than this machine's."""
    proc = start_torchrun(["vocoder_tpu_torch.cli.bench_scaling", "--meshes", "1,2", "--iters", "3"])
    out, _ = finish(proc)
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    ok = (proc.returncode == 0 and [r["data_parallel"] for r in lines] == [1]
          and all(set(r) == {"data_parallel", "step_ms", "audio_s_per_s", "efficiency"} for r in lines))
    log({"phase": "bench_scaling", "records": lines, "ok": ok, **stamp})
    if not ok:
        raise SystemExit("cli.bench_scaling under torchrun did not print the one line of dp 1")
    return lines


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card", file=sys.stderr)
        return 2
    import numpy as np

    from vocoder_tpu_torch.cli import infer
    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.data.audio_io import read_wav
    from vocoder_tpu_torch.models.bigvgan import BigVGAN, random_state_dict
    from vocoder_tpu_torch.nn import fold_weight_norm
    from vocoder_tpu_torch.ops import build
    from vocoder_tpu_torch.ops.aa_snake import aa_snake_kernel
    from vocoder_tpu_torch.ops.amp_block import amp_stage_kernel, amp_stage_plain
    from vocoder_tpu_torch.ops.antialias import aa_snake_plain, snake_params
    from vocoder_tpu_torch.tools.timing import card_line, cuda_ms, device_time

    card = card_line()
    print(card, flush=True)
    tf32_off()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    stamp = {"card": card, "device": kind}
    timeline = {}  # phase -> seconds from the start to its end

    def mark(phase: str) -> None:  # printed as it happens too, so that a run that fails shows where time went
        timeline[phase] = round(time.perf_counter() - t0, 3)
        print(f"timeline: {phase} ends at {timeline[phase]} s", flush=True)

    # 0. Build, in a thread (nvcc runs in processes of its own).  Meanwhile the card is free: phases 38 and 16
    # launch no hand kernel (HiFiGAN; the vae's, vqvae's, Vocos's and Firefly-GAN's generators), so they run
    # now, one after the other, each alone on the card beside the compilers.
    t0 = time.perf_counter()

    def timed_build():
        libs = build.build_all()
        return libs, round(time.perf_counter() - t0, 3)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(timed_build)
        check_bench_scaling(stamp)
        mark("38 bench_scaling (during the build)")
        time_family_steps(dev, stamp)
        mark("16 family step timings (during the build)")
        libs, build_s = building.result()
    mark("0 build")
    log({"phase": "build", "seconds": build_s, "libs": sorted(p.name for p in libs.values())})
    for name in sorted(libs):  # ptxas -v: registers, shared memory and spills of each instantiation
        logf = build.BUILD_DIR / f"{name}.log"
        if logf.is_file():
            lines = {ln.strip() for ln in logf.read_text().splitlines() if "registers" in ln or "spill" in ln}
            for line in sorted(lines):
                print(f"  ptxas {name}: {line}", flush=True)

    task = build_task_config("bigvgan", "44100_512_2048")
    cfg = task.generator
    sd = random_state_dict(cfg, SEED)
    model = BigVGAN(cfg)
    model.load_state_dict(sd)
    fold_weight_norm(model)
    model = model.to(dev).eval()
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_k = len(cfg.resblock_kernel_sizes)
    post = model.activation_post.activation
    c_post = post.alpha.numel()
    t_post = F_FRAMES * cfg.hop_length
    errs = {"aa_snake": 0.0, FP32_K2: 0.0, BF16_K2: 0.0}
    errs_masked = dict(errs)
    paths = {}  # main path -> the launch counts of its run
    mma_rel = 0.0

    with torch.inference_mode():
        # 1. K1 against its plain version.  The last two shapes draw from a generator of their own, so
        # that phase 2's inputs stay those of earlier runs and its errors compare to the last digit.
        gen_k1 = torch.Generator(device=dev).manual_seed(SEED + 1)
        for b, t, g in ((1, t_post, gen), (4, t_post, gen), (1, t_post + 77, gen), (2, 37, gen),
                        (16, t_post, gen_k1), (4200, 40, gen_k1)):
            x32 = torch.randn(b, c_post, t, device=dev, generator=g)
            for dtype, m in ((torch.float32, model), (torch.bfloat16, model_bf16)):
                p = m.activation_post.activation
                x = x32.to(dtype)
                got = aa_snake_kernel(x, p.alpha, p.beta, True)
                want = aa_snake_plain(x, *snake_params(p.alpha, p.beta, True))
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    err = float((got - want).abs().max())
                    errs["aa_snake"] = max(errs["aa_snake"], err)
                    ok = err <= K1_FP32_MAX_ABS
                    log({"phase": "k1_check", "shape": [b, c_post, t], "dtype": "fp32", "max_abs_err": err,
                         "max_abs_ref": float(want.abs().max()), "ok": ok})
                else:
                    err = rel_l2(got.float(), want.float())
                    ok = err <= BF16_REL_L2
                    log({"phase": "k1_check", "shape": [b, c_post, t], "dtype": "bf16", "rel_l2": err, "ok": ok})
                if not ok:
                    raise SystemExit(f"K1 disagrees with its plain version at {(b, c_post, t)} {dtype}")

        # 2. K2 against its plain stage, at both batches that phase 4 times: b16 takes every
        # stage's large tile, b1 the small tile wherever the large one leaves the grid narrow.
        for b, (i, (c, t)) in itertools.product((1, 16), enumerate(stage_shapes(cfg))):
            x32 = torch.randn(b, c, t, device=dev, generator=gen)
            for dtype, m in ((torch.float32, model), (torch.bfloat16, model_bf16)):
                blocks = list(m.resblocks[i * n_k : (i + 1) * n_k])
                x = x32.to(dtype)
                got = amp_stage_kernel(blocks, x, cfg.snake_logscale)
                want = amp_stage_plain(blocks, x, cfg.snake_logscale)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    err = float((got - want).abs().max())
                    errs[FP32_K2] = max(errs[FP32_K2], err)
                    ok = bool(torch.allclose(got, want, rtol=K2_FP32_RTOL, atol=K2_FP32_ATOL))
                    log({"phase": "k2_check", "stage": i, "shape": [b, c, t], "dtype": "fp32", "max_abs_err": err,
                         "max_abs_ref": float(want.abs().max()), "ok": ok})
                else:
                    err = rel_l2(got.float(), want.float())
                    mma_rel = max(mma_rel, err)
                    abs_err = float((got.float() - want.float()).abs().max())
                    errs[BF16_K2] = max(errs[BF16_K2], abs_err)
                    ok = err <= K2_BF16_REL_L2
                    log({"phase": "k2_check", "stage": i, "shape": [b, c, t], "dtype": "bf16", "rel_l2": err,
                         "max_abs_err": abs_err, "max_abs_ref": float(want.float().abs().max()), "ok": ok})
                if not ok:
                    raise SystemExit(f"K2 disagrees with its plain stage at stage {i} {(b, c, t)} {dtype}")

        # 1-2, with per-item lengths.
        check_masked_kernels(model, model_bf16, c_post, t_post, dev, errs_masked)
    mark("1-2 kernel checks")

    # 3. The full generator through the inference CLI.
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ckpt = root / "generator.ckpt"
        torch.save({"state_dict": {f"generator.{k}": v for k, v in sd.items()}}, ckpt)
        (root / "in").mkdir()
        expected = write_inputs(root / "in", task, rng)
        chunk = 512
        argv = ["--model", "bigvgan", "--resolution", "44100_512_2048", "--ckpt", str(ckpt),
                "--input", str(root / "in"), "--output", str(root / "out"), "--chunk-frames", str(chunk)]
        cli_s = drive_path("cli_bigvgan", lambda: run_cli(infer, argv), ("aa_snake", FP32_K2), paths)
        tf32_off()
        log({"phase": "cli", "seconds": cli_s, "launches": paths["cli_bigvgan"], "chunk_frames": chunk})
        for name, n in expected.items():
            audio, sr = read_wav(root / "out" / name)
            ok = sr == task.sampling_rate and audio.shape == (1, n) and bool(np.isfinite(audio).all())
            ok = ok and float(np.abs(audio).max()) > 1e-3
            log({"phase": "cli_output", "file": name, "samples": audio.shape[-1], "expected": n,
                 "peak": float(np.abs(audio).max()), "ok": ok})
            if not ok:
                raise SystemExit(f"{name}: bad output {audio.shape} at {sr} Hz")

        # Kernel path against the plain path on the same mel, fp32; and the WAV against the kernel path.
        with torch.inference_mode():
            gen_model = infer.load_generator(ckpt, task, dev)
            mel, _ = infer.load_mel_item(root / "in" / "mel.npy", task, dev)
            got = gen_model(mel)
            want = gen_model.forward_plain(mel)
            torch.cuda.synchronize()
            err = rel_l2(got, want)
            wav, _ = read_wav(root / "out" / "mel.wav")
            wav_err = float(np.abs(wav[0] - got[0, 0].cpu().numpy()).max())
            ok = err <= GEN_FP32_REL_L2 and bool(torch.isfinite(got).all()) and wav_err <= 2.0 / 32768
            log({"phase": "generator_check", "shape": list(got.shape), "rel_l2": err,
                 "max_abs_err": float((got - want).abs().max()), "wav_vs_kernel_max_abs": wav_err, "ok": ok})
            if not ok:
                raise SystemExit("the generator's kernel path disagrees with its plain path")

            # The same model and mel in bf16 through BigVGAN.forward: the tensor-core route.
            gen_bf16 = copy.deepcopy(gen_model).to(torch.bfloat16)
            mel_bf16 = mel.to(torch.bfloat16)
            got = drive_path("forward_bf16", lambda: gen_bf16(mel_bf16), ("aa_snake", BF16_K2), paths)
            bf16_launches = paths["forward_bf16"]
            want = gen_bf16.forward_plain(mel_bf16)
            torch.backends.cudnn.enabled = False  # the same plain path on PyTorch's own convs
            want_native = gen_bf16.forward_plain(mel_bf16)
            torch.backends.cudnn.enabled = True
            torch.cuda.synchronize()
            err = rel_l2(got.float(), want.float())
            floor = rel_l2(want_native.float(), want.float())
            ok = (err <= max(GEN_BF16_REL_L2, min(floor, GEN_BF16_CAP)) and bool(torch.isfinite(got).all())
                  and bf16_launches["aa_snake"] > 0 and bf16_launches[BF16_K2] > 0)
            log({"phase": "generator_check_bf16", "shape": list(got.shape), "rel_l2": err,
                 "plain_vs_plain_rel_l2": floor, "max_abs_err": float((got.float() - want.float()).abs().max()),
                 "launches": bf16_launches, "ok": ok})
            if not ok:
                raise SystemExit("the bf16 generator's kernel path disagrees with its plain path or skipped a kernel")

            # 4. A padded batch against per-item runs, on the kernels.
            check_masked_generator(model, model_bf16, cfg.hop_length, dev, paths)

            mark("3-4 bigvgan cli and forwards")
            # 5. HiFiGAN and Vocos on the card.
            lib_models = library_models(dev)
            check_library_models(lib_models, dev)
            mark("5 hifigan vocos")

        # 6. The batched CLI against the per-file CLI, every family.
        (root / "batch_in").mkdir()
        write_batch_inputs(root / "batch_in", task, rng)
        ckpts = {"bigvgan": ckpt}
        for name, (_, lib_sd, _) in lib_models.items():
            ckpts[name] = root / f"{name}.ckpt"
            torch.save({"state_dict": {f"generator.{k}": v for k, v in lib_sd.items()}}, ckpts[name])
        check_batched_cli(infer, root, ckpts, paths)
        tf32_off()
    mark("6 batched cli")

    # 7. Timing, CUDA events.
    entries = {}
    with torch.inference_mode():
        for b in (1, 16):
            x = torch.randn(b, c_post, t_post, device=dev, generator=gen).to(torch.bfloat16)
            p = model_bf16.activation_post.activation
            ms, host_us = device_time(lambda: aa_snake_kernel(x, p.alpha, p.beta, True), 50)
            paced_ms = cuda_ms(lambda: aa_snake_kernel(x, p.alpha, p.beta, True), 20)
            plain_ms = cuda_ms(lambda: aa_snake_plain(x, *snake_params(p.alpha, p.beta, True)), 5)
            comp_s, mem_s = k1_cost(b, c_post, t_post, 2)
            bound_ms = 1e3 * max(comp_s, mem_s)
            rec = {"metric": "k1_ms", "batch": b, "shape": [b, c_post, t_post], "dtype": "bf16", "ms": ms,
                   "host_us_per_launch": host_us, "ms_host_paced": paced_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                   "bound_by": "operations" if comp_s >= mem_s else "bytes", "library_ms": None, **stamp}
            log(rec)
            entries.setdefault("aa_snake", {})[b] = rec

            entries.setdefault(BF16_K2, {})[b] = time_k2(model_bf16, torch.bfloat16, b, gen, stamp)
            entries.setdefault(FP32_K2, {})[b] = time_k2(model, torch.float32, b, gen, stamp)

            mel = torch.randn(b, cfg.num_mels, F_FRAMES, device=dev, generator=gen) - 5.0
            for dtype, m in ((torch.bfloat16, model_bf16), (torch.float32, model)):
                mel_d = mel.to(dtype)
                ms = cuda_ms(lambda: m(mel_d), 3 if b == 1 else 2, warmup=1)
                plain_ms = cuda_ms(lambda: m.forward_plain(mel_d), 1, warmup=1)
                audio_s = b * F_FRAMES * cfg.hop_length / task.sampling_rate
                log({"metric": "generator_ms", "model": "bigvgan", "batch": b, "frames": F_FRAMES,
                     "dtype": "bf16" if dtype == torch.bfloat16 else "fp32", "ms": ms, "plain_ms": plain_ms,
                     "audio_s_per_s": audio_s / (ms / 1e3), **stamp})
        time_masked_generator(model, model_bf16, task, dev, stamp)
        time_library_models(lib_models, dev, stamp)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "generator.ckpt"
        torch.save({"state_dict": {f"generator.{k}": v for k, v in sd.items()}}, ckpt)
        time_cli(infer, Path(tmp), ckpt, task, np.random.default_rng(SEED + 7), stamp)
    mark("7 timings")

    # 8. BigVGAN with an f0 template: BigVGAN.forward against its plain path, then cli.infer from a workdir.
    t_task, t_sd, t_model, t_model_bf16 = template_bigvgan()
    with torch.inference_mode():
        check_template_generator(t_task, t_model, t_model_bf16, dev, paths)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_template_workdir(root / "run", t_task, t_sd)
        (root / "in").mkdir()
        expected = template_wavs(root / "in", t_task, np.random.default_rng(SEED + 15))
        argv = ["--model", "bigvgan", "--ckpt", str(root / "run"), "--input", str(root / "in"), "--output",
                str(root / "out")]
        seconds = drive_path("cli_bigvgan_template", lambda: run_cli(infer, argv), ("aa_snake", FP32_K2), paths)
        tf32_off()
        log({"phase": "cli", "model": "bigvgan_template", "seconds": seconds,
             "launches": paths["cli_bigvgan_template"]})
        check_cli_outputs(root / "out", expected, t_task, "cli_output_bigvgan_template")
    mark("8 template bigvgan")

    # 9. RefineGAN and Firefly-GAN through cli.infer; the family timings.
    fam = family_models()
    with tempfile.TemporaryDirectory() as tmp:
        check_family_clis(infer, Path(tmp), fam, paths)
        mark("9 family clis")
        time_refinegan_cli(infer, Path(tmp), fam, stamp)
        mark("9 refinegan cli timing")
    tf32_off()
    time_families(fam, (t_task, t_model, t_model_bf16), dev, stamp)
    mark("9 family timings")
    del t_model, t_model_bf16, fam
    torch.cuda.empty_cache()

    # 10-14. Training.
    k1_grad = check_k1_autograd(dev)
    k1_bwd = {"fp32": check_k1_bwd(dev, torch.float32)}
    k1_bwd_times = time_k1_bwd(dev, stamp)
    mark("10 k1 autograd and the backward kernel")
    k1_train_step = check_train_steps(dev, paths)
    tf32_off()
    mark("11 train steps")
    cli_train_dir = tempfile.TemporaryDirectory()  # phase 12's corpus and records serve phase 36 too
    cli_train = check_cli_train(Path(cli_train_dir.name), infer, paths)
    mark("12 cli.train bigvgan")
    train_rec = time_train_step(dev, stamp)
    mark("13 train step timing")
    with tempfile.TemporaryDirectory() as tmp:
        cli_rec = check_cli_train_refinegan(Path(tmp), infer, paths)
    mark("14 cli.train refinegan")
    time_refinegan_step(dev, stamp, cli_rec)
    mark("14 refinegan step timing")

    # 15, 17, 18. The vqvae codec, the families' steps card vs CPU, cli.train --family vqvae (16 ran during
    # the build).
    with tempfile.TemporaryDirectory() as tmp:
        check_codec(Path(tmp), dev, paths, stamp)
    mark("15 vqvae codec")
    # Phases 36 and 37 (data and tensor parallelism, below) are checks in child processes: they run beside 17,
    # 18, 23, 24 and 25, which are checks too (25's peak memory is this process's allocator's), and are read
    # after 25; no timing phase runs beside them.
    torch.cuda.empty_cache()
    dp_ranks = start_dp_ranks()
    dp_cli = start_cli_train_torchrun(Path(cli_train_dir.name), cli_train)
    check_family_steps_cpu(dev, paths)
    mark("17 family steps card vs cpu")
    with tempfile.TemporaryDirectory() as tmp:
        check_cli_train_codec(Path(tmp), dev, paths)
    mark("18 cli.train vqvae")
    bf16_step = check_bf16_step(dev, paths)
    mark("23 bf16 step (beside 36-37)")
    k1_grad_bf16 = check_k1_autograd_bf16(dev)
    k1_bwd["bf16"] = check_k1_bwd(dev, torch.bfloat16)
    mark("24 k1 autograd bf16 and the bf16 backward kernel (beside 36-37)")
    ckpt_rec = check_checkpointing(dev, paths, stamp)
    mark("25 checkpointing (beside 36-37)")
    check_cli_train_torchrun(dp_cli, Path(cli_train_dir.name), cli_train, paths, stamp)
    cli_train_dir.cleanup()
    tf32_off()
    mark("36 cli.train torchrun nccl (beside 17-25)")
    check_dp_step_gloo(dp_ranks, paths, stamp)
    mark("37 dp and tp over gloo (beside 17-25)")

    # 19-22. FLAC/Ogg/MP3 input through the host library, training with validation PESQ, evaluation.
    libs = host_audio()
    time_native_resample(stamp)
    mark("19 host audio")
    with tempfile.TemporaryDirectory() as tmp:
        check_decoders(Path(tmp) / "decoders", libs, stamp)
        mark("20 decoders")
        work = check_cli_train_formats(Path(tmp) / "formats", libs, paths, stamp)
        tf32_off()
        mark("21 cli.train formats")
        check_cli_evaluate(Path(tmp) / "formats", work, infer, paths, stamp)
        tf32_off()
        mark("22 cli.evaluate")

        # 26-30. bf16 training, the profiler window and the bench CLIs (23-25 ran after 18).
        bf16_times = time_train_step_bf16(dev, stamp)
        mark("26 bf16 step timing")
        step_s = check_cli_train_bf16(Path(tmp) / "formats", paths, stamp)
        tf32_off()
        mark("27 cli.train bf16")
        check_profile_steps(Path(tmp) / "formats", paths)
        tf32_off()
        mark("28 profile_steps")
        run_bench_train(stamp)
        tf32_off()
        mark("29 bench_train")
        run_bench_input(Path(tmp) / "formats", step_s, stamp)
        mark("30 bench_input")

    # 31-35. The ssl family (HuBERT semantic codec) and cli.bench_infer.
    extractors = check_hubert(dev, stamp)
    mark("31 hubert")
    check_ssl_step_cpu(dev, extractors, paths)
    mark("32 ssl step card vs cpu")
    with tempfile.TemporaryDirectory() as tmp:
        check_cli_train_codec(Path(tmp), dev, paths, "ssl", stamp)
    mark("33 cli.train ssl")
    with tempfile.TemporaryDirectory() as tmp:
        check_codec(Path(tmp), dev, paths, stamp, "ssl", extractors)
    del extractors
    torch.cuda.empty_cache()
    mark("34 ssl codec")
    check_bench_infer(dev, stamp)
    mark("35 bench_infer")

    log({"phase": "timeline", "seconds_at_end": timeline})

    def launches(name):  # over the main paths' runs; each path's count beside it
        by_path = {path: c[name] for path, c in paths.items() if c.get(name)}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    k1 = entries["aa_snake"][1]
    kernels = [{"name": "aa_snake", "route": "cuda", "source": "vocoder_tpu_torch/csrc/aa_snake.cu",
                "replaces": "vocoder_tpu/ops/pallas/aa_snake.py:218", **launches("aa_snake"),
                "max_abs_err": errs["aa_snake"], "max_abs_err_masked": errs_masked["aa_snake"], "ms": k1["ms"],
                "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
                "bound_by": k1["bound_by"], "library_ms": None, "host_us_per_launch": k1["host_us_per_launch"],
                "ms_b16": entries["aa_snake"][16]["ms"], "bound_ms_b16": entries["aa_snake"][16]["bound_ms"],
                "launches_train_step": k1_train_step, "autograd_worst": k1_grad,
                "train_step_share_of_busy": (train_rec["shares_of_busy"] or {}).get("k1_forward"),
                "launches_train_step_bf16": bf16_step["launches"]["aa_snake"],
                "launches_train_step_checkpointed": ckpt_rec["k1_launches_per_step"]["with"],
                "autograd_bf16_worst": k1_grad_bf16,
                "train_step_bf16_share_of_busy": (bf16_times["shares_of_busy"] or {}).get(
                    "k1_forward")},
               {"name": "aa_snake_bwd", "route": "cuda", "source": "vocoder_tpu_torch/csrc/aa_snake_bwd.cu",
                "replaces": None, "yardstick": "ops/antialias.py::aa_snake_plain_vjp", **launches("aa_snake_bwd"),
                "worst_vs_plain_vjp": k1_bwd, "times_b16_step": k1_bwd_times,
                "train_step_share_of_busy": (train_rec["shares_of_busy"] or {}).get("aa_snake_backward"),
                "calls_train_step_checkpointed": ckpt_rec["k1_bwd_calls_per_step"]["with"]}]
    for name, dtype in ((FP32_K2, "fp32"), (BF16_K2, "bf16")):
        k2, k2_b16 = entries[name][1], entries[name][16]
        kernels.append({"name": name, "route": "cuda", "source": "vocoder_tpu_torch/csrc/amp_conv_mma.cu",
                        "replaces": "vocoder_tpu/ops/pallas/amp_block.py:590", **launches(name),
                        "max_abs_err": errs[name], "max_abs_err_masked": errs_masked[name], "dtype": dtype,
                        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
                        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None,
                        "bound_ms_cuda_cores": k2["bound_ms_cuda_cores"], "conv_library_ms": k2["conv_library_ms"],
                        "design_floor_ms": k2["design_floor_ms"], "host_us_per_launch": k2["host_us_per_launch"],
                        "ms_b16": k2_b16["ms"], "bound_ms_b16": k2_b16["bound_ms"],
                        "conv_library_ms_b16": k2_b16["conv_library_ms"],
                        "design_floor_ms_b16": k2_b16["design_floor_ms"]})
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
