#!/usr/bin/env python3
"""Drive the PyTorch port's BigVGAN inference on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root; needs one NVIDIA H100

Phases, in order; any failure exits non-zero:
  0. build the CUDA kernels from vocoder_tpu_torch/csrc (nvcc, sm_90a);
  1. K1 (aa-snake) against its plain version at activation_post's shape,
     C = 16, T = 512 * 256, b1 and b4, plus ragged T, in fp32 and bf16;
  2. K2 (AMP stage) against its plain stage at the five stage shapes of the
     44.1 kHz preset, F = 256 frames, b1, in fp32 and bf16;
  3. the full-width BigVGAN (random weights from a numpy seed, saved as a
     `generator.` checkpoint) through `cli.infer.main` on generated WAVs and
     one .npy mel, one file longer than --chunk-frames; both kernels' launch
     counts must be > 0 for that run; then the kernel path against the plain
     path on the same mel in fp32;
  4. CUDA-event timings of K1, K2 and the generator in bf16 at b1 and b16.

Prints the card's name and power limit first, one JSON line per timing, a
`{"kernels": [...]}` line and, last, `{"ok": true, "device": {...}}`.
Comparisons in fp32 run with TF32 off (cuDNN and matmul), so the plain
versions are full fp32.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet) for the roofline bound.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # CUDA cores
BF16_TC_FLOPS = 989e12  # dense bf16 tensor cores

F_FRAMES = 256
SEED = 0

# Tolerances, each with its reason.
K1_FP32_MAX_ABS = 1e-5  # same fp32 arithmetic, sums in another order
K2_FP32_RTOL, K2_FP32_ATOL = 2e-4, 2e-5  # the JAX fused-stage test's (tests/test_amp_fused.py:66)
GEN_FP32_REL_L2 = 1e-4  # 90 kernel convs and 5 cuDNN convs deep, fp32 throughout
BF16_REL_L2 = 2e-2  # bf16 inputs/outputs (8 mantissa bits) against the same rounded inputs


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def stage_shapes(cfg):
    """(C, T) of each AMP stage at F_FRAMES frames."""
    t, out = F_FRAMES, []
    for i, u in enumerate(cfg.upsample_rates):
        t *= u
        out.append((cfg.upsample_initial_channel // 2 ** (i + 1), t))
    return out


def k1_cost(b, c, t, itemsize):
    from vocoder_tpu_torch.ops.aa_snake import FLOPS_PER_SAMPLE

    flops = FLOPS_PER_SAMPLE * b * c * t
    nbytes = 2 * b * c * t * itemsize + 2 * c * itemsize
    return flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S


def k2_cost(blocks, b, c, t, itemsize, conv_peak):
    """(compute s, memory s) of one AMP stage.  The convs (2 C^2 K per sample)
    run on the best unit for the dtype and the aa-snake prologues on the CUDA
    cores; the two units run at once, so compute is the larger of the two
    times, not their sum.  x read once, the weights read once, the output
    written once."""
    from vocoder_tpu_torch.ops.aa_snake import FLOPS_PER_SAMPLE

    n_convs = sum(2 * len(blk.dilations) for blk in blocks)
    conv_flops = sum(2 * len(blk.dilations) * 2 * c * c * blk.kernel_size for blk in blocks) * b * t
    snake_flops = n_convs * FLOPS_PER_SAMPLE * b * c * t
    weights = sum(p.numel() for blk in blocks for p in blk.parameters())
    nbytes = (2 * b * c * t + weights) * itemsize
    return max(conv_flops / conv_peak, snake_flops / FP32_FLOPS), nbytes / HBM_BYTES_PER_S


def library_stage(blocks, x, logscale):
    """The stage as cuDNN F.conv1d chained with the plain aa-snake, in x's dtype (yardstick only)."""
    import torch.nn.functional as F

    from vocoder_tpu_torch.nn import get_padding
    from vocoder_tpu_torch.ops.antialias import aa_snake_plain, snake_params

    outs = []
    for blk in blocks:
        h, k = x, blk.kernel_size
        for i, (c1, c2, d) in enumerate(zip(blk.convs1, blk.convs2, blk.dilations)):
            a1, a2 = blk.activations[2 * i].activation, blk.activations[2 * i + 1].activation
            t = F.conv1d(aa_snake_plain(h, *snake_params(a1.alpha, a1.beta, logscale)), c1.weight, c1.bias,
                         padding=get_padding(k, d), dilation=d)
            t = F.conv1d(aa_snake_plain(t, *snake_params(a2.alpha, a2.beta, logscale)), c2.weight, c2.bias,
                         padding=get_padding(k))
            h = h + t
        outs.append(h)
    return sum(outs) / len(outs)


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
    from vocoder_tpu_torch.ops.aa_snake import aa_snake, aa_snake_kernel
    from vocoder_tpu_torch.ops.amp_block import amp_stage, amp_stage_kernel, amp_stage_plain
    from vocoder_tpu_torch.ops.antialias import aa_snake_plain, snake_params

    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    stamp = {"card": card, "device": kind}

    # 0. Build.
    t0 = time.perf_counter()
    libs = build.build_all()
    log({"phase": "build", "seconds": round(time.perf_counter() - t0, 3), "libs": sorted(p.name for p in libs.values())})
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
    errs = {"aa_snake": 0.0, "amp_stage": 0.0}

    with torch.inference_mode():
        # 1. K1 against its plain version.
        for b, t in ((1, t_post), (4, t_post), (1, t_post + 77), (2, 37)):
            x32 = torch.randn(b, c_post, t, device=dev, generator=gen)
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
                    log({"phase": "k1_check", "shape": [b, c_post, t], "dtype": "fp32", "max_abs_err": err, "ok": ok})
                else:
                    err = rel_l2(got.float(), want.float())
                    ok = err <= BF16_REL_L2
                    log({"phase": "k1_check", "shape": [b, c_post, t], "dtype": "bf16", "rel_l2": err, "ok": ok})
                if not ok:
                    raise SystemExit(f"K1 disagrees with its plain version at {(b, c_post, t)} {dtype}")

        # 2. K2 against its plain stage.
        for i, (c, t) in enumerate(stage_shapes(cfg)):
            x32 = torch.randn(1, c, t, device=dev, generator=gen)
            for dtype, m in ((torch.float32, model), (torch.bfloat16, model_bf16)):
                blocks = list(m.resblocks[i * n_k : (i + 1) * n_k])
                x = x32.to(dtype)
                got = amp_stage_kernel(blocks, x, cfg.snake_logscale)
                want = amp_stage_plain(blocks, x, cfg.snake_logscale)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    err = float((got - want).abs().max())
                    errs["amp_stage"] = max(errs["amp_stage"], err)
                    ok = bool(torch.allclose(got, want, rtol=K2_FP32_RTOL, atol=K2_FP32_ATOL))
                    log({"phase": "k2_check", "stage": i, "shape": [1, c, t], "dtype": "fp32", "max_abs_err": err,
                         "max_abs_ref": float(want.abs().max()), "ok": ok})
                else:
                    err = rel_l2(got.float(), want.float())
                    ok = err <= BF16_REL_L2
                    log({"phase": "k2_check", "stage": i, "shape": [1, c, t], "dtype": "bf16", "rel_l2": err, "ok": ok})
                if not ok:
                    raise SystemExit(f"K2 disagrees with its plain stage at stage {i} {(c, t)} {dtype}")

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
        aa_snake.launches = 0
        amp_stage.launches = 0
        t0 = time.perf_counter()
        infer.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = {"aa_snake": aa_snake.launches, "amp_stage": amp_stage.launches}
        log({"phase": "cli", "seconds": cli_s, "launches": launches, "chunk_frames": chunk})
        if min(launches.values()) <= 0:
            raise SystemExit(f"the main path did not launch every kernel: {launches}")
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
            mel = infer.load_mel(root / "in" / "mel.npy", task, dev)
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

    # 4. Timing, bf16, CUDA events.
    entries = {}
    with torch.inference_mode():
        for b in (1, 16):
            x = torch.randn(b, c_post, t_post, device=dev, generator=gen).to(torch.bfloat16)
            p = model_bf16.activation_post.activation
            ms = cuda_ms(lambda: aa_snake_kernel(x, p.alpha, p.beta, True), 20)
            plain_ms = cuda_ms(lambda: aa_snake_plain(x, *snake_params(p.alpha, p.beta, True)), 5)
            comp_s, mem_s = k1_cost(b, c_post, t_post, 2)
            rec = {"metric": "k1_ms", "batch": b, "shape": [b, c_post, t_post], "dtype": "bf16", "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": 1e3 * max(comp_s, mem_s),
                   "bound_by": "operations" if comp_s >= mem_s else "bytes", "library_ms": None, **stamp}
            log(rec)
            entries.setdefault("aa_snake", {})[b] = rec

            # The forward's bound is the sum of the stages' bounds; it is set by
            # operations or bytes as the stages bound by each weigh in that sum.
            tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "operations": 0.0, "bytes": 0.0}
            for i, (c, t) in enumerate(stage_shapes(cfg)):
                blocks = list(model_bf16.resblocks[i * n_k : (i + 1) * n_k])
                xs = torch.randn(b, c, t, device=dev, generator=gen).to(torch.bfloat16)
                iters = 5 if b == 1 else 2
                ms = cuda_ms(lambda: amp_stage_kernel(blocks, xs, cfg.snake_logscale), iters)
                plain_ms = cuda_ms(lambda: amp_stage_plain(blocks, xs, cfg.snake_logscale), iters)
                lib_ms = cuda_ms(lambda: library_stage(blocks, xs, cfg.snake_logscale), iters)
                comp_s, mem_s = k2_cost(blocks, b, c, t, 2, BF16_TC_FLOPS)
                by = "operations" if comp_s >= mem_s else "bytes"
                log({"metric": "k2_stage_ms", "batch": b, "stage": i, "shape": [b, c, t], "dtype": "bf16", "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": 1e3 * max(comp_s, mem_s),
                     "bound_by": by, **stamp})
                for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms), (by, max(comp_s, mem_s))):
                    tot[key] += val
            rec = {"metric": "k2_forward_ms", "batch": b, "frames": F_FRAMES, "dtype": "bf16", "ms": tot["ms"],
                   "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
                   "bound_ms": 1e3 * (tot["operations"] + tot["bytes"]),
                   "bound_by": "operations" if tot["operations"] >= tot["bytes"] else "bytes", **stamp}
            log(rec)
            entries.setdefault("amp_stage", {})[b] = rec

            mel = torch.randn(b, cfg.num_mels, F_FRAMES, device=dev, generator=gen) - 5.0
            for dtype, m in ((torch.bfloat16, model_bf16), (torch.float32, model)):
                if dtype == torch.float32 and b != 1:
                    continue
                mel_d = mel.to(dtype)
                ms = cuda_ms(lambda: m(mel_d), 3 if b == 1 else 2, warmup=1)
                plain_ms = cuda_ms(lambda: m.forward_plain(mel_d), 2, warmup=1)
                audio_s = b * F_FRAMES * cfg.hop_length / task.sampling_rate
                log({"metric": "generator_ms", "batch": b, "frames": F_FRAMES,
                     "dtype": "bf16" if dtype == torch.bfloat16 else "fp32", "ms": ms, "plain_ms": plain_ms,
                     "audio_s_per_s": audio_s / (ms / 1e3), **stamp})

    k1, k2 = entries["aa_snake"][1], entries["amp_stage"][1]
    log({"kernels": [
        {"name": "aa_snake", "route": "cuda", "source": "vocoder_tpu_torch/csrc/aa_snake.cu",
         "replaces": "vocoder_tpu/ops/pallas/aa_snake.py:218", "launches": launches["aa_snake"],
         "max_abs_err": errs["aa_snake"], "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "amp_stage", "route": "cuda", "source": "vocoder_tpu_torch/csrc/amp_stage.cu",
         "replaces": "vocoder_tpu/ops/pallas/amp_block.py:590", "launches": launches["amp_stage"],
         "max_abs_err": errs["amp_stage"], "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]},
    ]})
    log({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
