"""K1's device time in its variants, on the card.

    python -m vocoder_tpu_torch.tools.k1_variants [--baseline DIR]   # from the repository root; one CUDA card

Builds copies of ``csrc/aa_snake.cu`` that differ in one design choice, times
each at ``activation_post``'s shape of the 44.1 kHz BigVGAN (C = 16, T = 512 *
256, alpha/beta from seed 0) in bf16 and fp32 at b1 and b16 with
``timing.device_time``, checks each against the plain version in fp32, and
prints one JSON line per variant and round:

- ``kernel``: the source as it is;
- ``global_x``: x read by the runs from device memory (``aa::GlobalX``), not
  staged in shared memory by a bulk copy;
- ``exact``: the plain version's arithmetic without contraction (``aa::Exact``,
  K2's prologue's) instead of FMAs;
- ``baseline``, with ``--baseline DIR``: another K1 with the same C entry,
  ``DIR/aa_snake.cu`` beside its own ``aa_snake.cuh`` (an earlier commit's,
  unpacked into a git-ignored directory).

The variants run in one order and then the reverse, so that a drift of the
card's clock over the run shows as a difference between the two rounds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from vocoder_tpu_torch.ops import aa_snake as k1
from vocoder_tpu_torch.ops import build
from vocoder_tpu_torch.tools.timing import build_variants, card_line, device_time, edit

# Each variant: the (text in csrc/aa_snake.cu, what replaces it) pairs that make it.
VARIANTS = {
    "global_x": [
        ("__shared__ __align__(16) TX xs[kTile + 2 * kHalo];", "__shared__ __align__(16) TX xs[1];"),
        ("const bool bulk = bulk_ok && p0 >= kHalo && p0 + kTile + kHalo <= L;", "const bool bulk = false;"),
        ("if (!bulk)  // clamped loads", "if (false)  // clamped loads"),
        ("<Arith, SharedX<TX>, StagedOut, false>{src,", "<Arith, aa::GlobalX<TX, false>, StagedOut, false>{{xrow, L},"),
        ("<Arith, SharedX<TX>, StagedOut, true>{src,", "<Arith, aa::GlobalX<TX, true>, StagedOut, true>{{xrow, L},"),
    ],
    "exact": [("using Arith = aa::Fma;", "using Arith = aa::Exact;")],
}


def variant_sources(baseline: Path | None) -> dict[str, tuple[str, Path]]:
    """The kernel, each variant and the baseline: name -> (source text, include directory)."""
    src = (build.CSRC / "aa_snake.cu").read_text()
    jobs = {"kernel": (src, build.CSRC)}
    for name, replacements in VARIANTS.items():
        jobs[name] = (edit(src, name, replacements), build.CSRC)
    if baseline is not None:
        jobs["baseline"] = ((baseline / "aa_snake.cu").read_text(), baseline)
    return jobs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="K1's device time in its variants, on the card")
    ap.add_argument("--baseline", type=Path, help="directory with another K1's aa_snake.cu and aa_snake.cuh")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 2
    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models.bigvgan import random_state_dict
    from vocoder_tpu_torch.ops.antialias import aa_snake_plain, snake_params

    card = card_line()
    libs = build_variants("k1_variants", variant_sources(args.baseline))
    cfg = build_task_config("bigvgan", "44100_512_2048").generator
    sd = random_state_dict(cfg, 0)
    alpha, beta = sd["activation_post.activation.alpha"].cuda(), sd["activation_post.activation.beta"].cuda()
    c, t = alpha.numel(), 256 * cfg.hop_length
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = {b: torch.randn(b, c, t, device="cuda", generator=gen) for b in (1, 16)}
    want = aa_snake_plain(xs[1], *snake_params(alpha, beta, True))
    order = list(libs)
    with torch.inference_mode():
        for rnd, names in enumerate((order, order[::-1])):
            for name in names:
                build._libs["aa_snake"] = ctypes.CDLL(libs[name])
                k1._lib.cache_clear()  # aa_snake_kernel launches through this library from now on
                got = k1.aa_snake_kernel(xs[1], alpha, beta, True)
                row = {"variant": name, "round": rnd, "card": card,
                       "fp32_b1_max_abs_err": float((got - want).abs().max())}
                for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
                    a, bt = alpha.to(dtype), beta.to(dtype)
                    for b, x in xs.items():
                        x = x.to(dtype)
                        ms, host_us = device_time(lambda: k1.aa_snake_kernel(x, a, bt, True))
                        row[f"{tag}_b{b}_ms"] = ms
                        row[f"{tag}_b{b}_host_us"] = host_us
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
