"""Timing on the card, shared by ``chip_smoke.py`` and the tools beside this module.

- ``cuda_ms``: CUDA-event ms per call of a function, as the host queues the calls.
- ``device_time``: the card's ms per call with the host out of the window, and
  the host's µs per call.
- ``build_variants``: compile copies of a kernel source in parallel, each a
  text edit of it, for the tools that time a kernel's variants.
- ``card_line``: the card's name and power limit, as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import subprocess
import time
from pathlib import Path

import torch

from vocoder_tpu_torch.ops import build


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """ms per call of ``fn`` between two CUDA events around ``iters`` calls, after ``warmup``."""
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


def device_time(fn, n: int = 50) -> tuple[float, float]:
    """(card ms, host µs) per call of ``fn``, which queues work on the current stream.

    The n calls are queued behind a spin kernel (``torch.cuda._sleep``) that
    outlasts their queueing, so the card runs them back to back and the events
    around them hold the card's time alone, gaps between launches included.
    The host time is that of queueing one call, taken with the card idle."""
    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - h0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = int(4e9 * host_s) + 1_000_000  # twice the queueing time at up to 2 GHz
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        spun_out = start.query()  # the spin ended before the last call was queued
        torch.cuda.synchronize()
        if not spun_out:
            return start.elapsed_time(end) / n, 1e6 * host_s / n
        cycles *= 4
    raise RuntimeError("device_time: the host did not queue the calls ahead of the card")


def edit(src: str, name: str, replacements) -> str:
    """``src`` with each (old, new) of ``replacements`` applied; each old must occur exactly once."""
    for old, new in replacements:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer has exactly one {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(out_dir: str, jobs: dict[str, tuple[str, Path]]) -> dict[str, str]:
    """Compile each job, name -> (CUDA source text, include directory), with its own nvcc, all in
    parallel, into ``build/kernels/<out_dir>``; name -> shared library path.  Each nvcc log lands
    beside its library."""
    out = build.BUILD_DIR / out_dir
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, include) in jobs.items():
        cu, lib = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(include), "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = str(lib)
    return libs
