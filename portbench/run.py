"""Run one cell of the benchmark and print its result as one JSON line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this directory and
the port (``vocoder_tpu_torch``).  The cell's configuration, traffic mix,
counts, metrics and limits are found by the names in ``BENCHMARK.json``
(``harness.py``).  Set-up (imports, the kernels' build in a fresh checkout,
weights and inputs from the seed, a warm-up of every shape of the mix) runs
before the window; the window drives the program for ``--seconds``; then the
program's state is freed and the plain reference checks its outputs.  With
``--trace 1`` the profiler records the first ``trace_seconds`` of the mix's
window, and the line carries the cell's per-layer metrics, the device's busy
and window seconds and a breakdown; with ``--trace 0`` its end-to-end metrics.

Exits 2 without a result when no CUDA card (or fewer than the cell asks for)
is present, and 3 when a module of JAX or of the JAX package is loaded once
the window has closed.  Every build and kernel cache lives under ``build/``
in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "vocoder_tpu")


def _pin_caches() -> None:
    """Every compiler cache at a fixed path inside the checkout (the port's kernels build into
    ``build/kernels`` there by themselves)."""
    build = CHECKOUT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def process_start() -> float:
    """This process's start on the epoch clock (from /proc), or now where /proc has no answer."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        boot = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(bench, workload: str, seed: int, seconds: float, trace: bool, device, t_process: float,
             peaks: dict | None) -> tuple[dict, "object"]:
    """Run the cell; (the result's fields, the ``Run`` record)."""
    from portbench import check, harness
    from portbench.reference.ops import Precision
    from portbench.trace import Tracer

    run = harness.Run(bench, workload, seed, t_process, peaks)
    run.mark("imports")
    runner = harness.kind(run.traffic["kind"])
    tracer = Tracer(trace, run.traffic.get("trace_seconds", seconds))
    runner.execute(run, device, seconds, tracer)
    readings = runner.compare(run, runner.reference(run, Precision("fp32")))
    correct, table = check.judge(readings, bench.limits(workload))
    run.failed = 0 if correct else 1
    metrics = {}
    wanted = bench.per_layer(workload) if trace else bench.end_to_end(workload)
    for m in wanted:
        value = bench.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics}
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_ops(10), "idle_gaps": run.trace.idle_gaps(10)}
    result["checked"] = table
    return result, run


def main(argv=None) -> int:
    t_process = process_start()
    _pin_caches()
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.peaks import PEAKS

    bench = harness.Bench.load(CHECKOUT / "BENCHMARK.json")
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    name = torch.cuda.get_device_name(0)
    result, run = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                           t_process, PEAKS.get(name))
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}, which the port must not use", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": name, "count": chips, "memory_peak_bytes": run.peak_bytes}
    if args.trace and run.trace is not None:
        device.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
    print("set-up: " + ", ".join(f"{step} at {t:.2f} s" for step, t in run.marks), file=sys.stderr)
    checked = result.pop("checked")
    out = {**result, "device": device, "card": _card_line(), "checked": checked}
    for key, row in checked.items():
        print(f"check {key} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def _card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


if __name__ == "__main__":
    sys.exit(main())
