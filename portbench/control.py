"""The readings that a cell's limits are set from, on the card; the benchmark's runs never run this.

    python3 -m portbench.control --workload <name> [--seeds 12] [--controls 3] [--seconds 4]

For each seed, the cell's set-up and a short window at the cell's own sizes
and load, then the check's numbers of the program against the fp32
reference: over a dozen seeds their largest is the lower reading of each
limit.  On the first ``--controls`` seeds also the control's numbers: the
reference in the nearest precision below the configuration's (fp32 with TF32
off -> TF32) put in the program's place and held against the fp32 reference;
and for a training cell the fault of half the batch left out (the mean taken
over the other half), planted in the reference put in the program's place.
Each seed prints one JSON line; the last line gives, for each number, the
largest program reading and the smallest control and fault readings.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time

import torch

from portbench import check, harness
from portbench.peaks import PEAKS
from portbench.reference.ops import Precision
from portbench.run import CHECKOUT, process_start
from portbench.trace import Tracer

SEED0 = 2**31 + 1013


def worst_leaves(run, ref: dict, n: int = 4) -> dict:
    """The training check's worst leaves: (gap, leaf, its reference gradient norm over its module's median)."""
    prog, out = run.kept["program"], {}
    for module, keys in run.kept["modules"].items():
        med = statistics.median(ref["first_grads"][k] for k in keys)
        for part in ("first_grads", "changes"):
            out[f"{module}.{part}"] = [(g, k, ref["first_grads"][k] / med)
                                       for g, k in check.leaf_gaps(prog[part], ref[part], keys)[:n]]
    return out


def readings(bench, workload: str, seed: int, seconds: float, control: bool, detail: bool = False) -> dict:
    run = harness.Run(bench, workload, seed, process_start(), PEAKS.get(torch.cuda.get_device_name(0)))
    runner = harness.kind(run.traffic["kind"])
    t0 = time.perf_counter()
    runner.execute(run, torch.device("cuda"), seconds, Tracer(False, 0))
    t1 = time.perf_counter()
    ref = runner.reference(run, Precision("fp32"))
    out = {"seed": seed, "program": runner.compare(run, ref), "window_s": t1 - t0,
           "reference_s": time.perf_counter() - t1}
    if detail and run.traffic["kind"] == "train_steps":
        out["worst"] = worst_leaves(run, ref)
    if control:
        out["control"] = runner.compare(run, ref, runner.reference(run, Precision("tf32")))
        if run.traffic["kind"] == "train_steps":
            half = slice(0, run.traffic["batch"] // 2)
            out["half_batch"] = runner.compare(run, ref, runner.reference(run, Precision("fp32"), rows=half))
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings for a cell's limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--first-seed", type=int, default=SEED0)
    ap.add_argument("--detail", action="store_true", help="a training cell's worst leaves, each seed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.Bench.load(CHECKOUT / "BENCHMARK.json")
    rows = []
    for i in range(args.seeds):
        rows.append(readings(bench, args.workload, args.first_seed + 7919 * i, args.seconds, i < args.controls,
                             args.detail))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows)}
    for key in rows[0]["program"]:
        summary[key] = {"lower": max(r["program"][key] for r in rows)}
        for part in ("control", "half_batch"):
            got = [r[part][key] for r in rows if part in r]
            if got:
                summary[key][part] = min(got)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
