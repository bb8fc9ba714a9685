"""The program's spans on the card: every cell's traced run prints its span metrics, and spans share the
device trace's clock.

Marked ``cuda``; skips without a card (decided inside the fixture).  Run on the card machine:
``python -m pytest portbench/tests/test_pb_card_spans.py -m cuda -p no:cacheprovider``."""

import bisect
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SPAN_METRICS = {"upsample_ms_per_audio_s.synth", "stage_ms_per_audio_s.synth", "forward_host_ms.request",
                "forward_idle_share.request", "train.update_ms", "update_idle_share.train", "train.syncs_per_step"}
SEED = 2**31 + 4243


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_traced_cell_prints_its_span_metrics(card, workload):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", str(SEED),
                          "--seconds", "5", "--trace", "1"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checked"]
    wanted = {m["name"] for m in SPEC["per_layer"] if workload in m["workloads"] and m["name"] in SPAN_METRICS}
    assert wanted, workload
    for name in wanted:
        assert isinstance(line["metrics"][name]["value"], float), name
    if workload == "bigvgan-44k.train-b16":
        assert line["metrics"]["aa_snake_bwd_share.train"]["value"] > 0


def _traced(workload: str, seconds: float):
    """The ``Run`` of one traced run of ``workload`` in this process."""
    import torch

    from portbench import harness
    from portbench.peaks import PEAKS
    from portbench.run import run_cell

    bench = harness.Bench.load(REPO / "BENCHMARK.json")
    _, run = run_cell(bench, workload, SEED, seconds, True, torch.device("cuda"), time.time(),
                      PEAKS.get(torch.cuda.get_device_name(0)))
    return run


@pytest.mark.cuda
def test_work_launched_in_a_forward_starts_after_the_span_does(card):
    """Device operations launched inside a ``gen.forward`` span start at or after the span's start, on the
    trace's clock, give or take the lead of the trace's device clock over its own launch calls (an operation
    cannot start before the call that launched it; where the trace says one does, the device timestamps
    lead the host's by that much, and no span can be held to better).  The spans and the launch calls are
    both host records on one clock: each launch attributed to a span lies inside the span."""
    from portbench import spans

    trace = _traced("bigvgan-44k.request-b1", 3).trace
    forwards = spans.ranges(trace, spans.named("gen.forward"))
    assert forwards
    starts = [s for s, _, _, _ in forwards]
    lead = max(0, max(trace.launched_at[c] - s for s, _, _, c in trace.device if c in trace.launched_at))
    checked = early = 0
    for s, _, name, corr in trace.device:
        at = trace.launched_at.get(corr)
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= forwards[i][1]:
            assert s >= forwards[i][0] - lead, (name, s, forwards[i], lead)
            checked += 1
            early += s < forwards[i][0]
    assert checked > 0
    print(f"device operations launched in a forward: {checked}; starting before it: {early}; "
          f"the device clock's lead over the launches: {lead} ns")


@pytest.mark.cuda
def test_k2_kernels_fall_inside_the_stage_spans(card):
    """K2 launches through ctypes on the runtime its library links; its kernels are attributed to the
    ``gen.stage.{i}`` span that launched them."""
    from portbench import spans

    run = _traced("bigvgan-44k.synth-b16", 3)
    k2 = run.trace.device_s(lambda name: "amp_conv_mma" in name)
    stage_s = spans.device_ms_per_audio_s(run, spans.starting("gen.stage.")) * spans.traced_audio_s(run) / 1e3
    assert k2 > 0
    assert stage_s >= k2 * (1 - 1e-9)
