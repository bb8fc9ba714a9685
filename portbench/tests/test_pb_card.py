"""Every cell on the card for a few seconds, each mode: the last line holds the result's keys, exactly.

Marked ``cuda``; skips without a card (decided inside the fixture).  Run on the card machine:
``python -m pytest portbench/tests/test_pb_card.py -m cuda -p no:cacheprovider``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
TOP = {"correct", "attempted", "failed", "metrics", "device", "card", "checked"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_prints_the_contracts_line(card, workload, trace):
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", str(2**31 + 4242),
                          "--seconds", "5", "--trace", str(trace)], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) == TOP | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checked"
    assert set(line["device"]) == DEVICE | ({"busy_s", "window_s"} if trace else set())
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["correct"] is True, line["checked"]
    e2e = {m["name"] for m in spec["end_to_end"] if workload in m.get("workloads", [workload])}
    layer = {m["name"] for m in spec["per_layer"] if workload in m["workloads"]}
    assert set(line["metrics"]) == (layer if trace else e2e)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        shares = [v["value"] for k, v in line["metrics"].items() if "roofline" in k or "mfu" in k]
        assert all(0 < s <= 100 for s in shares)
