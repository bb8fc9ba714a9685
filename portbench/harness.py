"""The benchmark's data, found by name, and the record of one run.

``Bench`` reads ``BENCHMARK.json`` and finds what belongs to a cell in files
of its own under the benchmark's directory: ``configs/<config>.json``,
``traffic/<mix>.json`` (whose ``kind`` names the runner in ``kinds/``),
``flops/<config>.py``, ``metrics/<metric>.py`` and ``limits/<workload>.json``.
A cell, a configuration, a mix or a metric is added by adding files and
entries; no file here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import time
from pathlib import Path

from portbench import check, traffic

ROOT = Path(__file__).resolve().parent


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json``'s entries, with each name's files under ``root``."""

    def __init__(self, spec: dict, root: Path = ROOT):
        self.spec, self.root = spec, Path(root)

    @classmethod
    def load(cls, path: Path = ROOT.parent / "BENCHMARK.json", root: Path = ROOT) -> "Bench":
        return cls(json.loads(Path(path).read_text()), root)

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r}; there are {[w['name'] for w in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        return json.loads((self.root / "configs" / f"{name}.json").read_text())

    def traffic(self, mix: str) -> dict:
        return traffic.load(self.root, mix)

    def counts(self, config: str):
        return _module(self.root / "flops" / f"{config}.py", f"portbench_flops_{config}")

    def reader(self, metric: str):
        return _module(self.root / "metrics" / f"{metric}.py", f"portbench_metric_{metric}")

    def limits(self, workload: str) -> dict:
        return check.load_limits(self.root, workload)

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.spec["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def kind(name: str):
    return importlib.import_module(f"portbench.kinds.{name}")


class Run:
    """What one run of a cell did: set-up and window times, work counts, the traced window and the
    outputs kept for the check.  Metric readers read it (``reduce.py``)."""

    def __init__(self, bench: Bench, workload: str, seed: int, t_process: float, peaks: dict | None):
        w = bench.workload(workload)
        self.workload, self.seed, self.t_process, self.peaks = workload, seed, t_process, peaks
        self.cfg, self.traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
        self.counts = bench.counts(w["config"])
        self.ref = importlib.import_module(f"portbench.reference.{self.cfg['reference']}")
        self.setup_s = self.window_s = self.audio_s = None
        self.attempted = self.failed = 0
        self.request_ms: list[float] = []
        self.g_phase_ms: list[float] = []
        self.d_phase_ms: list[float] = []
        self.traced_forwards: list[list[int]] = []  # each traced forward's items' frames
        self.traced_steps = 0
        self.peak_bytes = 0  # the process's peak device memory up to the window's end
        self.window_peak_bytes = None  # the peak inside the window
        self.trace = None
        self.kept = None  # the program's outputs kept for the check
        self.marks: list[tuple[str, float]] = []  # (set-up step, seconds since the process started)

    def mark(self, step: str) -> None:
        """Note that set-up step ``step`` has ended (printed on standard error, not a metric)."""
        self.marks.append((step, time.time() - self.t_process))

    def window_started(self) -> float:
        """Mark the window's start: set-up ends here.  Returns the host clock (``perf_counter``)."""
        self.setup_s = time.time() - self.t_process
        return time.perf_counter()
