"""Fixtures of the benchmark's CPU tests: a tiny benchmark directory and a helper that runs a cell in it."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench.run import run_cell
from portbench.tests import tiny


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("portbench_tiny"))


@pytest.fixture
def run_tiny(tiny_root):
    """run_tiny(workload, seed=..., trace=False, root=tiny_root) -> (result, run) on the CPU."""

    def go(workload: str, seed: int = 2**31 + 77, trace: bool = False, root=None, seconds: float = 1.0):
        root = root or tiny_root
        bench = harness.Bench.load(root / "BENCHMARK.json", root)
        return run_cell(bench, workload, seed, seconds, trace, torch.device("cpu"), time.time(), None)

    return go
