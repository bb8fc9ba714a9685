"""The lower-precision control comes out as not correct: the fp32 reference's TF32 twin in the program's place.

On the CPU, which has no TF32, the control's convolutions round their operands to TF32 themselves
(``reference.ops.Precision``); on the card ``portbench/control.py`` reads the same at the cells' own sizes."""

import pytest

from portbench import check, harness
from portbench.reference.ops import Precision


@pytest.mark.parametrize("workload", ["bigvgan-44k.synth-b16", "hifigan-44k.synth-b16", "bigvgan-44k.request-b1",
                                      "bigvgan-44k.train-b16"])
def test_tf32_control_fails_the_limits(workload, run_tiny, tiny_root):
    result, run = run_tiny(workload, seconds=2.0)
    assert result["correct"], result["checked"]
    runner = harness.kind(run.traffic["kind"])
    ref = runner.reference(run, Precision("fp32"))
    control = runner.compare(run, ref, runner.reference(run, Precision("tf32")))
    correct, table = check.judge(control, harness.Bench.load(tiny_root / "BENCHMARK.json", tiny_root).limits(workload))
    assert not correct, table
