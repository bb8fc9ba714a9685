"""The traced window's reductions on hand-made events: busy union, idle gaps by host call, launch ranges."""

import pytest

from portbench import reduce
from portbench.trace import WINDOW, Trace


def _trace():
    host = [(0, 1000, WINDOW, 1),
            (100, 400, "portbench.forward", 1), (110, 120, "cudaLaunchKernel", 1), (130, 140, "cudaLaunchKernel", 1),
            (500, 900, "aa_snake_backward", 1), (510, 520, "cudaLaunchKernel", 1),
            (600, 800, "portbench.d2h", 1), (610, 790, "cudaMemcpyAsync", 1)]
    device = [(150, 300, "amp_conv_mma_kernel", 7), (250, 350, "conv", 8), (550, 600, "elementwise", 9),
              (950, 1200, "late", 10)]
    return Trace(host, device, {7: 110, 8: 130, 9: 510})


def test_busy_and_window():
    t = _trace()
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_intervals() == [(150, 350), (550, 600), (950, 1000)]
    assert t.busy_s() == pytest.approx(300e-9)
    assert t.device_s(lambda n: "amp_conv_mma" in n) == pytest.approx(150e-9)
    assert t.device_s_under("aa_snake_backward") == pytest.approx(50e-9)
    assert t.device_s_under("portbench.forward") == pytest.approx(250e-9)


def test_idle_gaps_by_host_call_and_top_ops():
    t = _trace()
    gaps = dict(t.idle_gaps())
    assert gaps == {"host between calls": pytest.approx(150e-9),  # [0, 150): inside no call yet
                    "portbench.forward": pytest.approx(200e-9),  # [350, 550): the forward's range still open
                    "portbench.d2h": pytest.approx(350e-9)}  # [600, 950): the copy's range had just begun
    assert t.top_ops(2) == [["amp_conv_mma_kernel", pytest.approx(150e-9)], ["conv", pytest.approx(100e-9)]]


class _Run:
    def __init__(self, trace):
        self.trace, self.peaks, self.cfg = trace, {"flops": {"float32": 1e12}, "bytes_per_s": 1e9}, {"dtype": "float32"}


def test_idle_share_and_mfu():
    run = _Run(_trace())
    assert reduce.idle_share(run) == pytest.approx(70.0)
    assert reduce.mfu(run, 5e5) == pytest.approx(50.0)  # 5e5 FLOP in 1 us at 1 TFLOP/s
    assert reduce.quantile(range(1, 101), 0.95) == pytest.approx(95.95)
