"""The vocos-huge cell's benchmark parts on the CPU: its counts against a hand count at the tiny size, its
three readers on hand-made events, the tiny cell through the runner, and a reference that loads nothing of
the port."""

import importlib.util
import subprocess
import sys
from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench.tests import tiny, tiny_vocos
from portbench.trace import WINDOW, Trace

MAIN = 1
READERS = ["mlp_roofline.synth", "non_mlp_ms_per_audio_s.synth", "head_ms_per_audio_s.synth"]


def _counts():
    spec = importlib.util.spec_from_file_location("flops_vocos", tiny.SRC / "flops" / "vocos-huge-44k.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forward_flops_by_hand():
    """Per frame: stem 16 x 8 x 7 = 896; transitions 8 x 16 + 16 x 24 + 24 x 32 = 1,280; blocks C (7 + 2 x 4C):
    8 x 71 = 568, 16 x 135 = 2,160, 3 x 24 x 199 = 14,328, 32 x 263 = 8,416; head 32 x 128 = 4,096; 31,744
    multiply-adds in all.  vocos-huge: 1.3016 GFLOP a frame, 97.3% of it the MLPs."""
    counts = _counts()
    assert counts.forward_flops(tiny_vocos.tiny_config(), 7) == 2 * 31_744 * 7
    huge = tiny_vocos.config_file()
    assert counts.forward_flops(huge, 1) == 1_301_596_736
    assert counts.mlp_bound_s(huge, 1, 1.0, 1e30) == pytest.approx(0.9733 * 1_301_596_736, rel=1e-4)


@pytest.mark.parametrize("frames,want", [
    (10, 2.848 + 9.792 + 3 * 20.832 + 35.968),  # bytes bind: 4 (2 R C + 2 C h + h + C) / 1e3 a block
    (1000, 102.4 + 409.6 + 3 * 921.6 + 1638.4),  # FLOPs bind: 4 R C h / 1e4 a block
])
def test_mlp_bound_by_hand(frames, want):
    assert _counts().mlp_bound_s(tiny_vocos.tiny_config(), frames, 1e4, 1e3) == pytest.approx(want, rel=1e-12)


def _trace():
    """One forward in a window of 1,000 ns: two stages with an MLP each, then the head."""
    host = [(0, 1000, WINDOW, MAIN), (100, 600, "gen.forward", MAIN),
            (110, 300, "gen.stage.0", MAIN), (120, 125, "cudaLaunchKernel", MAIN),
            (150, 250, "gen.mlp", MAIN), (160, 165, "cudaLaunchKernel", MAIN), (200, 205, "cudaLaunchKernel", MAIN),
            (310, 500, "gen.stage.1", MAIN), (320, 400, "gen.mlp", MAIN), (330, 335, "cudaLaunchKernel", MAIN),
            (420, 425, "cudaLaunchKernel", MAIN),
            (510, 590, "gen.head", MAIN), (520, 525, "cudaLaunchKernel", MAIN)]
    device = [(130, 160, "dwconv", 1), (170, 250, "gemm", 2), (250, 300, "gelu", 3), (340, 440, "gemm", 4),
              (440, 450, "mask", 5), (530, 600, "irfft", 6)]
    return Trace(host, device, {1: 120, 2: 160, 3: 200, 4: 330, 5: 420, 6: 520})


def _run(trace):
    seen = []

    def bound(cfg, frames, peak, bytes_per_s):
        seen.append((frames, peak, bytes_per_s))
        return frames * 1e-9

    return SimpleNamespace(trace=trace, traced_forwards=[[3, 2], [5]], counts=SimpleNamespace(mlp_bound_s=bound),
                           peaks={"flops": {"float32": 495e12}, "bytes_per_s": 3.35e12},
                           cfg={"dtype": "float32", "audio": {"hop_length": 100, "sampling_rate": 1000}}), seen


def _read(metric: str, run):
    return harness.Bench.load().reader(metric).read(run)


def test_readers_on_hand_made_events():
    run, seen = _run(_trace())  # 10 frames x 100 / 1000 Hz = 1 s of audio
    # MLPs: 80 + 50 + 100 ns; the stages 30 + 80 + 50 + 100 + 10; the head 70
    assert _read("mlp_roofline.synth", run) == pytest.approx(100 * 10e-9 / 230e-9)
    assert seen == [(5, 495e12, 3.35e12)] * 2
    assert _read("non_mlp_ms_per_audio_s.synth", run) == pytest.approx(1e3 * 40e-9)
    assert _read("head_ms_per_audio_s.synth", run) == pytest.approx(1e3 * 70e-9)


@pytest.mark.parametrize("metric", READERS)
def test_a_program_without_the_spans_reads_nothing(metric):
    host = [(0, 1000, WINDOW, MAIN), (100, 500, "portbench.forward", MAIN), (110, 120, "cudaLaunchKernel", MAIN)]
    run, _ = _run(Trace(host, [(130, 300, "gemm", 1)], {1: 110}))
    assert _read(metric, run) is None
    run.trace = None
    assert _read(metric, run) is None


def test_the_tiny_cell_runs_and_is_correct(tmp_path, run_tiny):
    root = tiny_vocos.make_root(tmp_path / "bench")
    result, run = run_tiny(tiny_vocos.CELL, root=root, seconds=4.0)
    assert result["correct"], result["checked"]
    assert set(result["metrics"]) == {"synth_audio_s_per_s", "setup_s"}
    result, run = run_tiny(tiny_vocos.CELL, root=root, trace=True, seconds=4.0)
    assert result["correct"], result["checked"]
    names = {r[2] for r in spans.ranges(run.trace, spans.starting("gen."))}
    assert names == {"gen.forward", "gen.stage.0", "gen.stage.1", "gen.stage.2", "gen.stage.3", "gen.mlp",
                     "gen.head"}
    assert not set(READERS) & set(result["metrics"])  # no device operation on the CPU


REFERENCE_ONLY = """
import sys
import torch
from portbench import weights
from portbench.reference import ops, vocos
from portbench.tests.tiny_vocos import tiny_config
gen = tiny_config()["generator"]
p = weights.state_dict(vocos.shapes(gen), lambda k: vocos.init(gen, k), 1, "generator", "cpu")
vocos.forward(p, torch.randn(1, 16, 9), gen, ops.Precision("tf32"))
print("FOUND", sorted({m.split(".")[0] for m in sys.modules} & {"vocoder_tpu", "vocoder_tpu_torch", "jax", "jaxlib"}))
"""


def test_the_reference_loads_nothing_of_the_port():
    out = subprocess.run([sys.executable, "-c", REFERENCE_ONLY], cwd=tiny.SRC.parent, capture_output=True, text=True,
                         timeout=240, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(tiny.SRC.parent),
                                           "HOME": str(tiny.SRC.parent / "build")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert [line for line in out.stdout.splitlines() if line.startswith("FOUND")][-1] == "FOUND []"
