"""The program-span reductions (``portbench/spans.py``) and their seven readers, on hand-made events."""

import pytest

from portbench import harness, spans
from portbench.trace import WINDOW, Trace

MAIN, AUTOGRAD = 1, 2


def _forward_trace():
    """Two forwards in a window of 1,000 ns on the window's thread; a stage on another thread."""
    host = [(0, 1000, WINDOW, MAIN),
            (100, 500, "gen.forward", MAIN),
            (110, 150, "gen.up.0", MAIN), (120, 125, "cudaLaunchKernel", MAIN),
            (160, 300, "gen.stage.0", MAIN), (170, 175, "cudaLaunchKernel", MAIN),
            (200, 205, "cudaLaunchKernel", MAIN),
            (550, 900, "gen.forward", MAIN),
            (560, 620, "gen.up.1", MAIN), (570, 575, "cudaLaunchKernel", MAIN),
            (650, 800, "gen.stage.1", MAIN),
            (5, 40, "gen.stage.9", AUTOGRAD), (10, 15, "cudaLaunchKernel", AUTOGRAD)]
    device = [(130, 180, "dgrad_engine", 1),  # launched in gen.up.0, runs after it
              (180, 350, "amp_conv_mma_kernel", 2),  # launched in gen.stage.0, runs past its end
              (350, 420, "amp_conv_mma_kernel", 3),
              (640, 660, "dgrad_engine", 4),
              (20, 30, "other", 5)]  # launched on the other thread
    return Trace(host, device, {1: 120, 2: 170, 3: 200, 4: 570, 5: 10})


def _train_trace():
    host = [(0, 1000, WINDOW, MAIN),
            (50, 600, "portbench.g_phase", MAIN),
            (100, 300, "train.g.update", MAIN), (150, 160, "cudaStreamSynchronize", MAIN),
            (200, 210, "cudaDeviceSynchronize", AUTOGRAD), (220, 225, "cudaLaunchKernel", MAIN),
            (400, 500, "train.d.update", MAIN), (450, 455, "cudaEventSynchronize", MAIN),
            (460, 465, "cudaLaunchKernel", MAIN),
            (550, 560, "cudaStreamSynchronize", MAIN),  # inside the benchmark's range, outside the program's
            (700, 800, "train.g.backward", MAIN), (710, 715, "cudaLaunchKernel", MAIN)]
    device = [(0, 100, "before", 9), (230, 330, "adam", 1), (470, 490, "adam", 2), (720, 1000, "bwd", 3)]
    return Trace(host, device, {1: 220, 2: 460, 3: 710})


class _Run:
    def __init__(self, trace, traced_forwards=(), traced_steps=0):
        self.trace, self.traced_forwards, self.traced_steps = trace, list(traced_forwards), traced_steps
        self.cfg = {"audio": {"hop_length": 100, "sampling_rate": 1000}}


def _read(metric: str, run):
    return harness.Bench.load().reader(metric).read(run)


def test_device_time_under_a_prefix_follows_the_launch():
    t = _forward_trace()
    assert spans.device_s_under(t, spans.starting("gen.up.")) == pytest.approx(70e-9)  # 50 + 20
    assert spans.device_s_under(t, spans.starting("gen.stage.")) == pytest.approx(250e-9)  # 170 + 70 + 10
    assert spans.device_s_under(t, spans.named("gen.forward")) == pytest.approx(310e-9)
    assert spans.device_s_under(t, spans.starting("train.")) is None
    assert spans.device_s_under(Trace(t.host, [], {}), spans.starting("gen.")) is None  # no device operation


def test_host_durations_of_a_range():
    t = _forward_trace()
    assert spans.median_host_ms(t, "gen.forward") == pytest.approx(375e-6)  # of 400 and 350 ns
    assert spans.median_host_ms(t, "gen.up.1") == pytest.approx(60e-6)
    assert spans.median_host_ms(t, "train.g.update") is None


def test_idle_gaps_go_to_the_innermost_program_span_on_the_windows_thread():
    t = _forward_trace()
    # busy [20, 30), [130, 420), [640, 660): gaps [0, 20), [30, 130) (inside gen.stage.9, but on another
    # thread), [420, 640), [660, 1000)
    by_span = spans.idle_s_by_span(t, spans.starting("gen."))
    assert by_span == {"gen.forward": pytest.approx(220e-9),  # [420, 640) begins in the first forward
                       "gen.up.0": 0, "gen.stage.0": 0, "gen.up.1": 0,
                       "gen.stage.1": pytest.approx(340e-9)}  # [660, 1000) begins in stage 1
    assert spans.idle_s_by_span(t, spans.named("gen.forward")) == {"gen.forward": pytest.approx(560e-9)}
    assert spans.idle_share_in(t, spans.named("gen.forward")) == pytest.approx(56.0)
    assert spans.idle_s_by_span(t, spans.starting("train.")) is None


def test_sync_calls_inside_program_spans_on_any_thread():
    t = _train_trace()
    assert spans.sync_calls(t, spans.starting("train.")) == 3  # not the one in portbench.g_phase alone
    assert spans.sync_calls(t, spans.named("train.d.update")) == 1
    assert spans.sync_calls(_forward_trace(), spans.starting("train.")) is None


def test_forward_readers_normalise_by_the_traced_audio():
    run = _Run(_forward_trace(), traced_forwards=[[3, 2], [5]])  # 10 frames x 100 / 1000 Hz = 1 s
    assert spans.traced_audio_s(run) == pytest.approx(1.0)
    assert _read("upsample_ms_per_audio_s.synth", run) == pytest.approx(70e-6)
    assert _read("stage_ms_per_audio_s.synth", run) == pytest.approx(250e-6)
    assert _read("forward_host_ms.request", run) == pytest.approx(375e-6)
    assert _read("forward_idle_share.request", run) == pytest.approx(56.0)


def test_train_readers_per_step():
    run = _Run(_train_trace(), traced_steps=2)
    assert _read("train.update_ms", run) == pytest.approx(1e3 * 120e-9 / 2)
    assert _read("train.syncs_per_step", run) == pytest.approx(1.5)
    # gaps: [100, 230) begins in train.g.update, [330, 470) in none, [490, 720) in train.d.update
    assert _read("update_idle_share.train", run) == pytest.approx(36.0)


NEW = ["upsample_ms_per_audio_s.synth", "stage_ms_per_audio_s.synth", "forward_host_ms.request",
       "forward_idle_share.request", "train.update_ms", "update_idle_share.train", "train.syncs_per_step"]


@pytest.mark.parametrize("metric", NEW)
def test_a_program_without_spans_reads_nothing(metric):
    """A trace with only the benchmark's own ranges (a program before these spans): every reader gives None,
    and so does a run with no trace."""
    host = [(0, 1000, WINDOW, MAIN), (100, 500, "portbench.forward", MAIN), (110, 120, "cudaLaunchKernel", MAIN),
            (200, 210, "cudaStreamSynchronize", MAIN)]
    trace = Trace(host, [(130, 300, "amp_conv_mma_kernel", 1)], {1: 110})
    assert _read(metric, _Run(trace, traced_forwards=[[4]], traced_steps=1)) is None
    assert _read(metric, _Run(None, traced_forwards=[[4]], traced_steps=1)) is None


def test_tiny_traced_runs_read_the_programs_spans(run_tiny):
    """The port's own spans reach the readers through a traced run (on the CPU, no device operation: the
    host readers give numbers, the device ones nothing)."""
    result, run = run_tiny("bigvgan-44k.request-b1", trace=True, seconds=4.0)  # the first cycle on a busy host
    metrics = result["metrics"]
    assert spans.ranges(run.trace, spans.starting("gen.up.", "gen.stage."))
    assert metrics["forward_host_ms.request"]["value"] > 0
    assert "forward_idle_share.request" not in metrics
    result, run = run_tiny("bigvgan-44k.train-b16", trace=True, seconds=4.0)
    names = {r[2] for r in spans.ranges(run.trace, spans.starting("train."))}
    assert names == {"train.g.forward", "train.g.loss", "train.g.backward", "train.g.update", "train.d.loss",
                     "train.d.backward", "train.d.update"}
    assert result["metrics"]["train.syncs_per_step"]["value"] == 0.0
    assert "train.update_ms" not in result["metrics"]
