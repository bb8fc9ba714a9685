"""What a run loads: nothing of JAX or of the JAX package; the references nothing of the port.

Each check runs in a fresh interpreter, since this process has imported both packages' tests' worth of
modules."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

REHEARSAL = """
import sys, tempfile, time
from pathlib import Path
import torch
from portbench import harness
from portbench.run import forbidden_modules, run_cell
from portbench.tests import tiny
root = tiny.make_root(Path(tempfile.mkdtemp()))
bench = harness.Bench.load(root / "BENCHMARK.json", root)
result, _ = run_cell(bench, "bigvgan-44k.synth-b16", 2**31 + 5, 5.0, True, torch.device("cpu"), time.time(), None)
assert "vocoder_tpu_torch" in sys.modules
print("FOUND", forbidden_modules())
"""

REFERENCE_ONLY = """
import sys
import torch
from portbench import weights
from portbench.reference import bigvgan, gan, hifigan, ops
from portbench.tests.tiny import tiny_config
cfg = tiny_config("bigvgan-44k")
pg = weights.state_dict(bigvgan.shapes(cfg["generator"]), lambda k: bigvgan.init(cfg["generator"], k), 1, "g", "cpu")
pd = weights.state_dict(gan.shapes(cfg["train"]), gan.init, 1, "d", "cpu")
audio = 0.1 * torch.randn(2, 1, cfg["train"]["num_frames"] * cfg["audio"]["hop_length"])
gan.train_steps(bigvgan.forward, pg, pd, [(audio, torch.full((2,), audio.shape[-1]), 3)], cfg, ops.Precision("fp32"))
hcfg = tiny_config("hifigan-44k")
ph = weights.state_dict(hifigan.shapes(hcfg["generator"]), lambda k: hifigan.init(hcfg["generator"], k), 1, "h", "cpu")
hifigan.forward(ph, torch.randn(1, 16, 9), hcfg["generator"], ops.Precision("tf32"))
print("FOUND", sorted({m.split(".")[0] for m in sys.modules} & {"vocoder_tpu", "vocoder_tpu_torch", "jax", "jaxlib"}))
"""


def _found(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=240,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(REPO / "build")})
    assert out.returncode == 0, out.stderr[-3000:]
    return [line for line in out.stdout.splitlines() if line.startswith("FOUND")][-1]


def test_a_rehearsed_run_loads_neither_jax_nor_the_jax_package():
    assert _found(REHEARSAL) == "FOUND []"


def test_the_references_load_nothing_of_the_port():
    assert _found(REFERENCE_ONLY) == "FOUND []"
