"""A configuration, a traffic mix and a per-layer metric are added as new files and entries alone."""

import json
import shutil

from portbench.tests import tiny


def test_new_config_mix_and_metric_from_files(tmp_path, run_tiny):
    root = tiny.make_root(tmp_path / "bench")
    cfg = tiny.tiny_config("bigvgan-44k")
    cfg["generator"]["upsample_initial_channel"] = 32
    (root / "configs" / "bigvgan-narrow.json").write_text(json.dumps(cfg))
    shutil.copy(root / "flops" / "bigvgan-44k.py", root / "flops" / "bigvgan-narrow.py")
    mix = tiny.tiny_traffic("synth-b16")
    mix["batch"] = 3
    (root / "traffic" / "synth-b3.json").write_text(json.dumps(mix))
    (root / "metrics" / "forwards.synth.py").write_text(
        '"""Forwards in the traced window."""\n\n\ndef read(run):\n'
        '    return float(len(run.traced_forwards)) or None\n')
    cell = "bigvgan-narrow.synth-b3"
    shutil.copy(root / "limits" / "bigvgan-44k.synth-b16.json", root / "limits" / f"{cell}.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({**spec["configs"][0], "name": "bigvgan-narrow",
                            "file": "portbench/configs/bigvgan-narrow.json"})
    spec["workloads"].append({"name": cell, "config": "bigvgan-narrow", "traffic": "synth-b3", "chips": 1,
                              "why": "a narrower BigVGAN in groups of three"})
    e2e = next(m for m in spec["end_to_end"] if m["name"] == "synth_audio_s_per_s")
    e2e["workloads"].append(cell)
    spec["per_layer"].append({"name": "forwards.synth", "unit": "count", "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "synth_audio_s_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    result, run = run_tiny(cell, root=root, trace=True, seconds=5.0)
    assert result["correct"], result["checked"]
    assert result["metrics"]["forwards.synth"]["value"] == len(run.traced_forwards) > 0
    assert all(len(f) <= 3 for f in run.traced_forwards)
    result, run = run_tiny(cell, root=root, trace=False, seconds=2.0)
    assert set(result["metrics"]) == {"synth_audio_s_per_s", "setup_s"}
