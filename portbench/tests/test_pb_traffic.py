"""The traffic generator: the same inputs from the same seed, other inputs from another, lengths as stated."""

import json

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.tests import tiny

CFG = json.loads((tiny.SRC / "configs" / "bigvgan-44k.json").read_text())


def test_lengths_are_the_stated_distribution():
    spec = traffic.load(tiny.SRC, "synth-b16")["lengths"]
    seconds = traffic.utterance_seconds(spec)
    assert len(seconds) == 256 and np.all(np.diff(seconds) >= 0)
    assert seconds.min() == pytest.approx(1.0) and seconds.max() == pytest.approx(20.0)
    inner = seconds[(seconds > 1.0) & (seconds < 20.0)]
    # The log-normal's quantiles: mean 5.85 s before clipping, sigma 0.6 of the log.
    assert np.mean(seconds) == pytest.approx(5.85, rel=0.03)
    assert np.std(np.log(inner)) == pytest.approx(0.6, rel=0.12)
    assert np.median(seconds) == pytest.approx(5.85 * np.exp(-0.18), rel=0.02)
    frames = traffic.utterance_frames(spec, CFG["audio"])
    assert frames.min() == 86 and frames.max() == 1723  # 1 s and 20 s at 86.13 frames a second


@pytest.mark.parametrize("mix", ["synth-b16", "request-b1"])
def test_utterance_inputs_follow_the_seed(mix):
    cfg, spec = tiny.tiny_config("bigvgan-44k"), tiny.tiny_traffic(mix)
    if spec["kind"] == "offline_batches":
        a, b, c = (traffic.offline_jobs(spec, cfg, s, "cpu") for s in (5, 5, 6))
        flat = [torch.cat([m.flatten() for job in x for m in job]) for x in (a, b, c)]
        shapes = [[m.shape for m in job] for job in a]
        assert sorted(shapes[0]) == sorted([m.shape for m in c[0]])  # the same lengths in another order
    else:
        (ma, oa), (mb, ob), (mc, oc) = (traffic.requests(spec, cfg, s, "cpu") for s in (5, 5, 6))
        flat = [np.concatenate([m.ravel() for m in x]) for x in (ma, mb, mc)]
        assert [oa[i] for i in range(40)] == [ob[i] for i in range(40)]
        assert [oa[i] for i in range(40)] != [oc[i] for i in range(40)]
        assert sorted(oa[i] for i in range(12)) == list(range(12))  # each cycle sends every utterance once
        strata = np.argsort([m.shape[1] for m in ma], kind="stable").reshape(4, 3)
        for b in range(0, 24, 4):  # every block of four holds one utterance of each length stratum
            assert sorted(int(np.nonzero(strata == oa[i])[0][0]) for i in range(b, b + 4)) == [0, 1, 2, 3]
        flat = [torch.as_tensor(f) for f in flat]
    assert torch.equal(flat[0], flat[1])
    assert not torch.equal(flat[0], flat[2])


def test_train_batches_follow_the_seed_and_rows_differ():
    cfg, spec = tiny.tiny_config("bigvgan-44k"), tiny.tiny_traffic("train-b16")
    a, b, c = (traffic.train_batches(spec, cfg, s, "cpu") for s in (2**31 + 5, 2**31 + 5, 9))
    audio = torch.cat([x["audio"] for x in a])
    assert torch.equal(audio, torch.cat([x["audio"] for x in b]))
    assert not torch.equal(audio, torch.cat([x["audio"] for x in c]))
    rows = audio[:, 0]
    assert len({tuple(r[:32].tolist()) for r in rows}) == rows.shape[0]
    assert rows.abs().max() < 1.0
    starts = traffic.crop_starts(spec, cfg, 7, 50)
    assert starts == traffic.crop_starts(spec, cfg, 7, 50) != traffic.crop_starts(spec, cfg, 8, 50)
    assert all(0 <= s < spec["frames"] * cfg["audio"]["hop_length"] - cfg["train"]["crop_length"] for s in starts)
