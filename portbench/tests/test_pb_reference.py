"""The frozen references against the port, on the CPU at a small size (the port's plain versions there).

The test imports both; the references import nothing of the port (``test_pb_imports.py``)."""

import torch

from portbench import program, weights
from portbench.reference import bigvgan as ref_bigvgan
from portbench.reference import hifigan as ref_hifigan
from portbench.reference.ops import Precision, aa_snake
from portbench.tests import tiny

REFS = {"bigvgan-44k": ref_bigvgan, "hifigan-44k": ref_hifigan}


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_aa_snake_matches_the_ports_plain_version():
    from vocoder_tpu_torch.ops.antialias import aa_snake_plain

    x = 3.0 * torch.randn(2, 5, 77, generator=torch.Generator().manual_seed(0))
    alpha, beta = torch.rand(5) * 4 + 0.1, torch.rand(5) + 0.5
    assert _rel(aa_snake(x, alpha, beta), aa_snake_plain(x, alpha, beta)) < 2e-6


def test_generators_match_the_port_item_by_item_and_in_a_padded_batch():
    for name, ref in REFS.items():
        cfg = tiny.tiny_config(name)
        params = weights.state_dict(ref.shapes(cfg["generator"]), lambda k: ref.init(cfg["generator"], k), 11,
                                    "generator", "cpu")
        model = program.generator(cfg, params, "cpu")
        frames = [40, 17, 33]
        mels = [torch.randn(cfg["audio"]["num_mels"], f, generator=torch.Generator().manual_seed(f)) - 5
                for f in frames]
        batch = torch.zeros(3, cfg["audio"]["num_mels"], 40)
        for i, m in enumerate(mels):
            batch[i, :, : m.shape[1]] = m
        with torch.inference_mode():
            out = model(batch, frame_lengths=torch.tensor(frames, dtype=torch.int32))
        hop = cfg["audio"]["hop_length"]
        for i, m in enumerate(mels):
            want = ref.forward(params, m[None], cfg["generator"], Precision("fp32"))[0, 0]
            assert _rel(out[i, 0, : frames[i] * hop], want) < 1e-5, name
            assert torch.all(out[i, 0, frames[i] * hop:] == 0)


def test_gan_step_matches_the_port(run_tiny):
    result, run = run_tiny("bigvgan-44k.train-b16")
    assert result["checked"]["loss_gap"]["value"] < 1e-5
    assert result["checked"]["grad_gap"]["value"] < 1e-4
    assert result["checked"]["change_gap"]["value"] < 1e-3
    assert len(run.kept["program"]["losses"]) == 3
