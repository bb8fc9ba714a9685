"""``cli.codec --family ssl``, ``cli.train --family ssl`` and ``cli.bench_infer`` on the CPU.

The backbone is a tiny HuBERT snapshot that ``transformers`` writes (``save_pretrained``, offline): one
layer, 8 wide, three feature convs of kernel and stride 2, so one frame per 8 samples and two frames per
latent frame at the trainer's tiny hop of 16 (``tests/test_torch_trainer.py::TINY``), as the 16 kHz preset
has 320 and 640.  The port's extractor reads it without ``transformers``; the JAX package's
``from_pretrained`` reads the same directory, so the codec's codes and audio can be held to the JAX
package's ``ssl_encode_to_codes`` / ``ssl_decode_from_codes`` on the JAX extractor's features (codes on the
frames whose margin clears ``tests/test_torch_ssl.py::MARGIN_REL`` of their squared norm; WAVs within a
16-bit step plus the parity tolerance).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from tests.test_torch_codec import margins
from tests.test_torch_ssl import MARGIN_REL
from tests.test_torch_trainer import TINY, _wavs
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu.convert import conv1d_from_torch
from vocoder_tpu.data.resample import resample as jresample
from vocoder_tpu.models import hifigan as jhifigan
from vocoder_tpu.models import ssl_encoders as jssl
from vocoder_tpu.models import vae as jvae
from vocoder_tpu.models import vq as jvq
from vocoder_tpu_torch.cli import bench_infer, codec
from vocoder_tpu_torch.cli import train as train_cli
from vocoder_tpu_torch.config import TrainConfig, build_task_config
from vocoder_tpu_torch.data.audio_io import read_wav, write_wav
from vocoder_tpu_torch.models import ssl_encoders, vae

SR, HOP, HIDDEN, LATENT = 8000, 16, 8, 6
BACKBONE = dict(hidden_size=HIDDEN, num_hidden_layers=1, num_attention_heads=2, intermediate_size=16,
                conv_dim=(8, 8, 8), conv_kernel=(2, 2, 2), conv_stride=(2, 2, 2), num_conv_pos_embeddings=8,
                num_conv_pos_embedding_groups=2)
DECODER = ["hop_length=16", "upsample_rates=(4,4)", "upsample_kernel_sizes=(8,8)", "upsample_initial_channel=16",
           "resblock_kernel_sizes=(3,)", "resblock_dilation_sizes=((1,3),)"]


def snapshot(path) -> str:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        transformers.HubertModel(transformers.HubertConfig(**BACKBONE)).save_pretrained(path)
    return str(path)


def generator_overrides(snap: str) -> list[str]:
    gen = [f"latent_size={LATENT}", f"hubert.model_name_or_path={snap}", f"hubert.hidden_size={HIDDEN}",
           f"hubert.output_size={LATENT}", f"decoder.num_mels={LATENT}", f"vq.dim={LATENT}", "vq.codebook_size=16",
           *[f"decoder.{o}" for o in DECODER]]
    return [f"task.generator.{o}" for o in gen]


def tiny_task(snap: str):
    from vocoder_tpu_torch.config import apply_overrides

    base = [o for o in TINY if o.startswith("task.") and not o.startswith("task.generator.")]
    return apply_overrides(TrainConfig(task=build_task_config(family="ssl")), base + generator_overrides(snap)).task


def test_codec_cli_ssl_round_trip_matches_jax(tmp_path):
    """cli.codec encode -> decode --family ssl --device cpu from a workdir whose config names the snapshot,
    over a mono WAV at the task's rate and a stereo one at 16 kHz: the codes equal JAX's ssl_encode_to_codes
    of the JAX extractor's features of the same mono, resampled, hop-padded audio (on the frames clear of a
    tie), (1, 1, F) int32; each WAV JAX's ssl_decode_from_codes of the codes the CLI wrote."""
    snap = snapshot(tmp_path / "snap")
    task = tiny_task(snap)
    model = vae.SSLCodecGenerator(task.generator)
    sd = vae.ssl_random_state_dict(task.generator, 0)
    model.load_state_dict(sd)
    rng = np.random.default_rng(5)
    (tmp_path / "in").mkdir()
    t = np.arange(700) / SR
    mono = (0.3 * np.sin(2 * np.pi * 300 * t * (1 + t)) * (0.5 + 0.5 * np.sin(2 * np.pi * 9 * t))
            + 0.02 * rng.standard_normal(700))
    write_wav(tmp_path / "in" / "a.wav", mono.astype(np.float32), SR)
    write_wav(tmp_path / "in" / "b.wav", np.stack([mono[:500], mono[100:600]]).repeat(2, 1).astype(np.float32), 16000)
    extractor = ssl_encoders.HubertFeatureExtractor(task.generator.hubert, "cpu")
    with torch.no_grad():  # the codebook on latent frames of the inputs, so that they take many codes
        lat = model.encode(extractor(torch.from_numpy(mono[None].astype(np.float32)))).transpose(1, 2)[0]
    rows = lat[rng.choice(len(lat), 16, replace=len(lat) < 16)] + 0.3 * lat.std(0) * torch.from_numpy(
        rng.standard_normal((16, LATENT)).astype(np.float32))
    sd["vq.layers.0.embed"] = sd["vq.layers.0.embed_avg"] = rows
    model.load_state_dict(sd)
    work = tmp_path / "run"
    (work / "checkpoints").mkdir(parents=True)
    (work / "config.json").write_text(json.dumps(dataclasses.asdict(TrainConfig(task=task)), default=str))
    torch.save({"step": 2, "generator": model.state_dict()}, work / "checkpoints" / "2.pt")

    common = ["--family", "ssl", "--ckpt", str(work), "--device", "cpu"]
    codec.main(["encode", *common, "--input", str(tmp_path / "in"), "--output", str(tmp_path / "codes")])
    codec.main(["decode", *common, "--input", str(tmp_path / "codes"), "--output", str(tmp_path / "out")])

    jgen = jvae.SSLCodecGeneratorConfig(
        latent_size=LATENT, hubert=jssl.HubertEncoderConfig(model_name_or_path=snap, hidden_size=HIDDEN,
                                                            output_size=LATENT),
        decoder=jhifigan.HiFiGANConfig(num_mels=LATENT, hop_length=16, upsample_rates=(4, 4),
                                       upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
                                       resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),)),
        vq=jvq.VQConfig(dim=LATENT, codebook_size=16))
    params = {"postnet": {n: conv1d_from_torch(sd, f"postnet.{n}") for n in ("post0", "post1", "post2")},
              "decoder": jhifigan.from_torch_state_dict(sd, jgen.decoder, "decoder.")}
    vq_state = {"layers": [{k: jnp.asarray(sd[f"vq.layers.0.{k}"].numpy()) for k in ("embed", "embed_avg",
                                                                                      "cluster_size")}]}
    jextractor = jssl.HubertFeatureExtractor(jgen.hubert)
    used = set()
    for name in ("a", "b"):
        audio, sr = read_wav(tmp_path / "in" / f"{name}.wav")
        a = jresample(audio.mean(0), sr, SR)
        a = np.pad(a, (0, (-len(a)) % HOP))
        feats = jextractor(a[None])
        want = np.asarray(jvae.ssl_encode_to_codes(params, vq_state, jnp.asarray(feats), jgen))
        codes = np.load(tmp_path / "codes" / f"{name}.codes.npy")
        assert codes.dtype == np.int32 and codes.shape == want.shape == (1, 1, len(a) // HOP)
        with torch.no_grad():
            flat = model.eval().encode(torch.from_numpy(feats)).transpose(1, 2).reshape(-1, LATENT).numpy()
        clear = margins(flat, sd["vq.layers.0.embed"].numpy()) > MARGIN_REL * (flat ** 2).sum(1)
        assert clear.mean() > 0.8
        np.testing.assert_array_equal(codes[0, 0][clear], want[0, 0][clear])
        used |= set(codes.ravel().tolist())
        wav, sr = read_wav(tmp_path / "out" / f"{name}.wav")
        ref = np.asarray(jvae.ssl_decode_from_codes(params, vq_state, jnp.asarray(codes), jgen))[:, 0]
        assert sr == SR and wav.shape == ref.shape == (1, len(a)) and np.abs(ref).max() > 0.01
        np.testing.assert_allclose(wav, ref, rtol=0, atol=1.0 / 32768 + 2e-4)
    assert len(used) > 4


def _train(tmp_path, snap: str, work: str, steps: int):
    base = [o for o in TINY if not o.startswith("task.generator.")]
    return train_cli.main(["--family", "ssl", "--device", "cpu", f"data.train_roots=('{tmp_path / 'train'}',)",
                           f"data.val_root={tmp_path / 'val'}", f"run.workdir={tmp_path / work}", "run.val_pesq=False",
                           *base, *generator_overrides(snap), f"run.max_steps={steps}"])


def test_cli_trains_ssl_resumes_and_feeds_the_codec(tmp_path):
    """cli.train --family ssl: 2 steps in one run, and 1 step then a resume to 2, give the same weights and
    EMA codebooks (moved from step 1), finite losses with the VQ metric, the backbone's time in the log
    window, validation at step 2; then cli.codec encode and decode from that workdir."""
    rng = np.random.default_rng(6)
    _wavs(tmp_path / "train", 4, rng)
    _wavs(tmp_path / "val", 2, rng)
    snap = snapshot(tmp_path / "snap")
    straight = _train(tmp_path, snap, "a", 2)
    first = _train(tmp_path, snap, "b", 1)
    embed_at_1 = first.generator.vq.layers[0].embed.clone()
    resumed = _train(tmp_path, snap, "b", 2)
    assert straight.step == resumed.step == 2
    for (key, a), b in zip(straight.generator.state_dict().items(), resumed.generator.state_dict().values()):
        assert torch.equal(a, b), key
    assert not torch.equal(resumed.generator.vq.layers[0].embed, embed_at_1)
    records = [json.loads(line) for line in (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(v) for r in records for v in r.values())
    train_recs = [r for r in records if "train/generator/all" in r]
    assert train_recs and all("train/generator/vq" in r and r["perf/ssl_features_s"] > 0 for r in train_recs)
    assert [r["step"] for r in records if "val/metrics/mel" in r] == [2]

    codec.main(["encode", "--family", "ssl", "--ckpt", str(tmp_path / "b"), "--input", str(tmp_path / "val"),
                "--output", str(tmp_path / "codes"), "--device", "cpu"])
    codec.main(["decode", "--family", "ssl", "--ckpt", str(tmp_path / "b"), "--input", str(tmp_path / "codes"),
                "--output", str(tmp_path / "out"), "--device", "cpu"])
    n = read_wav(tmp_path / "val" / "0.wav")[0].shape[-1]
    codes = np.load(tmp_path / "codes" / "0.codes.npy")
    assert codes.shape == (1, 1, -(-n // HOP)) and codes.min() >= 0 and codes.max() < 16
    audio = read_wav(tmp_path / "out" / "0.wav")[0]
    assert audio.shape == (1, -(-n // HOP) * HOP) and np.isfinite(audio).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bench_infer_prints_one_json_line(dtype, capsys):
    """--device cpu: one JSON line with the JAX package's keys, the CPU named as the backend and device,
    ms a call and audio-s/s consistent with the batch's audio seconds."""
    rec = bench_infer.main(["--model", "hifigan", "--batch", "2", "--frames", "4", "--iters", "1", "--dtype", dtype,
                            "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert lines == [rec]
    keys = {"metric", "model", "backend", "batch", "frames", "dtype", "ms_per_call", "audio_s_per_s_per_chip"}
    assert keys <= set(rec) and rec["backend"] == rec["device"] == "cpu" and rec["metric"] == "generator_inference"
    assert rec["ms_per_call"] > 0
    audio_s = 2 * 4 * 512 / 44100
    assert abs(rec["audio_s_per_s_per_chip"] * rec["ms_per_call"] / 1e3 - audio_s) < 1e-9


def test_bench_infer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        bench_infer.main(["--model", "hifigan"])
