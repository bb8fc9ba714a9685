"""Tensor parallelism on the CPU: gloo ranks against one process and against the JAX package's model axis.

The JAX package holds its model-parallel forward and step (a ``model=2`` mesh) to one device
(``tests/test_sharding.py``): under GSPMD a sharded program is numerically the unsharded one.  Here one
spawn of four gloo ranks (a module fixture; ``tests/torch_tp_ranks.py`` is the ranks' side, one torch
thread each), laid out as ``make_mesh``'s grid with model groups of two, runs every case and saves what
it saw; each test compares a case with the same code run as one process, and the forwards with the
JAX package's under ``make_mesh(data=1, model=2)`` on the conftest's fake CPU devices (its XLA path,
as its own TP inference test runs).  The weights are the JAX package's, initialised from a key and
carried across with ``*_state_dict_from_jax``; each rank takes its shard with the model's
``param_specs``.

Cases: (i) the eval forward, weight norm folded (``cli.infer``'s), of HiFiGAN and BigVGAN at 256
channels (the first stage shards, the second and conv_post replicate; BigVGAN's sharded stage through
the gathered whole stage, K2's path) and of Vocos at vocos-huge's widths 352 ... 2816, depth (1, 1, 1, 1);
(ii) HiFiGAN and BigVGAN with ``frame_lengths`` and with a template; (iii) one GAN step for HiFiGAN,
BigVGAN (also with activation checkpointing) and a small Vocos (the JAX package's TP test's widths) on two
model ranks, tensor parallel only;
(iv) a (data 2, model 2) step of BigVGAN, and of the small Vocos with drop_path, on the global batch of
4; (v) the state's whole checkpoint both ways, and ``shard_state_dict`` / ``gather_state_dict``; (vi) a
HiFiGAN step whose ranks' backwards differ in the gradients of what they hold whole (as cuDNN's may on
cards): the ranks' copies stay equal.
``tests/test_torch_tensor_parallel_jax.py`` holds the step's losses to JAX's TP step, and
``tests/test_torch_tensor_parallel_cli.py`` the CLIs under torchrun.

Tolerances: only the order of sums differs from one process (row-parallel partial sums, the norm of a
row-parallel weight), so a forward is within ``ONE_PROCESS_REL_L2`` (relative L2), losses within
``LOSS_RTOL``, and every gathered gradient and updated weight within ``STATE_REL`` of the module's
largest, the gain g of every row-parallel conv included, but for Adam's first step on a gradient near 0
(``_assert_state_close``); against JAX, the JAX package's TP inference test's ``JAX_ATOL``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_tp_ranks as ranks
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu import nn as jnn
from vocoder_tpu.models import bigvgan as jbigvgan
from vocoder_tpu.models import convnext as jconvnext
from vocoder_tpu.models import hifigan as jhifigan
from vocoder_tpu.models import vocos as jvocos
from vocoder_tpu.models.registry import get_generator as jax_generator
from vocoder_tpu.parallel import make_mesh
from vocoder_tpu.parallel.mesh import train_state_specs
from vocoder_tpu_torch import convert
from vocoder_tpu_torch.models import vocos
from vocoder_tpu_torch.models.registry import get_generator
from vocoder_tpu_torch.parallel import dist, tp_specs
from vocoder_tpu_torch.train import gan

ROOT = Path(__file__).resolve().parent.parent
WORLD, MODEL_PARALLEL = 4, 2
PROCESS_TIMEOUT = 240  # seconds the spawned ranks may take before the test fails
JAX_ATOL = 2e-5  # tests/test_sharding.py::test_model_parallel_inference_matches_single_device
ONE_PROCESS_REL_L2 = 1e-6
LOSS_RTOL = 1e-5
STATE_REL = 1e-5  # each gradient and updated weight: max abs difference over the module's largest |value|
ADAM_ZONE = 100  # an updated weight whose gradient lies within 100x its difference (or eps) of 0: see below
FORWARDS = ("hifigan", "bigvgan", "hifigan_template", "bigvgan_template", "vocos_huge")
STEPS = ("hifigan", "bigvgan", "bigvgan_remat", "vocos")
DP_STEPS = ("bigvgan", "vocos_drop")
CROP_START = 37


def jax_config(name: str):
    """The JAX package's config of a case's generator (the same fields)."""
    cfg = ranks.generator_config(name)
    if name.startswith("vocos"):
        return jvocos.VocosConfig(backbone=jconvnext.ConvNeXtConfig(**dataclasses.asdict(cfg.backbone)),
                                  head=jvocos.ISTFTHeadConfig(**dataclasses.asdict(cfg.head)))
    cls = jhifigan.HiFiGANConfig if name.startswith("hifigan") else jbigvgan.BigVGANConfig
    return cls(**dataclasses.asdict(cfg))


def jax_params(name: str) -> dict:
    """A JAX parameter tree of the case's generator (the shapes of the JAX package's ``init``) from numpy, at
    a scale that keeps every layer alive: weight-norm directions standard normal under gains of 0.6 (0.3 at
    conv_post), plain weights normal over sqrt(fan-in), ConvNeXt's layer scales 0.1 (its init's 1e-6 would
    leave the MLP that tensor parallelism shards silent), small biases and snake parameters."""
    jcfg = jax_config(name)
    gen = jax_generator(ranks.model_name(name))
    shapes = jax.eval_shape(lambda key: gen.init(key, jcfg), jax.random.key(0))
    rng = np.random.default_rng(len(name))

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        leaf = key[key.rindex("[") + 2 : -2]
        n = rng.standard_normal(s.shape)
        if leaf == "v":
            val = n
        elif leaf == "g":
            val = (0.3 if "conv_post" in key else 0.6) * (1 + 0.1 * n)
        elif leaf == "w":
            val = n / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf == "gamma":
            val = 0.1 * (1 + 0.1 * n)
        elif leaf == "scale":
            val = 1 + 0.1 * n
        elif leaf in ("b", "bias"):
            val = 0.02 * n
        else:  # snake alpha, beta (log-scale)
            val = 0.2 * n
        return val.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_state_dict(name: str, params: dict) -> dict:
    if name.startswith("vocos"):
        return convert.vocos_state_dict_from_jax(params)
    if name.startswith("hifigan"):
        return convert.hifigan_state_dict_from_jax(params)
    return convert.bigvgan_state_dict_from_jax(params)


def jax_tp_forward(name: str, params: dict, inputs: dict, lengths: bool) -> np.ndarray:
    """JAX's forward of the folded weights sharded by ``fold_weight_norm_specs(param_specs)`` on a
    (data 1, model 2) mesh: ``cli/infer.py --model-parallel 2``'s program."""
    jcfg = jax_config(name)
    gen = jax_generator(ranks.model_name(name))
    folded = jnn.fold_weight_norm(jax.tree.map(jnp.asarray, params))
    mesh = make_mesh(data=1, model=MODEL_PARALLEL, devices=jax.devices()[:MODEL_PARALLEL])
    specs = jnn.fold_weight_norm_specs(gen.param_specs(jcfg))
    sharded = jax.tree.map(jax.device_put, folded, train_state_specs(folded, mesh, specs))
    mel = inputs["mel"] * (np.asarray(ranks.mask(torch.from_numpy(inputs["lengths"]), ranks.FRAMES))
                           if lengths else 1.0)
    template = inputs.get("template")
    lens = inputs["lengths"].astype(np.int32) if lengths else None

    @jax.jit
    def synth(p, m, t, l):
        return gen.apply(p, m, jcfg, template=t, frame_lengths=l)

    with mesh:
        return np.asarray(synth(sharded, jnp.asarray(mel), None if template is None else jnp.asarray(template),
                                None if lens is None else jnp.asarray(lens)))


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in dist.ENV}
    env.update(PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")])), OMP_NUM_THREADS="1",
               **extra)
    return env


def spawn_ranks(plan: dict, out: Path, world: int) -> list[subprocess.Popen]:
    """``world`` gloo ranks of ``tests.torch_tp_ranks cases`` on ``plan``, started."""
    (out / "plan.json").write_text(json.dumps(plan))
    port = str(dist.free_port())
    return [subprocess.Popen([sys.executable, "-m", "tests.torch_tp_ranks", "cases", str(out / "plan.json"), str(out)],
                             cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                                      MASTER_PORT=port))
            for r in range(world)]


def collect(procs, out: Path) -> list[dict]:
    """Each rank's results, once every rank exited 0 within the timeout; else their errors in the failure."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=PROCESS_TIMEOUT))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    failed = [(p.returncode, err[-3000:]) for p, (_, err) in zip(procs, outs) if p.returncode != 0]
    assert not failed, failed
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(the ranks' results, one process's, JAX's forwards): every case on four gloo ranks, as one process,
    and each forward case under JAX's model=2 mesh."""
    out = tmp_path_factory.mktemp("tp")
    names = sorted(set(FORWARDS) | set(STEPS) | set(DP_STEPS))
    params = {name: jax_params(name) for name in names}
    weights = {name: port_state_dict(name, params[name]) for name in names}
    torch.save(weights, out / "weights.pt")
    one = {f"step/{name}": ranks.run_step(name, weights[name], CROP_START) for name in ("bigvgan",)}
    checkpoint = one["step/bigvgan"].pop("_state").state_dict()
    torch.save(checkpoint, out / "one_process.pt")
    cases = ([{"kind": "forward", "name": n} for n in FORWARDS]
             + [{"kind": "step", "name": n, "start": CROP_START,
                 **({"save": str(out / "one_process.pt")} if n == "bigvgan" else {})} for n in STEPS]
             + [{"kind": "dp_step", "name": n, "start": CROP_START} for n in DP_STEPS]
             + [{"kind": "drift", "name": "hifigan", "start": CROP_START}])
    procs = spawn_ranks({"weights": str(out / "weights.pt"), "model_parallel": MODEL_PARALLEL, "cases": cases},
                        out, WORLD)
    # Meanwhile: one process, and JAX.
    for name in FORWARDS:
        one[f"forward/{name}"] = ranks.run_forward(name, weights[name])
    for name in STEPS:
        if f"step/{name}" not in one:
            one[f"step/{name}"] = ranks.run_step(name, weights[name], CROP_START)
    for name in DP_STEPS:
        one[f"dp_step/{name}"] = ranks.run_step(name, weights[name], CROP_START, global_batch=ranks.DP_BATCH)
    for r in one.values():
        r.pop("_state", None)
    jax_out = {}
    for name in FORWARDS:
        inputs = ranks.mel_input(name)
        jax_out[name] = jax_tp_forward(name, params[name], inputs, False)
        if "lengths" in inputs:
            jax_out[f"{name}/lengths"] = jax_tp_forward(name, params[name], inputs, True)
    per_rank = collect(procs, out)
    return per_rank, one, jax_out, checkpoint, weights


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_state_close(got: dict, want: dict, module: str, what: str, adam_zone: dict | None = None):
    """Each tensor of ``module`` within STATE_REL of the module's largest |value|.  ``adam_zone`` ({key: mask})
    marks the elements of updated weights whose gradient lies within ADAM_ZONE times its TP-vs-one-process
    difference of 0 (or of Adam's eps): there Adam's first step, lr * g / (|g| + eps), may move them by up to
    2 lr more (tests/test_torch_train.py's rule)."""
    keys = [k for k in want if k.startswith(module)]
    scale = max(float(np.abs(want[k]).max()) for k in keys)
    for k in keys:
        atol = np.full(want[k].shape, STATE_REL * scale)
        if adam_zone is not None:
            atol[adam_zone[k]] += 2 * ranks.SCHEDULE["val_base"]
        assert np.all(np.abs(got[k] - want[k]) <= atol), (what, k, float(np.abs(got[k] - want[k]).max()))


def _adam_zone(got_grads: dict, want_grads: dict) -> dict:
    zone = {}
    for k, g in want_grads.items():
        err = float(np.abs(got_grads[k] - g).max())
        zone[k] = np.abs(g) <= ADAM_ZONE * max(err, 1e-6)
    return zone


@pytest.mark.parametrize("name", FORWARDS)
def test_tp_forward_equals_one_process_and_jax(spawned, name):
    """Every rank's waveform equals one process's within ONE_PROCESS_REL_L2 and JAX's TP forward within
    JAX_ATOL, with and without lengths (0 past each); the ranks of a model group agree to the bit; a
    second forward of BigVGAN reuses the gathered stage weights (one build, then hits), and a forward after a
    fp32 -> bf16 -> fp32 round trip of the model gathers them again and equals one process's after the same."""
    per_rank, one, jax_out = spawned[0], spawned[1], spawned[2]
    key = f"forward/{name}"
    want = one[key]
    for r, res in enumerate(per_rank):
        got = res[key]
        for out in ("audio", "audio_again", "audio_lengths"):
            if out not in want:
                continue
            assert _rel_l2(got[out], want[out]) <= ONE_PROCESS_REL_L2, (r, out, _rel_l2(got[out], want[out]))
            jax_key = name if out != "audio_lengths" else f"{name}/lengths"
            np.testing.assert_allclose(got[out], jax_out[jax_key], rtol=0, atol=JAX_ATOL, err_msg=f"{r} {out}")
        if "audio_lengths" in got:
            lengths = ranks.mel_input(name)["lengths"] * ranks.HOP
            assert all(not got["audio_lengths"][i, :, n:].any() for i, n in enumerate(lengths))
        np.testing.assert_array_equal(got["audio"], per_rank[r - r % MODEL_PARALLEL][key]["audio"])
        forwards = 3 if "audio_lengths" in got else 2
        assert got["whole_blocks"] == ((1, forwards - 1) if name.startswith("bigvgan") else (0, 0)), got["whole_blocks"]
        if name.startswith("bigvgan"):
            assert got["whole_blocks_round_trip"] == (1, 0), got["whole_blocks_round_trip"]
            rel = _rel_l2(got["audio_round_trip"], want["audio_round_trip"])
            assert rel <= ONE_PROCESS_REL_L2 and _rel_l2(want["audio_round_trip"], want["audio"]) > 1e-4, (r, rel)


def test_vocos_huge_rank_holds_about_half_the_parameters(spawned):
    """Each rank holds the replicated parameters and half of each sharded one, to the byte; at vocos-huge's
    full depth, where the MLP is ~97% of the 650 M parameters and the head's projection shards too, that is
    50-51.5% of the whole."""
    per_rank, weights = spawned[0], spawned[4]

    def share(sd: dict, cfg) -> tuple[int, int]:
        dims = tp_specs.key_dims(get_generator("vocos").param_specs(cfg), sd)
        whole = sum(v.numel() * v.element_size() for v in sd.values())
        return whole, sum(v.numel() * v.element_size() // (MODEL_PARALLEL if k in dims else 1) for k, v in sd.items())

    whole, held = share(weights["vocos_huge"], ranks.generator_config("vocos_huge"))
    for res in per_rank:
        assert res["forward/vocos_huge"]["param_bytes"] == held < whole
    full = vocos.VocosConfig.huge()
    whole, held = share(vocos.Vocos(full, device="meta").state_dict(), full)
    assert whole > 2.5e9 and 0.50 <= held / whole <= 0.515, held / whole


def _check_step(got: dict, want: dict):
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= LOSS_RTOL * max(abs(w), 1e-12), (k, got["metrics"][k], w)
    assert set(got["grads"]) == set(want["grads"])
    zone = _adam_zone(got["grads"], want["grads"])
    for module in ("generator", "discriminators"):
        _assert_state_close(got["grads"], want["grads"], module, "gradient")
        _assert_state_close(got["state"], want["state"], module, "updated", zone)


def _row_gains(name: str) -> list[str]:
    """The gain (original0) of every row-parallel conv of the case's generator."""
    specs = gan.model_param_specs(ranks.task_config(name))
    return [f"generator.{m}.parametrizations.weight.original0" for m, s in specs.items() if s.kind == "row"
            and not name.startswith("vocos")]


@pytest.mark.parametrize("name", STEPS)
def test_tp_step_equals_one_process(spawned, name):
    """Two model ranks' step against one process's on the same batch: losses, grad norms, every gathered
    gradient (each row-parallel conv's replicated g included) and every updated weight; the ranks of a
    model group hold the same whole state."""
    per_rank, one = spawned[0], spawned[1]
    key = f"step/{name}"
    gains = _row_gains(name)
    assert all(g in one[key]["grads"] for g in gains) and (gains or name.startswith("vocos"))
    for r, res in enumerate(per_rank):
        _check_step(res[key], one[key])
        for k, v in res[key]["state"].items():
            np.testing.assert_array_equal(v, per_rank[r - r % MODEL_PARALLEL][key]["state"][k], err_msg=k)


@pytest.mark.parametrize("name", DP_STEPS)
def test_dp_by_tp_step_equals_one_process_on_the_global_batch(spawned, name):
    """A (data 2, model 2) grid: each model group on its half of the global batch of 4 against one process
    on all of it (the drop_path draws of the global batch's shape, each data rank its rows, alike within a
    model group)."""
    per_rank, one = spawned[0], spawned[1]
    for res in per_rank:
        _check_step(res[f"dp_step/{name}"], one[f"dp_step/{name}"])


def test_replicated_copies_stay_equal_when_the_ranks_backwards_differ(spawned):
    """Each rank scales the gradients of what it holds whole (the discriminators, HiFiGAN's narrow stage and
    conv_post, each row-parallel conv's g) by its own factor before the step's reductions: after the step the
    ranks of a model group hold the same whole state and gradients to the bit (the model group's mean of each
    such gradient), which differ from the unperturbed step's."""
    per_rank = spawned[0]
    for r, res in enumerate(per_rank):
        first = per_rank[r - r % MODEL_PARALLEL]["drift/hifigan"]
        for what in ("state", "grads"):
            for k, v in res["drift/hifigan"][what].items():
                np.testing.assert_array_equal(v, first[what][k], err_msg=f"{r} {what} {k}")
        drifted = res["drift/hifigan"]["grads"]
        plain = res["step/hifigan"]["grads"]
        for module in ("generator.conv_post", "discriminators."):
            assert any(not np.array_equal(v, plain[k]) for k, v in drifted.items() if k.startswith(module)), module


def test_checkpoints_cross_between_tp_and_one_process(spawned):
    """A one-process checkpoint restored on the ranks gives each its shard and, gathered, the checkpoint
    back to the bit (weights and AdamW's moments), and restored weights only, the shard with a fresh step
    and optimizer; the ranks' whole state after their step loads in one process
    (``TrainState.load_state_dict``) and is one process's within STATE_REL."""
    per_rank, one, checkpoint, weights = spawned[0], spawned[1], spawned[3], spawned[4]
    specs = gan.model_param_specs(ranks.task_config("bigvgan"))
    for r, res in enumerate(per_rank):
        back = res["checkpoint/bigvgan"]
        assert back["step"] == checkpoint["step"] == 1
        for k, v in checkpoint["generator"].items():
            np.testing.assert_array_equal(back["generator"][k], v.numpy(), err_msg=k)
        shard = convert.shard_state_dict(checkpoint["generator"], specs, r % MODEL_PARALLEL, MODEL_PARALLEL)
        for k, v in shard.items():
            np.testing.assert_array_equal(back["shard"][k], v.numpy(), err_msg=k)
            np.testing.assert_array_equal(back["weights_only"]["shard"][k], v.numpy(), err_msg=k)
        assert back["weights_only"]["step"] == 0 and back["weights_only"]["opt_g_state"] == 0
        for i, s in checkpoint["opt_g"]["state"].items():
            for k, v in s.items():
                assert torch.equal(back["opt_g"]["state"][i][k], v), (i, k)
    state = ranks.train_state("bigvgan", weights["bigvgan"])
    saved = per_rank[1]["step/bigvgan"]
    state.load_state_dict({**checkpoint, "generator": {k[len("generator."):]: torch.from_numpy(v)
                                                       for k, v in saved["state"].items() if k.startswith("generator.")},
                           "opt_g": saved["opt_g"]})
    got = {f"generator.{k}": v.numpy() for k, v in state.generator.state_dict().items()}
    _assert_state_close(got, one["step/bigvgan"]["state"], "generator", "restored")
    for i, s in state.opt_g.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, saved["opt_g"]["state"][i][k]), (i, k)


@pytest.mark.parametrize("name", ["hifigan", "bigvgan_template", "vocos_huge"])
def test_shard_then_gather_returns_the_state_dict_to_the_bit(spawned, name):
    """``gather_state_dict`` of every rank's ``shard_state_dict`` is the state_dict, weight-normed and folded;
    the specs shard the same parameters as the JAX package's spec trees (the layers its specs name)."""
    sd = spawned[4][name]
    gen = ranks.model_name(name)
    specs = get_generator(gen).param_specs(ranks.generator_config(name))
    folded = ranks.forward_model(name, sd).state_dict()
    for whole in (sd, folded):
        for world in (2, 4):
            shards = [convert.shard_state_dict(whole, specs, r, world) for r in range(world)]
            assert any(shards[0][k].shape != v.shape for k, v in whole.items())
            back = convert.gather_state_dict(shards, specs)
            assert list(back) == list(whole)
            for k, v in whole.items():
                assert torch.equal(back[k], v), k
    dims = tp_specs.key_dims(specs, sd)
    assert all(name.startswith("vocos") or "conv_post" not in k for k in dims)
