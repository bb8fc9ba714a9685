"""Storage sharding on two gloo ranks against one process and against the JAX package's heuristic-sharded step.

The JAX package stores every leaf of its TrainState that no explicit spec names sharded on one axis of the
model group (``vocoder_tpu/parallel/mesh.py::infer_param_specs``) and GSPMD gathers it where it is used; the
port's ``tp.storage_shard`` keeps a slice on each rank and gathers at each module call.  One spawn of two gloo
ranks (``tests/torch_tp_ranks.py``'s ``storage_*`` cases, one model group) runs, at small widths with tensors of
``STORAGE_MIN_SIZE`` elements or more stored in shards (the discriminators, the whole generator, the vq
codebook): one step of RefineGAN, the vae and the vqvae; Firefly-GAN's eval forward, weight norm folded, as
``cli.infer.load_generator`` builds it; and a one-process checkpoint of the vqvae restored into the ranks.
Each test holds a case to the same code as one process: losses and forwards at
``tests/test_torch_tensor_parallel.py``'s limits, every gathered gradient and weight (and the EMA codebook)
within ``STATE_REL`` of the module's largest, the ranks' whole states equal to the bit, checkpoints to the
bit both ways; each rank's bytes held against JAX's per-device bytes under ``infer_param_specs`` at the same
``min_size``; and the vqvae step's metrics and EMA codebook against JAX's step on a ``make_mesh(data=1,
model=2)`` mesh of the conftest's fake CPU devices at the JAX kernel tests' rtol 2e-4 / atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_tp_ranks as ranks
from tests.test_torch_family_train import discriminators_to_jax, vq_to_jax
from tests.test_torch_tensor_parallel import LOSS_RTOL, ONE_PROCESS_REL_L2, _adam_zone, _assert_state_close, _rel_l2, \
    collect, spawn_ranks
from tests.test_torch_tensor_parallel_jax import KEY, crop_start
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu.convert import conv1d_from_torch
from vocoder_tpu.models import convnext as jconvnext
from vocoder_tpu.models import firefly as jfirefly
from vocoder_tpu.models import hifigan as jhifigan
from vocoder_tpu.models import mpd as jmpd
from vocoder_tpu.models import mrd as jmrd
from vocoder_tpu.models import refinegan as jrefinegan
from vocoder_tpu.models import vae as jvae
from vocoder_tpu.models import vq as jvq
from vocoder_tpu.models import wavenet as jwavenet
from vocoder_tpu.parallel import make_mesh
from vocoder_tpu.parallel.mesh import infer_param_specs
from vocoder_tpu.train import gan as jgan
from vocoder_tpu.train.schedule import WarmupCosineConfig as JWarmupCosine
from vocoder_tpu_torch.models import firefly

MODEL_PARALLEL = 2
RTOL, ATOL = 2e-4, 2e-5  # tests/test_torch_tensor_parallel_jax.py's
STEPS = ("refinegan", "vae", "vqvae")
JAX_MODULES = dict(convnext=jconvnext, firefly=jfirefly, hifigan=jhifigan, refinegan=jrefinegan, vae=jvae, vq=jvq,
                   wavenet=jwavenet)


def jax_task(name: str):
    """The JAX package's task of a ``STORAGE`` case (the same fields as ``ranks.task_config``)."""
    tcfg = ranks.task_config(name)
    return jgan.GANTaskConfig(generator_name=tcfg.generator_name, generator=ranks.storage_generator_config(name, JAX_MODULES),
                              family=tcfg.family, input_transform=tcfg.input_transform, crop_length=tcfg.crop_length,
                              mpd=jmpd.MPDConfig(**ranks.STORAGE_MPD), mrd=jmrd.MRDConfig(resolutions=ranks.RES),
                              schedule=JWarmupCosine(**ranks.SCHEDULE), **ranks.TASK)


def generator_to_jax(name: str, jgen, sd: dict) -> dict:
    """A port generator's state_dict -> the JAX parameter tree (``from_torch_state_dict``)."""
    if name == "refinegan":
        return jrefinegan.from_torch_state_dict(sd, jgen)
    if name == "vae":
        return {"encoder": jconvnext.from_torch_state_dict(sd, jgen.encoder, "encoder."),
                "decoder": jhifigan.from_torch_state_dict(sd, jgen.decoder, "decoder.")}
    if name == "vqvae":
        return {"encoder": jwavenet.from_torch_state_dict(sd, jgen.encoder, "encoder."),
                "decoder": jhifigan.from_torch_state_dict(sd, jgen.decoder, "decoder.")}
    if name == "ssl":
        return {"postnet": {n: conv1d_from_torch(sd, f"postnet.{n}") for n in ("post0", "post1", "post2")},
                "decoder": jhifigan.from_torch_state_dict(sd, jgen.decoder, "decoder.")}
    return jfirefly.from_torch_state_dict(sd, jgen)


def jax_state(name: str, gen_sd: dict, disc_sd: dict):
    """The JAX TrainState of the port's whole state_dicts (AdamW fresh, the rng ``KEY``)."""
    jcfg = jax_task(name)
    gp = jax.tree.map(jnp.asarray, generator_to_jax(name, jcfg.generator, gen_sd))
    dp = discriminators_to_jax(jcfg, disc_sd)
    tx = jgan.make_optimizer(jcfg)
    extra = {"vq": vq_to_jax(gen_sd, 1)} if name == "vqvae" else None
    return jgan.TrainState(step=jnp.zeros((), jnp.int32), gen_params=gp, disc_params=dp, opt_g=tx.init(gp),
                           opt_d=tx.init(dp), rng=jax.random.key(KEY), extra=extra)


def jax_bytes(name: str) -> dict:
    """JAX's per-device bytes of each part of the case's TrainState under ``infer_param_specs`` at
    ``STORAGE_MIN_SIZE`` on a model=2 mesh (``tests/test_sharding.py::_per_device_bytes``' count; the moments
    are Adam's mu and nu, without the step counts)."""
    jcfg = jax_task(name)
    abstract = jax.eval_shape(lambda k: jgan.create_train_state(k, jcfg), jax.random.key(0))
    mesh = make_mesh(data=1, model=MODEL_PARALLEL, devices=jax.devices()[:MODEL_PARALLEL])
    specs = infer_param_specs(abstract, mesh, min_size=ranks.STORAGE_MIN_SIZE)

    def per(tree, spec_tree) -> int:
        total = 0
        for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(spec_tree, is_leaf=lambda x: hasattr(x, "spec"))):
            n = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
            total += n // (MODEL_PARALLEL if any(a is not None for a in sh.spec) else 1)
        return total

    def moments(opt, spec_opt) -> int:
        return per(opt[0].mu, spec_opt[0].mu) + per(opt[0].nu, spec_opt[0].nu)

    return {"generator": per(abstract.gen_params, specs.gen_params),
            "discriminators": per(abstract.disc_params, specs.disc_params),
            "opt_g": moments(abstract.opt_g, specs.opt_g), "opt_d": moments(abstract.opt_d, specs.opt_d),
            "buffers": 0 if abstract.extra is None else per(abstract.extra, specs.extra)}


def jax_step(name: str, gen_sd: dict, disc_sd: dict) -> tuple[dict, dict]:
    """JAX's step from the port's whole state, the state sharded by ``infer_param_specs`` at STORAGE_MIN_SIZE on
    a (data 1, model 2) mesh: (metrics, the new state's EMA VQ state or None)."""
    jcfg = jax_task(name)
    state = jax_state(name, gen_sd, disc_sd)
    mesh = make_mesh(data=1, model=MODEL_PARALLEL, devices=jax.devices()[:MODEL_PARALLEL])
    batch = {k: jnp.asarray(v) for k, v in ranks.step_batch(name).items()}
    with mesh:
        state = jax.tree.map(jax.device_put, state, infer_param_specs(state, mesh, min_size=ranks.STORAGE_MIN_SIZE))
        new, metrics = jax.jit(jgan.make_train_step(jcfg))(state, batch)
    return {k: float(v) for k, v in metrics.items()}, None if new.extra is None else new.extra["vq"]


def start_of(name: str) -> int:
    return crop_start(jax_task(name), ranks.step_batch(name)["audio"].shape[2])


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(the ranks' results, one process's, the vqvae's one-process checkpoint, JAX's vqvae step): the ranks run
    while one process and JAX do."""
    out = tmp_path_factory.mktemp("storage")
    weights = {"firefly": firefly.random_state_dict(ranks.storage_generator_config("firefly"), 5)}
    torch.save(weights, out / "weights.pt")
    one = {f"storage_step/{n}": ranks.run_storage_step(n, start_of(n)) for n in ("vqvae",)}
    first = one["storage_step/vqvae"].pop("_state")
    checkpoint = one["storage_step/vqvae"]["ckpt"]
    torch.save(checkpoint, out / "one_process.pt")
    cases = ([{"kind": "storage_step", "name": n, "start": start_of(n)} for n in STEPS]
             + [{"kind": "storage_forward", "name": "firefly"},
                {"kind": "storage_checkpoint", "name": "vqvae", "save": str(out / "one_process.pt")}])
    procs = spawn_ranks({"weights": str(out / "weights.pt"), "model_parallel": MODEL_PARALLEL, "cases": cases},
                        out, MODEL_PARALLEL)
    for name in STEPS:
        if f"storage_step/{name}" not in one:
            one[f"storage_step/{name}"] = ranks.run_storage_step(name, start_of(name))
            one[f"storage_step/{name}"].pop("_state")
    one["storage_forward/firefly"] = ranks.run_storage_forward("firefly", weights["firefly"])
    fresh = ranks.storage_state("vqvae")
    jax_out = jax_step("vqvae", fresh.generator.state_dict(), fresh.discriminators.state_dict())
    del first, fresh
    return collect(procs, out), one, checkpoint, jax_out


def _check_storage_step(got: dict, want: dict) -> None:
    """Losses within LOSS_RTOL; every whole gradient and updated weight within STATE_REL of the module's largest
    (Adam's first step near a zero gradient: ``_assert_state_close``'s zone); the buffers (the EMA codebook)
    within STATE_REL too."""
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= LOSS_RTOL * max(abs(w), 1e-12), (k, got["metrics"][k], w)
    assert set(got["grads"]) == set(want["grads"]) and set(got["state"]) == set(want["state"])
    zone = _adam_zone(got["grads"], want["grads"])
    weights = {k: v for k, v in got["state"].items() if k in got["grads"]}
    for module in ("generator", "discriminators"):
        _assert_state_close(got["grads"], want["grads"], module, "gradient")
        _assert_state_close(weights, {k: want["state"][k] for k in weights}, module, "updated", zone)
    buffers = [k for k in got["state"] if k not in got["grads"]]
    if buffers:
        _assert_state_close({k: got["state"][k] for k in buffers}, {k: want["state"][k] for k in buffers},
                            "generator", "buffer")


@pytest.mark.parametrize("name", STEPS)
def test_storage_step_equals_one_process(spawned, name):
    """Both ranks' step against one process's: losses, grad norms, every gathered gradient and weight, the EMA
    codebook; the ranks' whole states after it (weights, buffers and both optimizers' moments, gathered) equal
    to the bit; the discriminators and the generator hold storage shards."""
    per_rank, one = spawned[0], spawned[1]
    key = f"storage_step/{name}"
    for res in per_rank:
        _check_storage_step(res[key], one[key])
        assert res[key]["sharded"]["generator"] > 0 and res[key]["sharded"]["discriminators"] > 0, res[key]["sharded"]
        for k, v in res[key]["state"].items():
            np.testing.assert_array_equal(v, per_rank[0][key]["state"][k], err_msg=k)
        for opt in ("opt_g", "opt_d"):
            for i, s in per_rank[0][key]["ckpt"][opt]["state"].items():
                for k, v in s.items():
                    assert torch.equal(res[key]["ckpt"][opt]["state"][i][k], v), (opt, i, k)
    if name == "vqvae":
        assert "generator.vq.layers.0.embed" in one[key]["state"]


@pytest.mark.parametrize("name", STEPS)
def test_storage_bytes_held_equal_jax_per_device_bytes(spawned, name):
    """Each rank holds, part by part (generator, discriminators, their AdamW moments, the codebooks), exactly
    JAX's per-device bytes under ``infer_param_specs`` at the same min_size, and less than one process."""
    per_rank, one = spawned[0], spawned[1]
    want = jax_bytes(name)
    for res in per_rank:
        assert res[f"storage_step/{name}"]["held"] == want
    whole = one[f"storage_step/{name}"]["held"]
    assert all(want[k] < whole[k] for k in ("generator", "discriminators", "opt_g", "opt_d"))
    assert (want["buffers"] < whole["buffers"]) == (name == "vqvae")


def test_storage_forward_equals_one_process(spawned):
    """Firefly-GAN's folded eval forward on the ranks (its weights in storage shards, gathered at each call)
    against one process's within ONE_PROCESS_REL_L2, twice; the ranks agree to the bit; each holds fewer bytes."""
    per_rank, one = spawned[0], spawned[1]
    want = one["storage_forward/firefly"]
    for res in per_rank:
        got = res["storage_forward/firefly"]
        for out in ("audio", "audio_again"):
            assert _rel_l2(got[out], want[out]) <= ONE_PROCESS_REL_L2, out
        np.testing.assert_array_equal(got["audio"], per_rank[0]["storage_forward/firefly"]["audio"])
        assert got["sharded"] > 0 and got["param_bytes"] < want["param_bytes"]


def test_storage_checkpoints_cross_between_two_ranks_and_one_process(spawned):
    """A one-process vqvae checkpoint restored on the ranks gives each its slice and, gathered, the checkpoint
    back to the bit (weights, codebooks, both optimizers' moments); the ranks' whole state after their own step
    loads in one process and gives it back to the bit."""
    per_rank, checkpoint = spawned[0], spawned[2]
    for r, res in enumerate(per_rank):
        back = res["storage_checkpoint/vqvae"]
        for part in ("generator", "discriminators"):
            assert back["whole"][part].keys() == checkpoint[part].keys()
            for k, v in checkpoint[part].items():
                assert torch.equal(back["whole"][part][k], v), (part, k)
                shard = back["shard"][part][k]
                if shard.shape != tuple(v.shape):
                    d = next(i for i, (a, b) in enumerate(zip(shard.shape, v.shape)) if a != b)
                    v = v.narrow(d, r * shard.shape[d], shard.shape[d])
                np.testing.assert_array_equal(shard, v.numpy(), err_msg=k)
        for opt in ("opt_g", "opt_d"):
            for i, s in checkpoint[opt]["state"].items():
                for k, v in s.items():
                    assert torch.equal(back["whole"][opt]["state"][i][k], v), (opt, i, k)
    saved = per_rank[1]["storage_step/vqvae"]["ckpt"]
    state = ranks.storage_state("vqvae")
    state.load_state_dict(saved)
    again = state.state_dict()
    for part in ("generator", "discriminators"):
        for k, v in saved[part].items():
            assert torch.equal(again[part][k], v), (part, k)
    for opt in ("opt_g", "opt_d"):
        for i, s in saved[opt]["state"].items():
            for k, v in s.items():
                assert torch.equal(again[opt]["state"][i][k], v), (opt, i, k)


def test_vqvae_storage_step_equals_jax_heuristic_sharded_step(spawned):
    """Each rank's vqvae step against JAX's on the same state sharded by ``infer_param_specs`` (model=2): every
    metric and the EMA codebook within rtol 2e-4 / atol 2e-5."""
    per_rank, (want, vq_state) = spawned[0], spawned[3]
    for res in per_rank:
        got = res["storage_step/vqvae"]
        assert set(got["metrics"]) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got["metrics"][k], w, rtol=RTOL, atol=ATOL, err_msg=k)
        for k in ("embed", "embed_avg", "cluster_size"):
            np.testing.assert_allclose(got["state"][f"generator.vq.layers.0.{k}"], np.asarray(vq_state["layers"][0][k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
