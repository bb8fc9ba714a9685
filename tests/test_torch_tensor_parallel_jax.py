"""The tensor-parallel GAN step against the JAX package's, on the CPU.

Two gloo ranks (``tests/torch_tp_ranks.py``) take one step of HiFiGAN, BigVGAN (256 channels: the first
stage sharded) and the small Vocos of the JAX package's own TP test, from the weights of
``tests/test_torch_tensor_parallel.py::jax_params`` (the generator's, carried to the port with
``*_state_dict_from_jax``) and the port's seeded discriminators (carried to JAX with their
``from_torch_state_dict``); JAX steps the same state sharded by ``shard_train_state`` with the model's
``param_specs`` on a ``make_mesh(data=1, model=2)`` mesh of the conftest's fake CPU devices, from the
crop start its key gives (``tests/test_torch_train.py``'s).  Every metric of the step, on each rank,
within the JAX kernel tests' rtol 2e-4 / atol 2e-5.  The step against one port process, gradients and
weights included, is ``tests/test_torch_tensor_parallel.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_tp_ranks as ranks
from tests.test_torch_tensor_parallel import MODEL_PARALLEL, collect, jax_config, jax_params, port_state_dict, \
    spawn_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu.models import mpd as jmpd
from vocoder_tpu.models import mrd as jmrd
from vocoder_tpu.parallel import make_mesh, shard_train_state
from vocoder_tpu.train import gan as jgan
from vocoder_tpu.train.schedule import WarmupCosineConfig as JWarmupCosine
from vocoder_tpu_torch.train import gan

RTOL, ATOL = 2e-4, 2e-5
STEPS = ("hifigan", "bigvgan", "vocos")
KEY = 3


def jax_task(name: str):
    tcfg = ranks.task_config(name)
    kw = ranks.VOCOS_TASK if name.startswith("vocos") else ranks.TASK
    return jgan.GANTaskConfig(generator_name=ranks.model_name(name), generator=jax_config(name),
                              crop_length=tcfg.crop_length, mpd=jmpd.MPDConfig(**ranks.MPD),
                              mrd=jmrd.MRDConfig(resolutions=ranks.RES), schedule=JWarmupCosine(**ranks.SCHEDULE), **kw)


def crop_start(jcfg, t: int) -> int:
    """The JAX step's crop start: ``make_train_step`` splits ``state.rng``, then ``_generator_loss`` the step key."""
    _, step_rng = jax.random.split(jax.random.key(KEY))
    r_crop, _ = jax.random.split(step_rng)
    return int(jax.random.randint(r_crop, (), 0, t - jcfg.crop_length))


def jax_tp_step(name: str, params: dict) -> dict:
    """JAX's step of the generator ``params`` and the port's seeded discriminators, the state sharded by the
    model's specs on a (data 1, model 2) mesh; its metrics."""
    jcfg = jax_task(name)
    disc = gan.create_train_state(ranks.task_config(name), ranks.SEED, "cpu").discriminators.state_dict()
    dp = {"mpd": jmpd.from_torch_state_dict(disc, jcfg.mpd, prefix="mpd."),
          "mrd": jmrd.from_torch_state_dict(disc, jcfg.mrd, prefix="mrd.")}
    gp = jax.tree.map(jnp.asarray, params)
    tx = jgan.make_optimizer(jcfg)
    state = jgan.TrainState(step=jnp.zeros((), jnp.int32), gen_params=gp, disc_params=dp, opt_g=tx.init(gp),
                            opt_d=tx.init(dp), rng=jax.random.key(KEY))
    mesh = make_mesh(data=1, model=MODEL_PARALLEL, devices=jax.devices()[:MODEL_PARALLEL])
    batch = {k: jnp.asarray(v) for k, v in ranks.step_batch(name).items()}
    with mesh:
        state = shard_train_state(state, mesh, jgan.model_param_specs(jcfg))
        _, metrics = jax.jit(jgan.make_train_step(jcfg))(state, batch)
    return {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """({name: [each rank's step]}, {name: JAX's metrics}): the ranks run while JAX compiles."""
    import torch

    out = tmp_path_factory.mktemp("tp_jax")
    params = {name: jax_params(name) for name in STEPS}
    torch.save({name: port_state_dict(name, params[name]) for name in STEPS}, out / "weights.pt")
    t = {name: ranks.step_batch(name)["audio"].shape[2] for name in STEPS}
    cases = [{"kind": "step", "name": n, "start": crop_start(jax_task(n), t[n])} for n in STEPS]
    procs = spawn_ranks({"weights": str(out / "weights.pt"), "model_parallel": MODEL_PARALLEL, "cases": cases},
                        out, MODEL_PARALLEL)
    want = {name: jax_tp_step(name, params[name]) for name in STEPS}
    per_rank = collect(procs, out)
    return {name: [r[f"step/{name}"] for r in per_rank] for name in STEPS}, want


@pytest.mark.parametrize("name", STEPS)
def test_tp_step_metrics_equal_jax_tp_step(steps, name):
    got_by_rank, want = steps[0][name], steps[1][name]
    for got in got_by_rank:
        assert set(got["metrics"]) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got["metrics"][k], w, rtol=RTOL, atol=ATOL, err_msg=k)
