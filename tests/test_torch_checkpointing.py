"""Activation checkpointing (``checkpointing=True`` on BigVGAN's and HiFiGAN's configs), on the CPU.

One port BigVGAN training step with checkpointing against the JAX package's step with its
``jax.checkpoint`` (the tiny task and the comparison of ``tests/test_torch_train.py``: rtol 2e-4 / atol
2e-5), and each of BigVGAN's and HiFiGAN's steps with checkpointing against the port's own step without
it from the same state, within 1e-6 (the recomputation
repeats the same operations), in fp32 and in bf16, where the recomputation runs after
``nn.cast_parameters`` has given the masters back and must still see the bf16 copies.  BigVGAN's
checkpointed step runs the aa-snake again for every AMP block's activations (K1 on the card): 9
forwards a step become 17 in the tiny BigVGAN (2 stages x 1 block x 2 dilations x 2, and the post
activation, which is not recomputed).
"""

import dataclasses

import numpy as np
import pytest
import torch

import tests.test_torch_train as tt
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu_torch.ops.aa_snake import AASnakeFunction
from vocoder_tpu_torch.train import gan

SELF_TOL = 1e-6


@pytest.fixture
def checkpointed_models(monkeypatch):
    """tests/test_torch_train.py's tiny BigVGAN with ``checkpointing=True`` in both packages."""
    jmod, jgen, tgen, kw = tt.MODELS["bigvgan"]
    monkeypatch.setitem(tt.MODELS, "bigvgan", (jmod, jgen, tgen, {**kw, "checkpointing": True}))


def test_checkpointed_bigvgan_step_matches_jax(checkpointed_models):
    _, jcfg, tcfg = tt._configs("bigvgan", True)
    assert jcfg.generator.checkpointing and tcfg.generator.checkpointing
    tt.check_train_step("bigvgan", True)


def _step(tcfg, count: list):
    """(metrics, generator gradients, state) of one port step from seed 0 on the tiny batch, counting
    AASnakeFunction's forwards."""
    state = gan.create_train_state(tcfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in tt._batch(tcfg).items()}
    forward = AASnakeFunction.forward

    def counting(ctx, *args):
        count.append(1)
        return forward(ctx, *args)

    AASnakeFunction.forward = staticmethod(counting)
    try:
        metrics = gan.make_train_step(tcfg)(state, batch, 5)
    finally:
        AASnakeFunction.forward = staticmethod(forward)
    grads = {n: p.grad.clone() for n, p in state.generator.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["hifigan", "bigvgan"])
def test_checkpointed_step_equals_the_step_without(name, dtype):
    _, _, tcfg = tt._configs(name, True)
    tcfg = tcfg.replace(compute_dtype=dtype)
    remat = tcfg.replace(generator=dataclasses.replace(tcfg.generator, checkpointing=True))
    with torch.backends.mkldnn.flags(enabled=False):  # see tests/test_torch_bf16_train.py::no_onednn
        plain_calls, remat_calls = [], []
        m0, g0, _ = _step(tcfg, plain_calls)
        m1, g1, state = _step(remat, remat_calls)
    for k in m0:
        np.testing.assert_allclose(m1[k], m0[k], rtol=SELF_TOL, atol=SELF_TOL, err_msg=k)
    for n in g0:
        scale = float(g0[n].abs().max())
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=SELF_TOL * max(scale, 1.0), msg=n)
    assert all(p.dtype == torch.float32 for p in state.generator.parameters())
    if name == "bigvgan":
        assert (len(plain_calls), len(remat_calls)) == (9, 17)
    else:
        assert plain_calls == remat_calls == []
