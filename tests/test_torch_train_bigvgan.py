"""One port BigVGAN training step against the JAX package's ``make_train_step``, on the CPU.

The check and its tolerances are ``tests/test_torch_train.py``'s; here the generator is a tiny
BigVGAN, whose activations run ``AASnakeFunction`` (the plain forward and VJP on the CPU) against
``jax.grad`` through the JAX package's training path (poly4 aa-snake, per-block AMP); and the
validation step after it, whose eval-mode stages run ``amp_stage`` (the plain stage on the CPU).
"""

import pytest

from tests.test_torch_train import check_eval_step, check_train_step
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("crop", [True, False])
def test_bigvgan_train_step_matches_jax(crop):
    check_train_step("bigvgan", crop)


def test_bigvgan_eval_step_matches_jax():
    check_eval_step("bigvgan")
