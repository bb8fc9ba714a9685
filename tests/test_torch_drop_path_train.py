"""One training step of Vocos and Firefly-GAN, whose ConvNeXt backbones drop paths, against the JAX
package's ``make_train_step`` on the CPU, with equal drop_path masks in both packages
(``tests/test_torch_family_train.py::check_family_train_step``; here, so that each file stays within a
minute on one worker)."""

import pytest

from tests.test_torch_family_train import check_family_train_step, equal_draws  # noqa: F401 (a fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("name", ["vocos", "firefly_gan_base"])
def test_drop_path_train_step_matches_jax(name, equal_draws):  # noqa: F811
    check_family_train_step(name, equal_draws)
