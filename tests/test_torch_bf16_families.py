"""bf16 training steps of the port against the JAX package's, on the CPU: BigVGAN and the vqvae family.

The rule and the step distance of ``tests/test_torch_bf16_train.py``.  BigVGAN is the tiny task of
``tests/test_torch_trainer.py`` (``TINY``: hop 16, 8 mels, 32 frames, rates (4, 4), 32 channels, one
resblock of dilations (1, 3), two MPD periods and two MRD resolutions), built by both packages'
``build_train_config`` from the same overrides; its activations run ``AASnakeFunction`` (the plain
forward, fp32 inside and one rounding, and the plain VJP, fp32 sums and bf16 gradients) against XLA's
autodiff of the JAX package's bf16 poly4 aa-snake.  The vqvae is the tiny task of
``tests/test_torch_family_train.py``: under bf16 compute only its discriminators run in bf16, as the
JAX package's (the generator family is "vqvae", not "gan"), and the EMA codebooks stay fp32 buffers.
There the bf16 discriminators move JAX's step very little (losses 6.6e-6, gradients 1.1e-5 from its
fp32 step), about as much as the two packages' fp32 steps differ in their sum orders (within the fp32
parity test's 2e-4), and what the bf16 moves is the adversarial terms, where two programs rounding
independently are expected sqrt(2) times as far apart as each is from fp32 (measured: losses 9.7e-6).
So the vqvae's bound is stated here: twice JAX's bf16-vs-fp32 distance (the factor the card's
kernel-against-plain bf16 step check allows, ``chip_smoke.py``) plus the port's fp32 step's distance
from JAX's, capped as the rule caps it.
"""

import numpy as np
import torch

from tests.test_torch_bf16_train import compare, no_onednn, one_torch_thread  # noqa: F401 (autouse fixtures)
from tests.test_torch_family_train import (discriminators_to_jax, generator_to_jax, random_weights, task_configs,
                                           vq_to_jax)
from tests.test_torch_train import _batch
from tests.test_torch_trainer import TINY
from vocoder_tpu import config as jconfig
from vocoder_tpu.models import bigvgan as jbigvgan
from vocoder_tpu_torch import config as tconfig
from vocoder_tpu_torch.train import gan

BF16 = {"compute_dtype": "bfloat16"}


def test_bigvgan_bf16_step_within_jax_bf16_floor():
    overrides = [o for o in TINY if o.startswith("task.")]
    jcfg = jconfig.build_train_config("bigvgan", overrides=overrides).task
    tcfg = tconfig.build_train_config("bigvgan", overrides=overrides).task
    gen_sd = {k: v.clone() for k, v in gan.create_train_state(tcfg, 0, "cpu").generator.state_dict().items()}

    def to_jax(g, d):
        return jbigvgan.from_torch_state_dict(g, jcfg.generator), discriminators_to_jax(jcfg, d)

    t = tcfg.hop_length * tcfg.num_frames
    batch = {"audio": (0.3 * np.random.default_rng(0).standard_normal((2, 1, t))).astype(np.float32),
             "lengths": np.asarray([t, t - 17])}
    compare(jcfg, tcfg, BF16, gen_sd, to_jax, batch)


def test_vqvae_bf16_step_casts_only_the_discriminators():
    jcfg, tcfg = task_configs("vqvae")
    gen_sd = random_weights("vqvae", tcfg.generator)

    def to_jax(g, d):
        return generator_to_jax("vqvae", jcfg.generator, g), discriminators_to_jax(jcfg, d)

    state = compare(jcfg, tcfg, BF16, gen_sd, to_jax, _batch(tcfg), extra={"vq": vq_to_jax(gen_sd, 1)},
                    fp32_slack=True, factor=2.0)
    assert all(b.dtype == torch.float32 for b in state.generator.buffers())  # the EMA codebooks

    seen = {}

    def record(name):
        def hook(module, args, out):
            seen.setdefault(name, (args[0].dtype, module.weight.dtype))
        return hook

    hooks = [state.generator.decoder.conv_pre.register_forward_hook(record("generator")),
             state.discriminators["mpd"].discriminators[0].convs[0].register_forward_hook(record("mpd"))]
    try:
        gan.make_train_step(tcfg.replace(**BF16))(state, {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()})
    finally:
        for h in hooks:
            h.remove()
    assert seen == {"generator": (torch.float32, torch.float32), "mpd": (torch.bfloat16, torch.bfloat16)}


def test_bf16_eval_copies_the_generator_once_per_weights(monkeypatch):
    """The bf16 eval step makes its bf16 copy of the generator once for each set of weights: the batches of
    one validation share it (K2 packs its weights once), and an in-place change of a weight makes a new one,
    whose fake follows the new weights.  A step counter that moved while no weight changed keeps it: a real
    step's AdamW update changes every weight in place."""
    overrides = [o for o in TINY if o.startswith("task.")]
    tcfg = tconfig.build_train_config("bigvgan", overrides=overrides).task.replace(**BF16)
    state = gan.create_train_state(tcfg, 0, "cpu")
    t = tcfg.hop_length * tcfg.num_frames
    batch = {"audio": torch.from_numpy((0.3 * np.random.default_rng(0).standard_normal((2, 1, t))).astype(np.float32)),
             "lengths": torch.tensor([t, t - 17])}
    made = []
    eval_generator = gan.eval_generator
    monkeypatch.setattr(gan, "eval_generator", lambda g, c: made.append(eval_generator(g, c)) or made[-1])
    eval_step = gan.make_eval_step(tcfg)
    first = eval_step(state, batch)[1]
    assert torch.equal(eval_step(state, batch)[1], first) and len(made) == 1
    assert next(made[0].parameters()).dtype == torch.bfloat16
    with torch.no_grad():
        state.generator.conv_pre.parametrizations.weight.original1.mul_(1.5)  # in place, at the same step
    changed = eval_step(state, batch)[1]
    assert len(made) == 2 and not torch.equal(changed, first)
    state.step += 1
    assert torch.equal(eval_step(state, batch)[1], changed) and len(made) == 2
