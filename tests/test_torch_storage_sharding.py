"""Which tensor each rank of a model group stores in shards, against the JAX package's ``train_state_specs``.

For each family and generator at its preset (44.1 kHz; RefineGAN 24 kHz, ssl 16 kHz), the port's training
state under a model group of two (``gan.create_train_state`` with a ``ModelGroup`` of rank 0 of 2; building it
only slices tensors, no collective runs) against ``train_state_specs(jax.eval_shape(create_train_state),
make_mesh(data=1, model=2), model_param_specs)`` on the conftest's fake CPU devices, leaf by leaf: each port
tensor, whole, is filled with its index along the dim it is sharded on (0 where it is whole) and carried into
the JAX package's tree by its own ``from_torch_state_dict``; the JAX leaf must then vary along the axis that
its spec shards and along no other, or along none where the spec is replicated.  That covers the parameters
and the vq codebooks; Adam's moments in JAX take their parameter's spec, as the port's AdamW moments take
their parameter's shape.  Each rank's bytes per part equal JAX's per-device bytes to the byte
(``tests/test_sharding.py::_per_device_bytes``' count).  Shapes and index fills only: no step, no gloo.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_family_train import discriminators_to_jax, vq_to_jax
from tests.test_torch_storage_sharding_steps import generator_to_jax
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu.config import build_task_config as jax_build_task_config
from vocoder_tpu.models import bigvgan as jbigvgan
from vocoder_tpu.models import hifigan as jhifigan
from vocoder_tpu.models import vocos as jvocos
from vocoder_tpu.parallel import make_mesh
from vocoder_tpu.parallel.mesh import train_state_specs
from vocoder_tpu.train import gan as jgan
from vocoder_tpu_torch.config import build_task_config
from vocoder_tpu_torch.parallel import tp
from vocoder_tpu_torch.train import gan

MODEL_PARALLEL = 2
CASES = [("hifigan", "44100_512_2048", "gan"), ("bigvgan", "44100_512_2048", "gan"), ("vocos", "44100_512_2048", "gan"),
         ("refinegan", "24000_256_1024", "gan"), ("firefly_gan_base", "44100_512_2048", "gan"),
         ("hifigan", "44100_512_2048", "vae"), ("hifigan", "44100_512_2048", "vqvae"),
         ("hifigan", "16000_640_2048", "ssl")]
EXPLICIT = {"hifigan": jhifigan, "bigvgan": jbigvgan, "vocos": jvocos}  # the "gan" family's generators with specs
# The gan and vae tasks' discriminators at 44.1 kHz (MPD + MRD) and the vqvae codebook state: (whole bytes,
# a rank's bytes), from JAX.
DISC_BYTES = (99_563_616, 51_394_656)
CODEBOOK_BYTES = (16_793_600, 8_404_992)


def _index_filled(module: torch.nn.Module) -> dict:
    """{key: whole tensor} of ``module.state_dict()`` (a rank's shards made whole again by their shape): each
    tensor that the module stores sharded holds its index along that dim, the others 0 (expanded views)."""
    dims = getattr(module, "tp_params", {})
    out = {}
    for key, shard in module.state_dict().items():
        shape = list(shard.shape)
        if key in dims:
            d = dims[key]
            shape[d] *= MODEL_PARALLEL
            view = [1] * len(shape)
            view[d] = shape[d]
            out[key] = torch.arange(shape[d], dtype=torch.float32).view(view).expand(shape)
        else:
            out[key] = torch.zeros((), dtype=torch.float32).expand(shape)
    return out


def _sharded_axes(leaf) -> list[int]:
    """The axes along which an index-filled leaf varies."""
    a = np.asarray(leaf)
    return [ax for ax in range(a.ndim)
            if a.shape[ax] > 1 and not np.array_equal(a.take([0], axis=ax), a.take([1], axis=ax))]


def _spec_axes(sharding) -> list[int]:
    return [ax for ax, name in enumerate(sharding.spec) if name is not None]


def _per_device(tree, spec_tree) -> tuple[int, int]:
    total = per = 0
    for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(spec_tree, is_leaf=lambda x: hasattr(x, "spec"))):
        n = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        total += n
        per += n // (MODEL_PARALLEL if _spec_axes(sh) else 1)
    return total, per


def _generator_tree(model: str, family: str, jcfg, sd: dict) -> dict:
    if family == "gan" and model in EXPLICIT:
        return EXPLICIT[model].from_torch_state_dict(sd, jcfg.generator)
    return generator_to_jax(model if family == "gan" else family, jcfg.generator, sd)


@pytest.mark.parametrize("model,resolution,family", CASES, ids=[f"{f}-{m}" for m, _, f in CASES])
def test_storage_layout_equals_jax_train_state_specs(model, resolution, family):
    jcfg = jax_build_task_config(model=model, resolution=resolution, family=family)
    abstract = jax.eval_shape(lambda k: jgan.create_train_state(k, jcfg), jax.random.key(0))
    mesh = make_mesh(data=1, model=MODEL_PARALLEL, devices=jax.devices()[:MODEL_PARALLEL])
    specs = train_state_specs(abstract, mesh, jgan.model_param_specs(jcfg))
    state = gan.create_train_state(build_task_config(model, resolution, family), 0, "cpu",
                                   tp.ModelGroup(None, 0, MODEL_PARALLEL))

    gen_sd, disc_sd = _index_filled(state.generator), _index_filled(state.discriminators)
    trees = {"gen_params": _generator_tree(model, family, jcfg, gen_sd), "disc_params": discriminators_to_jax(jcfg, disc_sd)}
    if abstract.extra is not None:
        trees["extra"] = {"vq": vq_to_jax(gen_sd, len(abstract.extra["vq"]["layers"]))}
    for part, tree in trees.items():
        want = getattr(specs, part)
        assert jax.tree.structure(tree) == jax.tree.structure(getattr(abstract, part)), part
        paths = jax.tree_util.tree_leaves_with_path(tree)
        shardings = jax.tree.leaves(want, is_leaf=lambda x: hasattr(x, "spec"))
        for (path, leaf), sh in zip(paths, shardings):
            assert _sharded_axes(leaf) == _spec_axes(sh), (part, jax.tree_util.keystr(path), sh.spec)
    # AdamW's moments: JAX's take their parameter's spec, leaf by leaf (the port's follow their parameter).
    for opt, params in (("opt_g", "gen_params"), ("opt_d", "disc_params")):
        for moment in ("mu", "nu"):
            assert getattr(getattr(specs, opt)[0], moment) == getattr(specs, params), (opt, moment)

    # Bytes: each of AdamW's two moments holds its parameters' bytes, as each of Adam's mu and nu.
    held = {part: tp.held_bytes(m) for part, m in (("gen_params", state.generator), ("disc_params", state.discriminators))}
    for part, opt in (("gen_params", "opt_g"), ("disc_params", "opt_d")):
        assert held[part]["parameters"] == _per_device(getattr(abstract, part), getattr(specs, part))[1], part
        for moment in ("mu", "nu"):
            mine = _per_device(getattr(getattr(abstract, opt)[0], moment), getattr(getattr(specs, opt)[0], moment))[1]
            assert held[part]["parameters"] == mine, (opt, moment)
    codebooks = _per_device(abstract.extra, specs.extra) if abstract.extra is not None else (0, 0)
    assert held["gen_params"]["buffers"] == codebooks[1]
    if family in ("gan", "vae") and resolution.startswith("44100"):  # the gan task's MPD and MRD
        assert _per_device(abstract.disc_params, specs.disc_params) == DISC_BYTES
    if family == "vqvae":
        assert codebooks == CODEBOOK_BYTES
