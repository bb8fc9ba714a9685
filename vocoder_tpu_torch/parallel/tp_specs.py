"""Tensor-parallel layouts of the port's layers: which dim of which parameter a rank holds a shard of.

Counterpart of ``vocoder_tpu/parallel/tp_specs.py`` (and of the ``param_specs`` trees of the JAX
package's models), in the port's torch layouts.  A model's ``param_specs(cfg)`` maps a module name
(``named_modules()``'s) to a ``Spec``; a module it does not name is replicated over the model group.
A ``Spec`` names the layer's kind, the dim that each of its parameters is sharded on, and whether its
output is a channel shard:

- ``col``: column-parallel.  The input is whole on every rank, the output's channels are sharded
  (a conv1d's weight (O, I, K) on O, its weight-norm gain g (O, 1, 1) and bias on O; a linear's
  weight (O, I) and bias on O).
- ``row``: row-parallel.  The input is a channel shard, each rank forms the partial sums of its input
  channels, and the model group's sum is kept as this rank's output shard (the bias sharded on O)
  when the output is wide enough, else whole on every rank (the bias replicated).  A conv1d's weight
  (O, I, K) is sharded on I; its g stays replicated, and the norm over (I, K) is the group's.
- ``row_up``: a row-parallel transposed conv: weight (I, O, K) and g (I, 1, 1) on I (its norm over
  (O, K) is local), the bias as ``row``'s.
- ``param``: parameters sharded with the channels they act on (Snake's alpha and beta).

The gate is the JAX package's: a layer whose sharded width is under ``MIN_CHANNELS`` replicates, so that
the same parameters shard as in its spec trees.  It changes no number: every layout computes the
unsharded function.

Storage sharding (``storage_dims``), the JAX package's fallback (``vocoder_tpu/parallel/mesh.py::
_heuristic_spec``, ``infer_param_specs`` and ``train_state_specs``): every tensor of the training state that no
explicit spec covers (the discriminators, a generator without ``param_specs`` or outside the "gan" family, the
vq codebooks; the AdamW moments follow their parameter) is stored in shards along one dim when it holds at least
``min_size`` elements: the first axis, in the JAX layout of the tensor, whose size the model group divides with
at least 8 elements a shard, taking the JAX layout's last axis (the output channels) first, then its axes in
order.  The rule is decided in the JAX layout (``JAX_AXES``: a conv1d's (O, I, K) is JAX's (K, I, O), a
transposed conv's (I, O, K) its (K, I, O), a conv2d's (O, I, kH, kW) its (kH, kW, I, O), a linear's (O, I)
its (I, O); a weight-norm gain takes its conv's order, as (O, 1, 1) is JAX's (1, 1, O); anything else, the
codebooks included, is laid out as in JAX) and mapped back to the torch dim.  Folded weights (inference) take
the same rule.  A generator with ``param_specs`` in the "gan" family takes its explicit specs for every
tensor, as the JAX package's spec trees cover every leaf of those generators; JAX's matching of a leaf's path
suffix against the generator's spec paths reaches no discriminator leaf of any preset, which is why the
discriminators take the rule alone (``tests/test_torch_storage_sharding.py`` holds every leaf's decision to
JAX's).  Storage sharding changes where the bytes live, not what is computed: ``parallel/tp.py`` gathers the
whole tensor where the module uses it.
"""

from __future__ import annotations

import dataclasses
import math

from torch import nn

MIN_CHANNELS = 128  # vocoder_tpu/models/hifigan.py::_TP_MIN_CHANNELS (one 128-lane tile per device)
MIN_SIZE = 1 << 16  # vocoder_tpu/parallel/mesh.py::infer_param_specs's min_size: smaller tensors stay whole
MIN_SHARD = 8  # elements of the sharded dim a rank must hold
# The torch dim of each axis of the JAX layout of a layer's weight (and weight-norm gain), by layer type.
JAX_AXES = ((nn.ConvTranspose1d, (2, 0, 1)), (nn.Conv1d, (2, 1, 0)), (nn.Conv2d, (2, 3, 1, 0)), (nn.Linear, (1, 0)))


@dataclasses.dataclass(frozen=True)
class Spec:
    kind: str  # "col", "row", "row_up" or "param"
    dims: tuple  # ((role, dim), ...): role "weight" (a weight-norm direction, or a plain weight), "g", "bias", ...
    out_sharded: bool  # whether the layer's output is this rank's channel shard


def col_conv(c_out: int) -> Spec | None:
    """Column-parallel weight-normed conv1d: weight, g and bias on O."""
    if c_out < MIN_CHANNELS:
        return None
    return Spec("col", (("weight", 0), ("g", 0), ("bias", 0)), True)


def row_conv(c_in: int, c_out: int) -> Spec | None:
    """Row-parallel weight-normed conv1d: weight on I, g replicated, bias on O where the output is wide."""
    if c_in < MIN_CHANNELS:
        return None
    wide = c_out >= MIN_CHANNELS
    return Spec("row", (("weight", 1),) + ((("bias", 0),) if wide else ()), wide)


def row_up(c_in: int, c_out: int) -> Spec | None:
    """Row-parallel weight-normed ConvTranspose1d: weight (I, O, K) and g (I, 1, 1) on I, bias as ``row_conv``."""
    if c_in < MIN_CHANNELS:
        return None
    wide = c_out >= MIN_CHANNELS
    return Spec("row_up", (("weight", 0), ("g", 0)) + ((("bias", 0),) if wide else ()), wide)


def noise_conv(c_out: int) -> Spec | None:
    """The f0 template's plain conv 1 -> c_out: column-parallel (weight (O, 1, K) and bias on O)."""
    if c_out < MIN_CHANNELS:
        return None
    return Spec("col", (("weight", 0), ("bias", 0)), True)


def snake(channels: int) -> Spec | None:
    """Snake's per-channel alpha and beta, sharded with their channels."""
    if channels < MIN_CHANNELS:
        return None
    return Spec("param", (("alpha", 0), ("beta", 0)), True)


def col_linear() -> Spec:
    """Column-parallel linear (Megatron's first MLP matmul, or a kernel-size-1 conv such as Vocos's
    iSTFT-head projection): weight (O, I[, 1]) and bias on O, with no gate."""
    return Spec("col", (("weight", 0), ("bias", 0)), True)


def row_linear() -> Spec:
    """Row-parallel linear (Megatron's second MLP matmul): weight (O, I) on I, bias replicated, output whole."""
    return Spec("row", (("weight", 1),), False)


# The tail of a state_dict key (or a parameter's name) -> its role in a Spec.
ROLES = (("parametrizations.weight.original1", "weight"), ("parametrizations.weight.original0", "g"),
         ("weight", "weight"), ("bias", "bias"), ("alpha", "alpha"), ("beta", "beta"))


def key_dims(specs: dict, keys) -> dict[str, int]:
    """{key: the dim it is sharded on} for the keys (state_dict keys or parameter names) that ``specs``
    shards; a key absent from the result is replicated.  A folded weight (``<module>.weight`` of a
    weight-normed layer) takes the direction's dim, as the JAX package's ``fold_weight_norm_specs``."""
    out = {}
    for key in keys:
        for tail, role in ROLES:
            if key.endswith("." + tail):
                spec = specs.get(key[: -len(tail) - 1])
                if spec is not None and role in dict(spec.dims):
                    out[key] = dict(spec.dims)[role]
                break
    return out


def heuristic_dim(shape: tuple, axes: tuple, model: int, min_size: int = MIN_SIZE) -> int | None:
    """The torch dim that a tensor of ``shape`` is stored sharded on over ``model`` ranks, or None (whole):
    ``_heuristic_spec``'s rule on the JAX layout, whose axis i is the torch dim ``axes[i]``."""
    if model == 1 or not shape or math.prod(shape) < min_size:
        return None
    for d in (axes[-1], *axes[:-1]):
        if shape[d] % model == 0 and shape[d] // model >= MIN_SHARD:
            return d
    return None


def _layer_axes(module: nn.Module) -> dict[str, tuple]:
    """{name: JAX axes} of every conv's and linear's weight-shaped tensors (weight, weight-norm direction and
    gain) in ``module``; a tensor absent from it has JAX's layout."""
    out = {}
    for prefix, layer in module.named_modules():
        axes = next((a for cls, a in JAX_AXES if isinstance(layer, cls)), None)
        if axes is not None:
            for name, p in layer.named_parameters():
                if p.dim() == len(axes):
                    out[f"{prefix}.{name}" if prefix else name] = axes
    return out


def storage_dims(module: nn.Module, model: int, min_size: int = MIN_SIZE) -> dict[str, int]:
    """{name: torch dim} of the parameters of ``module``, and of the buffers that a submodule names in its
    ``state_buffers`` (the vq codebooks, which the JAX package's TrainState holds), that the storage rule shards
    over ``model`` ranks.  It reads shapes only."""
    axes = _layer_axes(module)
    tensors = dict(module.named_parameters())
    for prefix, sub in module.named_modules():
        for name in getattr(sub, "state_buffers", ()):
            tensors[f"{prefix}.{name}" if prefix else name] = getattr(sub, name)
    out = {}
    for name, t in tensors.items():
        d = heuristic_dim(tuple(t.shape), axes.get(name, tuple(range(t.dim()))), model, min_size)
        if d is not None:
            out[name] = d
    return out
