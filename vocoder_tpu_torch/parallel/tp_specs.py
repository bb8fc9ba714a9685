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
"""

from __future__ import annotations

import dataclasses

MIN_CHANNELS = 128  # vocoder_tpu/models/hifigan.py::_TP_MIN_CHANNELS (one 128-lane tile per device)


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
