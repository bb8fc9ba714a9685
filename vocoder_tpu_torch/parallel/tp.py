"""Tensor parallelism across processes: the ``model`` axis of the JAX package's ("data", "model") mesh.

Counterpart of the model axis of ``vocoder_tpu/parallel/mesh.py`` (``make_mesh``, ``shard_channels``,
``constrain``, ``train_state_specs``) and of its models' explicit PartitionSpecs.  Under GSPMD a
sharded JAX program is numerically the unsharded one; here each process holds a shard of the
generator's parameters (``parallel/tp_specs.py``: the model's ``param_specs``) and its forward runs
the collectives that GSPMD would insert, so that every rank computes one process's forward and step:

- ``make_grid`` lays the processes out as ``make_mesh`` does, ``reshape(data, model)``: consecutive
  ranks form one model group, and the ranks that hold the same shard form a data group, over which
  data parallelism (``parallel/dist.py``) runs.
- Megatron's conjugate collectives, each with the backward that its place needs: ``copy_to``
  (identity forward, the group's sum backward: before a column-parallel layer, whose input is whole
  on every rank and whose shards each take a part of its gradient), ``reduce_from`` (the sum forward,
  identity backward: after a row-parallel layer, whose partial sums every rank adds up and whose
  consumer runs whole on every rank), ``gather`` (concatenated shards forward, this rank's slice
  backward) and ``scatter`` (this rank's slice forward, the gathered gradient backward).  A
  row-parallel weight norm sums its squares with ``sum_partials``, the sum in both directions:
  every rank's weight reads the whole norm.  Collectives are those that gloo runs on CUDA tensors
  (all-reduce, all-gather); a reduce-scatter is an all-reduce and a slice.  A failed one raises.
- ``conv`` and ``linear`` run a layer as its ``tp_layer`` (set by ``shard_module``) says, or as
  the plain layer; ``whole`` gathers a channel shard where a replicated layer follows.
- ``whole_blocks`` gives the kernel that takes a whole AMP stage (K2) the stage's gathered weights,
  made once per model state (``utils/weight_cache.py``), as GSPMD replicates a Pallas call on gathered
  operands.
- ``grad_norm`` is the whole gradient's norm, and ``whole_state_dict`` / ``shard_state`` and their
  optimizer counterparts turn a sharded state into whole tensors and back (checkpoints hold whole
  tensors, as Orbax saves global arrays).

A replicated parameter that a rank uses on its own shard (a row-parallel conv's gain g) enters
through ``copy_to``, so its gradient is the model group's sum when the backward ends, before AdamW.
Every parameter that the ranks hold whole then takes the group's mean of its gradient
(``average_replicated_grads``), so that their copies stay equal to the bit.

Storage shards (``storage_shard``; the JAX package's per-leaf fallback, ``parallel/tp_specs.py::
storage_dims``): a module without explicit specs keeps its computation whole on every rank, but each rank
stores only its contiguous slice of every tensor that the rule shards.  Each call of the module gathers all
of them over the model group (one all-gather of their bytes) and runs on the whole tensors, which it puts in
the slices' places for the call and takes out after it; the gather's backward is this rank's slice of the
whole gradient, with no collective, since every rank of the group runs the same call on the same inputs
and so holds the whole gradient.  A call inside ``nn.cast_parameters`` gathers the cast slices, and
``nn.checkpointed`` recomputes on the tensors gathered for the forward.  ``gathered`` does the same around
code that is not a call of the module (the vq's EMA update, which then writes this rank's slice back).  The
sharded tensors join the module's ``tp_params``, so that ``grad_norm``, ``average_replicated_grads``, the
whole state dicts and the optimizer's moments (sharded like their parameters) treat them as they treat the
explicit specs' shards.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from vocoder_tpu_torch.convert import shard_state_dict
from vocoder_tpu_torch.parallel import dist
from vocoder_tpu_torch.parallel.tp_specs import MIN_SIZE, Spec, key_dims, storage_dims
from vocoder_tpu_torch.utils.weight_cache import WeightCache


class ModelGroup:
    """The processes that hold the shards of one model: their process group, this rank's index among them
    and their number.  A deep copy of a module keeps the same group."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        return f"ModelGroup(rank={self.rank}, size={self.size})"


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, model) grid: its model group (None without tensor parallelism),
    the process group of data parallelism (None: one replica) and its index and size."""

    model: ModelGroup | None
    data: object | None
    data_rank: int
    data_size: int


def make_grid(model_parallel: int) -> Grid:
    """The (data, model) grid of the processes, ``make_mesh``'s ``reshape(data, model)``: ranks
    d * model_parallel ... (d + 1) * model_parallel - 1 form model group d.  Every rank creates every
    group, in one order.  ``model_parallel`` must divide the number of processes."""
    world, rank = dist.world_size(), dist.rank()
    if model_parallel < 1 or world % model_parallel:
        raise SystemExit(f"run.model_parallel={model_parallel} does not divide the {world} processes")
    if model_parallel == 1:
        return Grid(None, dist.world_group(), rank, world)
    data = world // model_parallel
    grid = np.arange(world).reshape(data, model_parallel)
    model_group = data_group = None
    for row in grid:
        g = tdist.new_group(row.tolist())
        if rank in row:
            model_group = ModelGroup(g, rank % model_parallel, model_parallel)
    if data > 1:
        for col in grid.T:
            g = tdist.new_group(col.tolist())
            if rank in col:
                data_group = g
    return Grid(model_group, data_group, rank // model_parallel, data)


def _all_reduce(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    y = x.clone()
    tdist.all_reduce(y, group=mg.group)
    return y


def _all_gather(x: torch.Tensor, mg: ModelGroup, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mg.size)]
    tdist.all_gather(parts, x, group=mg.group)
    return torch.cat(parts, dim)


def _slice(x: torch.Tensor, mg: ModelGroup, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    if n % mg.size:
        raise ValueError(f"tensor parallelism: {n} channels do not split over {mg.size} model ranks")
    return x.narrow(dim, mg.rank * (n // mg.size), n // mg.size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg  # the backward may run on autograd's own thread
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mg), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        return _all_reduce(x, mg)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return _all_reduce(x, mg)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mg), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim = mg, dim
        return _all_gather(x, mg, dim)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.mg, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim = mg, dim
        return _slice(x, mg, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.mg, ctx.dim), None, None


def copy_to(x: torch.Tensor, mg: ModelGroup | None) -> torch.Tensor:
    """x, whose gradient is summed over the model group in the backward (the input of a column-parallel
    layer, a replicated parameter used on this rank's shard)."""
    return x if mg is None else _CopyTo.apply(x, mg)


def reduce_from(x: torch.Tensor, mg: ModelGroup | None) -> torch.Tensor:
    """x summed over the model group (partial sums of a row-parallel layer); the gradient passes as it is."""
    return x if mg is None else _ReduceFrom.apply(x, mg)


def sum_partials(x: torch.Tensor, mg: ModelGroup | None) -> torch.Tensor:
    """x summed over the model group, and so is its gradient: every rank's consumer reads the sum."""
    return x if mg is None else _SumPartials.apply(x, mg)


def gather(x: torch.Tensor, mg: ModelGroup | None, dim: int) -> torch.Tensor:
    """The model group's shards of x concatenated along ``dim``, in rank order; backward: this rank's slice."""
    return x if mg is None else _Gather.apply(x, mg, dim)


def scatter(x: torch.Tensor, mg: ModelGroup | None, dim: int) -> torch.Tensor:
    """This rank's shard of x along ``dim`` (contiguous); backward: the gathered gradient."""
    return x if mg is None else _Scatter.apply(x, mg, dim)


def whole(x: torch.Tensor, channels: int, mg: ModelGroup | None, dim: int = 1) -> torch.Tensor:
    """x with all its ``channels`` along ``dim``: gathered over the model group where x is a shard."""
    return x if mg is None or x.shape[dim] == channels else gather(x, mg, dim)


@dataclasses.dataclass(frozen=True)
class Layer:
    """How a sharded layer computes: its spec and its model group."""

    spec: Spec
    group: ModelGroup


def group_of(module: nn.Module) -> ModelGroup | None:
    """The model group of a sharded layer, None for a replicated one."""
    layer = getattr(module, "tp_layer", None)
    return None if layer is None else layer.group


def layer_weight(module: nn.Module) -> torch.Tensor:
    """The weight that this rank's shard of ``module`` computes with.  A row-parallel weight-normed conv's
    norm is over the whole direction (I is split): the squares summed over the model group
    (``sum_partials``), and its replicated gain enters through ``copy_to``."""
    layer = getattr(module, "tp_layer", None)
    if layer is None or layer.spec.kind != "row" or not parametrize.is_parametrized(module, "weight"):
        return module.weight
    wn = module.parametrizations.weight
    g, v = wn.original0, wn.original1
    sq = torch.sum(torch.square(v.float()), dim=tuple(range(1, v.dim())), keepdim=True)
    norm = torch.sqrt(sum_partials(sq, layer.group)).to(v.dtype)
    return v * (copy_to(g, layer.group) / norm)


def _conv_op(module: nn.Module, x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    if isinstance(module, nn.ConvTranspose1d):
        return F.conv_transpose1d(x, w, b, module.stride, module.padding, module.output_padding, module.groups,
                                  module.dilation)
    return module._conv_forward(x, w, b)


def conv(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d or ConvTranspose1d on (B, C, T): the plain layer, or this rank's part of a sharded one.
    Column-parallel: the whole input, this rank's output channels.  Row-parallel: this rank's input
    channels, the group's sum kept as this rank's output shard (or whole, for a narrow output)."""
    layer = getattr(module, "tp_layer", None)
    if layer is None:
        return module(x)
    mg = layer.group
    if layer.spec.kind == "col":
        return _conv_op(module, copy_to(x, mg), layer_weight(module), module.bias)
    y = reduce_from(_conv_op(module, x, layer_weight(module), None), mg)
    if layer.spec.out_sharded:
        y = scatter(y, mg, 1)
    return y if module.bias is None else y + module.bias[:, None]


def linear(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Linear, or a kernel-size-1 Conv1d taken as one, on (..., C): the plain matmul, or this rank's
    part of a sharded one (column-parallel: this rank's output features; row-parallel: this rank's
    input features, the group's sum, the replicated bias)."""
    w = module.weight if module.weight.dim() == 2 else module.weight[:, :, 0]
    layer = getattr(module, "tp_layer", None)
    if layer is None:
        return F.linear(x, w, module.bias)
    mg = layer.group
    if layer.spec.kind == "col":
        return F.linear(copy_to(x, mg), w, module.bias)
    y = reduce_from(F.linear(x, w), mg)
    if layer.spec.out_sharded:
        y = scatter(y, mg, -1)
    return y if module.bias is None else y + module.bias


def shard_module(model: nn.Module, specs: dict, mg: ModelGroup | None) -> nn.Module:
    """Keep, in place, this rank's shard of every parameter that ``specs`` (a model's ``param_specs``)
    shards, and mark each sharded layer (``tp_layer``) so that ``conv`` and ``linear`` compute its part.
    The model records its group (``model_group``) and its sharded parameters' dims (``tp_params``).
    Without a group of more than one rank, or where nothing shards, the model stays as it is."""
    if mg is None or mg.size == 1 or not specs:
        return model
    modules = dict(model.named_modules())
    missing = sorted(set(specs) - set(modules))
    if missing:
        raise KeyError(f"tensor parallelism: the model has no {missing}")
    params = dict(model.named_parameters())
    dims = key_dims(specs, params)
    if not dims:
        return model
    shards = shard_state_dict({name: params[name].data for name in dims}, specs, mg.rank, mg.size)
    for name, shard in shards.items():
        params[name].data = shard
    for name, spec in specs.items():
        modules[name].tp_layer = Layer(spec, mg)
    model.model_group, model.tp_params = mg, dims
    return model


def is_sharded(module: nn.Module) -> bool:
    return getattr(module, "model_group", None) is not None


def _stores(module: nn.Module, names) -> list:
    """(the dict that holds it, its key) of each named parameter or buffer of ``module``."""
    out = []
    for name in names:
        prefix, _, attr = name.rpartition(".")
        owner = module.get_submodule(prefix)
        out.append((owner._parameters if attr in owner._parameters else owner._buffers, attr))
    return out


def _gather_many(tensors: list, dims: list, mg: ModelGroup) -> list:
    """The model group's shards of each tensor concatenated along its dim, in rank order: one all-gather of
    all their bytes."""
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(mg.size)]
    tdist.all_gather(parts, flat, group=mg.group)
    out, at = [], 0
    for t, d in zip(tensors, dims):
        n = t.numel() * t.element_size()
        out.append(torch.cat([p[at : at + n].view(t.dtype).view(t.shape) for p in parts], d))
        at += n
    return out


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mg, dims, *shards):
        ctx.mg, ctx.dims = mg, dims
        ctx.set_materialize_grads(False)
        wholes = tuple(_gather_many(list(shards), dims, mg))
        ctx.mark_non_differentiable(*(w for w, s in zip(wholes, shards) if not s.requires_grad))  # buffers
        return wholes

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *(None if g is None else _slice(g, ctx.mg, d) for g, d in zip(grads, ctx.dims)))


def _swap_in(module: nn.Module, names: list) -> list:
    """Put the whole tensors of ``module``'s storage shards ``names`` in their slices' places (through the
    gather's autograd function); what ``_swap_out`` takes to put the slices back."""
    if not names:
        return []
    stores = _stores(module, names)
    shards = [store[key] for store, key in stores]
    wholes = _GatherShards.apply(module.model_group, tuple(module.tp_storage[n] for n in names), *shards)
    for (store, key), w in zip(stores, wholes):
        store[key] = w
    return [(store, key, shard) for (store, key), shard in zip(stores, shards)]


def _swap_out(swapped: list) -> None:
    for store, key, shard in swapped:
        store[key] = shard


def _gather_hook(module: nn.Module, args) -> None:
    module._tp_swapped.append(_swap_in(module, list(module.tp_storage)))


def _release_hook(module: nn.Module, args, output) -> None:
    _swap_out(module._tp_swapped.pop())


@contextlib.contextmanager
def gathered(module: nn.Module, prefix: str = ""):
    """Within the block, ``module``'s storage shards under ``prefix`` are whole (gathered over the model group,
    no autograd); after it each sharded buffer takes this rank's slice of what the block left in the whole
    one.  Every rank of the group must enter.  Nothing for a module without storage shards."""
    names = [n for n in getattr(module, "tp_storage", {}) if n.startswith(prefix)]
    with torch.no_grad():
        swapped = _swap_in(module, names)
    try:
        yield module
    finally:
        with torch.no_grad():
            for (store, key, shard), name in zip(swapped, names):
                if not isinstance(shard, nn.Parameter):
                    shard.copy_(_slice(store[key], module.model_group, module.tp_storage[name]))
        _swap_out(swapped)


def storage_shard(module: nn.Module, mg: ModelGroup | None, min_size: int = MIN_SIZE) -> nn.Module:
    """Keep, in place, this rank's slice of every parameter (and codebook buffer) of ``module`` that the storage
    rule (``tp_specs.storage_dims``) shards over ``mg``, and gather them where the module is called.  The module
    records its group (``model_group``) and the sharded tensors' dims (``tp_storage``, also ``tp_params``).  A
    ``ModuleDict`` (the discriminators, each called on its own) is sharded child by child and records their
    dims under the children's names.  Without a group of more than one rank, or where nothing shards, the
    module stays as it is.  A dim that does not split raises."""
    if mg is None or mg.size == 1:
        return module
    if isinstance(module, nn.ModuleDict):
        dims = {}
        for key, child in module.items():
            storage_shard(child, mg, min_size)
            dims.update({f"{key}.{n}": d for n, d in getattr(child, "tp_storage", {}).items()})
        if dims:
            module.model_group, module.tp_params = mg, dims
        return module
    dims = storage_dims(module, mg.size, min_size)
    if not dims:
        return module
    with torch.no_grad():
        for (store, key), (name, d) in zip(_stores(module, dims), dims.items()):
            if isinstance(store[key], nn.Parameter):
                store[key].data = _slice(store[key].data, mg, d)
            else:
                store[key] = _slice(store[key], mg, d)
    module.model_group, module.tp_params, module.tp_storage, module._tp_swapped = mg, dims, dims, []
    module.register_forward_pre_hook(_gather_hook)
    module.register_forward_hook(_release_hook, always_call=True)
    return module


def held_bytes(module: nn.Module, optimizer: torch.optim.Optimizer | None = None) -> dict[str, int]:
    """The bytes this rank holds of ``module``: its parameters, the buffers of its training state (those that a
    submodule names in ``state_buffers``: the vq codebooks) and, with ``optimizer``, the optimizer's state
    tensors but its step counts (AdamW's moments)."""
    buffers = [getattr(sub, name) for sub in module.modules() for name in getattr(sub, "state_buffers", ())]
    out = {"parameters": sum(p.numel() * p.element_size() for p in module.parameters()),
           "buffers": sum(b.numel() * b.element_size() for b in buffers)}
    if optimizer is not None:
        out["moments"] = sum(v.numel() * v.element_size() for s in optimizer.state.values() for k, v in s.items()
                             if torch.is_tensor(v) and k != "step")
    return out


def grad_norm(module: nn.Module) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient of ``module`` (optax.global_norm), over the whole
    gradient where it holds shards: each sharded tensor's squares summed over the model group, each
    replicated one counted once."""
    named = [(n, p.grad) for n, p in module.named_parameters() if p.grad is not None]
    norms = [torch.linalg.vector_norm(g) for _, g in named]
    if is_sharded(module):
        idx = [i for i, (n, _) in enumerate(named) if n in module.tp_params]
        if idx:
            sq = torch.stack([norms[i] for i in idx]).square()
            tdist.all_reduce(sq, group=module.model_group.group)
            for i, v in zip(idx, sq.sqrt().unbind()):
                norms[i] = v
    return torch.linalg.vector_norm(torch.stack(norms))


def average_replicated_grads(module: nn.Module, mg: ModelGroup | None) -> None:
    """The gradient of every parameter of ``module`` that each rank of the model group holds whole (all of an
    unsharded module's; a sharded one's outside ``tp_params``) set to its mean over the group, through one flat
    all-reduce a dtype.  Every rank computes that gradient from the same whole inputs, so the mean is the
    gradient itself; where a backward is not bitwise deterministic (cuDNN's on cards) it keeps the copies in
    lockstep, as the one global array of GSPMD is.  Nothing without a group of more than one rank."""
    if mg is None or mg.size == 1:
        return
    sharded = getattr(module, "tp_params", {})
    grads = [p.grad for n, p in module.named_parameters() if p.grad is not None and n not in sharded]
    if grads:
        dist.coalesced(grads, lambda flat: (tdist.all_reduce(flat, group=mg.group), flat.div_(mg.size)))


def _gather_dict(tensors: dict, dims: dict, mg: ModelGroup) -> dict:
    with torch.no_grad():
        return {k: _all_gather(v.detach(), mg, dims[k]) if k in dims else v for k, v in tensors.items()}


def whole_state_dict(module: nn.Module, tensors: dict | None = None) -> dict:
    """``module.state_dict()``, or ``tensors`` keyed by its parameters' names (their gradients, say), with whole
    tensors: those of sharded parameters gathered over the model group (every rank of it must call)."""
    tensors = module.state_dict() if tensors is None else tensors
    return _gather_dict(tensors, module.tp_params, module.model_group) if is_sharded(module) else tensors


def shard_state(module: nn.Module, sd: dict) -> dict:
    """This rank's shard of a whole state_dict for ``module`` (as it is for an unsharded module)."""
    if not is_sharded(module):
        return sd
    dims, mg = module.tp_params, module.model_group
    return {k: _slice(v, mg, dims[k]) if k in dims else v for k, v in sd.items()}


def _moment_dims(module: nn.Module, sd: dict) -> dict:
    """{index in the optimizer's state: {moment name: dim}} for the moments of sharded parameters (an
    optimizer over ``module.parameters()``, in that order; the step counts stay whole)."""
    names = [n for n, _ in module.named_parameters()]
    return {i: {k: module.tp_params[names[int(i)]] for k, v in s.items() if torch.is_tensor(v) and v.dim() > 0}
            for i, s in sd["state"].items() if names[int(i)] in module.tp_params}


def whole_optimizer_state(opt: torch.optim.Optimizer, module: nn.Module) -> dict:
    """``opt.state_dict()`` of an optimizer over ``module.parameters()`` (in that order), each moment of a
    sharded parameter gathered like it."""
    sd = opt.state_dict()
    if not is_sharded(module):
        return sd
    dims = _moment_dims(module, sd)
    state = {i: _gather_dict(s, dims.get(i, {}), module.model_group) for i, s in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def shard_optimizer_state(sd: dict, module: nn.Module) -> dict:
    """This rank's part of a whole optimizer state_dict for ``module``'s parameters."""
    if not is_sharded(module):
        return sd
    dims = _moment_dims(module, sd)
    mg = module.model_group
    state = {i: {k: _slice(v, mg, dims[i][k]) if k in dims.get(i, {}) else v for k, v in s.items()}
             for i, s in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


whole_stages = WeightCache()  # first shard block -> the whole blocks


@torch.inference_mode(False)
@torch.no_grad()
def _whole_module(block: nn.Module, mg: ModelGroup) -> nn.Module:
    whole = copy.deepcopy(block)
    shards = dict(block.named_modules())
    for name, m in whole.named_modules():
        layer = getattr(shards[name], "tp_layer", None)
        if layer is None:
            continue
        del m.tp_layer
        src, dims = shards[name], dict(layer.spec.dims)
        if layer.spec.kind == "param":
            for pname, d in dims.items():
                if getattr(src, pname, None) is not None:
                    setattr(m, pname, nn.Parameter(_all_gather(getattr(src, pname).detach(), mg, d)))
            continue
        w = _all_gather(layer_weight(src).detach(), mg, dims["weight"])
        if parametrize.is_parametrized(m, "weight"):
            parametrize.remove_parametrizations(m, "weight", leave_parametrized=True)
        m.weight = nn.Parameter(w)
        if "bias" in dims:
            m.bias = nn.Parameter(_all_gather(src.bias.detach(), mg, dims["bias"]))
    whole.requires_grad_(False)
    return whole


def whole_blocks(blocks: list, mg: ModelGroup, device: torch.device) -> list:
    """Whole-width copies of a stage's blocks whose shards this rank holds, for K2, which takes a whole
    stage: every sharded weight gathered over the model group (a row-parallel conv's from its weight
    norm with the group's norm, folded), alpha and beta too.  Kept in ``whole_stages`` by the rule of
    ``utils/weight_cache.py``, so that K2 packs them once a model state; the ranks agree on reusing them
    through one small all-reduce, as the making gathers over the group."""

    def all_fresh(fresh: bool) -> bool:
        miss = torch.tensor([0.0 if fresh else 1.0], device=device)
        tdist.all_reduce(miss, group=mg.group)
        return float(miss) == 0.0

    return whole_stages.get(blocks[0], blocks, lambda: [_whole_module(b, mg) for b in blocks], agree=all_fresh)
