"""Data parallelism across processes: torchrun's environment, the process group, and the global batch.

Counterpart of the data axis of ``vocoder_tpu/parallel/mesh.py`` and of
``maybe_init_distributed`` (``vocoder_tpu/train/trainer.py``).  Under GSPMD the
JAX step on a ``data`` mesh is the step of the global batch; here each process
("rank", one card each under ``torchrun``) holds its share of that batch, and a
step inside ``data_parallel(group)`` is written so that it equals one
process's step on the ranks' batches concatenated in rank order:

- every loss term is this rank's share of the global term (``mean_share``: a
  mean over the batch divided by the number of ranks; a sum over batch rows
  as it is), so the gradients summed over the ranks (``all_reduce_grads``)
  are the global loss's, and the logged values summed likewise
  (``all_reduce_sum``) are the global values;
- what is not a mean or a sum over the batch takes its all-reduced parts:
  the spectral convergence's two sums of squares (``losses/stft_loss.py``),
  bnvae's batch statistics (``models/wavenet.py``, through
  ``all_reduce_sum_autograd``, whose backward all-reduces the gradient as
  ``SyncBatchNorm``'s does) and the EMA codebooks' counts and sums
  (``models/vq.py``);
- a draw with a batch axis (``batch_draw``: drop_path masks, the vae's eps,
  RefineGAN's AdaIN noise) is drawn at the global batch's shape from a
  generator that every rank seeds alike, and each rank keeps its own rows,
  so the generators stay in lockstep and the draws are one process's.

Under tensor parallelism (``parallel/tp.py``) the group of ``data_parallel``
is the data group of the (data, model) grid, the ranks that hold the same
shard of the generator, not the world: every rank and size above is the data
group's, so the ranks of one model group read the same share of the batch and
draw the same rows.

``init_from_env`` reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``: on ``cuda`` it first makes
``cuda:LOCAL_RANK`` the current device (the hand kernels launch through
ctypes on the CUDA runtime's current device, and K1's library handle is made
once a process), then joins NCCL; on the CPU, gloo.  Without those variables
it is the single process.  A failed init raises: the run never goes on as N
single processes.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import socket

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

# The process group of the data-parallel computation in progress (``data_parallel``), or None.
_GROUP: contextvars.ContextVar = contextvars.ContextVar("data_parallel_group", default=None)


def init_from_env(device, backend: str | None = None) -> torch.device:
    """Join the process group that torchrun's environment describes; the device this rank computes on.

    ``device``: "cuda" (then ``cuda:LOCAL_RANK``, set current before anything else touches the card) or
    "cpu".  ``backend``: NCCL on the card and gloo on the CPU unless named (gloo also moves CUDA tensors).
    Without torchrun's variables: ``device`` as given, no group.  Some of them but not all raises, and so
    does a failed init."""
    device = torch.device(device)
    present = [k for k in ENV if k in os.environ]
    if not present:
        return device
    if len(present) < len(ENV):
        raise RuntimeError(f"data parallelism: {sorted(set(ENV) - set(present))} unset beside {present}; "
                           "launch with torchrun, or unset them all for one process")
    local = int(os.environ["LOCAL_RANK"])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device is available; pass --device cpu to train on the CPU")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        bound = {"device_id": device} if backend == "nccl" else {}  # NCCL's communicator on this rank's card
        dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), **bound)
    return device


def free_port() -> int:
    """A TCP port on localhost that is free now: ``MASTER_PORT`` for processes started on one host."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def close() -> None:
    """Leave the process group, where there is one: the end of a data-parallel entry point."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_group():
    """The group of every process when there is one, else None (one process)."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0, or the only process: the one that writes the run's files and logs."""
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


@contextlib.contextmanager
def data_parallel(group):
    """Inside the block, the computations above are the global batch's over ``group`` (a process group);
    with None, the block runs as one process."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def active() -> bool:
    """Whether a data-parallel group is active (``data_parallel``), even of one rank."""
    return _GROUP.get() is not None


def shard() -> tuple[int, int]:
    """(this rank's index, the number of ranks) in the active data-parallel group; (0, 1) outside one."""
    group = _GROUP.get()
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def mean_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the global batch's mean of x, for equal shares: mean(x) / ranks."""
    return torch.mean(x) / shard()[1]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active group's ranks, in place (no gradient); x itself outside a group."""
    group = _GROUP.get()
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group  # the backward may run on autograd's own thread, outside the context
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum_autograd(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active group's ranks, differentiable: every rank's loss reads the same sum, so
    the gradient reaching each rank's part is the sum of the ranks' gradients of it."""
    group = _GROUP.get()
    return x if group is None else _AllReduceSum.apply(x, group)


def batch_draw(draw, shape: tuple) -> torch.Tensor:
    """``draw(shape)`` for the rows of this rank: ``draw`` at the global batch's shape (dim 0 times the
    active group's ranks), then this rank's rows."""
    index, count = shard()
    b = shape[0]
    return draw((b * count,) + tuple(shape[1:]))[index * b : (index + 1) * b]


def coalesced(tensors: list[torch.Tensor], op) -> None:
    """``op`` on one flat buffer per dtype and device holding ``tensors``, copied back into them."""
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for group in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_grads(params) -> None:
    """Every parameter's gradient summed over the active group's ranks, through one flat buffer a dtype;
    nothing outside a group.  Each rank's loss is its share, so the sums are the global gradients."""
    group = _GROUP.get()
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        coalesced(grads, lambda flat: dist.all_reduce(flat, group=group))


def broadcast_modules(modules, group) -> None:
    """The parameters and buffers of ``modules`` set to those of the group's first rank, so that no rank
    starts from other weights than it (after a build from a seed, or a restore).  None: nothing."""
    if group is None:
        return
    src = dist.get_process_group_ranks(group)[0]
    with torch.no_grad():
        tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
        coalesced(tensors, lambda flat: dist.broadcast(flat, src=src, group=group))


def broadcast_flag(flag: bool, device: torch.device) -> bool:
    """Rank 0's ``flag`` on every rank (a decision only rank 0 can take, such as an early stop); doubles
    as a barrier.  ``device``: where this rank's backend takes tensors."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.broadcast(t, src=0)
    return bool(t.item())
