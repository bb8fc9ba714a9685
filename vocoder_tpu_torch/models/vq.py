"""Vector quantisation with EMA codebooks (encodec-style), as a ``torch.nn.Module``.

Counterpart of ``vocoder_tpu/models/vq.py``: ``num_quantizers`` codebooks
in a residual stack, each coding what the ones before it left.  A codebook's
``embed`` (K, D), ``embed_avg`` (K, D) and ``cluster_size`` (K,) are
registered buffers: they ride in ``state_dict()`` and in checkpoints, and no
optimizer sees them.  They learn by an exponential moving average of the
frames assigned to each code, never by gradient.

``forward`` (B, D, T) -> (quantized (B, D, T), codes (Q, B, T), loss): the
nearest code of each frame by the distance |x|^2 - 2 x.E^T + |E|^2, written
as the JAX package writes it (``torch.cdist`` orders its sums otherwise);
the straight-through estimator (the gradient reaches the input as if
quantisation were the identity); and the commitment loss, the mean over the
quantisers of mean((q - residual)^2) with q detached.  The distance product
runs in full fp32 whatever the TF32 flags say: rounded to TF32 (about three
decimal digits) it picks another code wherever two distances lie within its
rounding, and the codec's codes would then depend on the flags.

``ema_update(x, codes)`` is the EMA step of a training forward, apart: from
the step's input and codes it computes every codebook's new buffers against
the codebooks the forward used, then writes them.  A trainer calls it after
the generator's backward, as the JAX step writes its new state at the end
(``vocoder_tpu/train/gan.py``), so no buffer that autograd saved changes
before the backward reads it.  ``from_codes`` is the codec's decode path.
Inside ``parallel.dist.data_parallel`` the commitment loss is this rank's
share of the global batch's and the EMA step sums each codebook's counts
and frame sums over the ranks first, so every rank writes the global
batch's codebooks.  Under a model group the training state stores ``embed``
and ``embed_avg`` in storage shards (``state_buffers``; ``parallel/tp.py``):
the forward reads the whole codebooks that the generator's call gathers, and
the trainer runs ``ema_update`` inside ``tp.gathered``, so the update is
computed whole on every rank and each rank keeps its slice.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vocoder_tpu_torch.parallel import dist


@dataclasses.dataclass(frozen=True)
class VQConfig:
    dim: int
    codebook_size: int
    num_quantizers: int = 1
    decay: float = 0.99
    eps: float = 1e-5
    commitment_weight: float = 1.0


@contextlib.contextmanager
def full_fp32_matmul():
    """cuBLAS fp32 matmuls in full fp32 inside the block (TF32 off), the flag restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def distances(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """(N, D) frames, (K, D) codes -> (N, K) squared distances |x|^2 - 2 x.E^T + |E|^2, in full fp32."""
    with full_fp32_matmul():
        cross = x @ embed.T
    return x.square().sum(1, keepdim=True) - 2.0 * cross + embed.square().sum(1)[None, :]


class Codebook(nn.Module):
    state_buffers = ("embed", "embed_avg", "cluster_size")  # the JAX package's TrainState.extra (tp_specs.storage_dims)

    def __init__(self, cfg: VQConfig, device=None):
        super().__init__()
        embed = torch.randn(cfg.codebook_size, cfg.dim, device=device)  # uniform random init, no k-means
        self.register_buffer("embed", embed)
        self.register_buffer("embed_avg", embed.clone())
        self.register_buffer("cluster_size", torch.zeros(cfg.codebook_size, device=device))


class VectorQuantizer(nn.Module):
    def __init__(self, cfg: VQConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList([Codebook(cfg, device) for _ in range(cfg.num_quantizers)])

    @staticmethod
    def _flat(x: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2).reshape(-1, x.shape[1])

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b, d, t = x.shape
        residual = self._flat(x)
        total = torch.zeros_like(residual)
        codes, losses = [], []
        for layer in self.layers:
            with torch.no_grad():
                c = torch.argmin(distances(residual.detach(), layer.embed), dim=1)
            q = layer.embed[c]
            losses.append(dist.mean_share(torch.square(q - residual)) * self.cfg.commitment_weight)
            total = total + (residual + (q - residual).detach())  # straight-through
            residual = residual - q
            codes.append(c)
        quantized = total.reshape(b, t, d).transpose(1, 2)
        return quantized, torch.stack(codes).reshape(len(codes), b, t), torch.stack(losses).mean()

    @torch.no_grad()
    def ema_update(self, x: torch.Tensor, codes: torch.Tensor) -> None:
        """One EMA step from a training forward's input x (B, D, T) and its codes (Q, B, T)."""
        cfg = self.cfg
        residual = self._flat(x.detach())
        sums = []  # each codebook's (frames a code, frame sums a code) of this rank's batch
        for layer, c in zip(self.layers, codes.reshape(len(self.layers), -1)):
            onehot = F.one_hot(c, cfg.codebook_size).to(residual.dtype)
            with full_fp32_matmul():
                sums.append((onehot.sum(0), onehot.T @ residual))
            residual = residual - layer.embed[c]
        flat = dist.all_reduce_sum(torch.cat([t.reshape(-1) for pair in sums for t in pair]))  # the global batch's
        k = cfg.codebook_size
        sums = [(f[:k], f[k:].view(k, -1)) for f in flat.view(len(sums), -1)]
        new = []
        for layer, (counts, embed_sums) in zip(self.layers, sums):
            cluster_size = layer.cluster_size * cfg.decay + counts * (1 - cfg.decay)
            embed_avg = layer.embed_avg * cfg.decay + embed_sums * (1 - cfg.decay)
            n = cluster_size.sum()
            smoothed = (cluster_size + cfg.eps) / (n + cfg.codebook_size * cfg.eps) * n
            new.append((embed_avg / smoothed[:, None], embed_avg, cluster_size))
        for layer, (embed, embed_avg, cluster_size) in zip(self.layers, new):
            layer.embed.copy_(embed)
            layer.embed_avg.copy_(embed_avg)
            layer.cluster_size.copy_(cluster_size)

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (Q', B, T), Q' <= num_quantizers -> the latent (B, D, T): the sum of the codes' vectors."""
        total = sum(layer.embed[c] for layer, c in zip(self.layers, codes))
        return total.transpose(1, 2)
