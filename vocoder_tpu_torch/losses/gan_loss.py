"""LSGAN adversarial, feature-matching and discriminator losses.

Counterpart of ``vocoder_tpu/losses/gan_loss.py``, with the reference's
"score items" quirk: the MPD yields a list of per-period score tensors, the
MRD one (B, D) tensor of concatenated scores, which the reference's
``for score in scores`` loop iterates by rows.  So a list's items are its
tensors and a tensor's items are its rows, and each loss sums the items'
means: B times the overall mean for the MRD.  Inside
``parallel.dist.data_parallel`` each loss is this rank's share of the global
batch's: a mean over a tensor's whole batch divided by the ranks
(``dist.mean_share``), a sum over rows as it is.
"""

from __future__ import annotations

import torch

from vocoder_tpu_torch.parallel import dist


def _item_means(scores, fn) -> torch.Tensor:
    """sum over score items of mean(fn(item)): a list's tensors, or a (B, D) tensor's rows."""
    if isinstance(scores, (list, tuple)):
        return sum(dist.mean_share(fn(s)) for s in scores)
    return torch.mean(fn(scores), dim=1).sum()


def generator_adversarial_loss(score_fakes) -> torch.Tensor:
    return _item_means(score_fakes, lambda s: torch.square(1.0 - s))


def feature_matching_loss(feat_real, feat_fake) -> torch.Tensor:
    return sum(dist.mean_share(torch.abs(fr - ff))
               for frs, ffs in zip(feat_real, feat_fake) for fr, ff in zip(frs, ffs))


def discriminator_loss(score_reals, score_fakes) -> torch.Tensor:
    return (_item_means(score_reals, lambda s: torch.square(s - 1.0))
            + _item_means(score_fakes, torch.square))
