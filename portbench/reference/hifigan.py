"""Plain HiFiGAN, the SiLU variant of the multi-receptive-field generator (Kong et al. 2020).

``conv_pre``, then per upsample stage SiLU -> weight-normed transposed conv
(rate u, kernel k, padding (k - u) / 2) -> the mean of the stage's resblocks,
each of which runs, per dilation d, SiLU -> conv(k, d) -> SiLU -> conv(k) -> + x;
then SiLU, ``conv_post`` and tanh.  Each item is computed alone at its length.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.ops import Precision, get_padding, weight, wn_shapes


def _stages(cfg: dict):
    uic = cfg["upsample_initial_channel"]
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        yield i, u, k, uic // 2**i, uic // 2 ** (i + 1)


def shapes(cfg: dict) -> dict[str, tuple]:
    """The state dict's keys and shapes, in the reference's names."""
    uic = cfg["upsample_initial_channel"]
    out = wn_shapes("conv_pre", uic, (uic, cfg["num_mels"], cfg["pre_conv_kernel_size"]))
    for i, _, k, c_in, c in _stages(cfg):
        out.update(wn_shapes(f"ups.{i}", c, (c_in, c, k)))
    for i, _, _, _, c in _stages(cfg):
        for j, (kr, ds) in enumerate(zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"])):
            for n in (1, 2):
                for m in range(len(ds)):
                    out.update(wn_shapes(f"resblocks.{i}.blocks.{j}.convs{n}.{m}", c, (c, c, kr)))
    out.update(wn_shapes("conv_post", 1, (1, c, cfg["post_conv_kernel_size"])))
    return out


def init(cfg: dict, key: str) -> tuple[float, float]:
    """(mean, std) of the normal draw for parameter ``key``: directions standard normal; gains that keep
    the signal's scale (0.2 at conv_pre, sqrt(rate) at each upsample for the SiLU before it, 0.5 in the
    resblocks and at conv_post), each within 10%; small biases."""
    top = key.split(".")[0]
    if key.endswith("original1"):
        return 0.0, 1.0
    if key.endswith("original0"):
        gain = {"conv_pre": 0.2, "resblocks": 0.5, "conv_post": 0.5}.get(top, 1.0)
        if top == "ups":
            gain = cfg["upsample_rates"][int(key.split(".")[1])] ** 0.5
        return gain, 0.1 * gain
    return 0.0, 0.01


def forward(params: dict, mel: torch.Tensor, cfg: dict, prec: Precision, remat: bool = False) -> torch.Tensor:
    """mel (B, num_mels, F) -> waveform (B, 1, F * hop); ``remat`` is accepted for the common signature."""
    x = prec.conv1d(mel, weight(params, "conv_pre"), params["conv_pre.bias"],
                    padding=get_padding(cfg["pre_conv_kernel_size"]))
    for i, u, k, _, _ in _stages(cfg):
        x = prec.conv_transpose1d(F.silu(x), weight(params, f"ups.{i}"), params[f"ups.{i}.bias"], stride=u,
                                  padding=(k - u) // 2)
        total = 0.0
        for j, (kr, ds) in enumerate(zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"])):
            name = f"resblocks.{i}.blocks.{j}"
            h = x
            for m, d in enumerate(ds):
                t = prec.conv1d(F.silu(h), weight(params, f"{name}.convs1.{m}"), params[f"{name}.convs1.{m}.bias"],
                                padding=get_padding(kr, d), dilation=d)
                t = prec.conv1d(F.silu(t), weight(params, f"{name}.convs2.{m}"), params[f"{name}.convs2.{m}.bias"],
                                padding=get_padding(kr))
                h = h + t
            total = total + h
        x = total / len(cfg["resblock_kernel_sizes"])
    x = prec.conv1d(F.silu(x), weight(params, "conv_post"), params["conv_post.bias"],
                    padding=get_padding(cfg["post_conv_kernel_size"]))
    return torch.tanh(x)
