"""Plain BigVGAN (Lee et al. 2023, "BigVGAN: A Universal Neural Vocoder with Large-Scale Training").

A log-mel goes through ``conv_pre``, then per upsample stage a weight-normed
transposed conv (rate u, kernel k, padding (k - u) / 2) and the mean of the
stage's AMP resblocks.  A resblock of kernel k and dilations ds runs, per d,
anti-aliased Snake -> conv(k, d) -> anti-aliased Snake -> conv(k) -> + x.  Then
a post anti-aliased SnakeBeta (log-scale parameters), ``conv_post`` and tanh.
Snake parameters are stored in log scale where ``snake_logscale`` says so
(``alpha = exp(param)``).  Each item is computed alone at its own length: a
padded batch of items is the program's business, not the reference's.
"""

from __future__ import annotations

import torch

from portbench.reference.ops import Precision, aa_snake, get_padding, weight, wn_shapes


def _stages(cfg: dict):
    uic = cfg["upsample_initial_channel"]
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        yield i, u, k, uic // 2**i, uic // 2 ** (i + 1)


def shapes(cfg: dict) -> dict[str, tuple]:
    """The state dict's keys and shapes, in the reference's names."""
    out = wn_shapes("conv_pre", cfg["upsample_initial_channel"],
                    (cfg["upsample_initial_channel"], cfg["num_mels"], cfg["pre_conv_kernel_size"]))
    n_k = len(cfg["resblock_kernel_sizes"])
    for i, _, k, c_in, c in _stages(cfg):
        out.update(wn_shapes(f"ups.{i}", c, (c_in, c, k)))
    for i, _, _, _, c in _stages(cfg):
        for j, (kr, ds) in enumerate(zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"])):
            name = f"resblocks.{i * n_k + j}"
            for n in (1, 2):
                for m in range(len(ds)):
                    out.update(wn_shapes(f"{name}.convs{n}.{m}", c, (c, c, kr)))
            for a in range(2 * len(ds)):
                out[f"{name}.activations.{a}.activation.alpha"] = (c,)
                if cfg["activation"] == "snakebeta":
                    out[f"{name}.activations.{a}.activation.beta"] = (c,)
    out["activation_post.activation.alpha"] = (c,)
    if cfg["activation"] == "snakebeta":
        out["activation_post.activation.beta"] = (c,)
    out.update(wn_shapes("conv_post", 1, (1, c, cfg["post_conv_kernel_size"])))
    return out


def init(cfg: dict, key: str) -> tuple[float, float]:
    """(mean, std) of the normal draw for parameter ``key``: directions standard normal; gains near
    the value that keeps the signal's scale (0.2 at conv_pre for a log-mel's offset of about -5,
    sqrt(rate / 2) at each upsample for the halved channels, 0.5 in the resblocks to keep the residual
    branches below the skip path, 0.25 at conv_post to keep tanh off its rails), each within 10%;
    small biases; Snake parameters near their init (0 in log scale, 1 in linear)."""
    top = key.split(".")[0]
    if key.endswith("original1"):
        return 0.0, 1.0
    if key.endswith("original0"):
        gain = {"conv_pre": 0.2, "resblocks": 0.5, "conv_post": 0.25}.get(top, 1.0)
        if top == "ups":
            gain = (cfg["upsample_rates"][int(key.split(".")[1])] / 2) ** 0.5
        return gain, 0.1 * gain
    if key.endswith("bias"):
        return 0.0, 0.01
    logscale = cfg["snake_logscale"] or top == "activation_post"
    return (0.0 if logscale else 1.0), 0.1


def _snake_params(params: dict, prefix: str, logscale: bool):
    alpha = params[f"{prefix}.activation.alpha"]
    beta = params.get(f"{prefix}.activation.beta", alpha)
    return (alpha.exp(), beta.exp()) if logscale else (alpha, beta)


def forward(params: dict, mel: torch.Tensor, cfg: dict, prec: Precision, remat: bool = False) -> torch.Tensor:
    """mel (B, num_mels, F) -> waveform (B, 1, F * hop).  ``remat``: each anti-aliased Snake recomputed
    in the backward (memory only; the function is the same)."""
    n_k = len(cfg["resblock_kernel_sizes"])
    log = cfg["snake_logscale"]

    def act(x, prefix, logscale=log):
        return aa_snake(x, *_snake_params(params, prefix, logscale), remat=remat)

    x = prec.conv1d(mel, weight(params, "conv_pre"), params["conv_pre.bias"],
                    padding=get_padding(cfg["pre_conv_kernel_size"]))
    for i, u, k, _, _ in _stages(cfg):
        x = prec.conv_transpose1d(x, weight(params, f"ups.{i}"), params[f"ups.{i}.bias"], stride=u,
                                  padding=(k - u) // 2)
        total = 0.0
        for j, (kr, ds) in enumerate(zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"])):
            name = f"resblocks.{i * n_k + j}"
            h = x
            for m, d in enumerate(ds):
                t = prec.conv1d(act(h, f"{name}.activations.{2 * m}"), weight(params, f"{name}.convs1.{m}"),
                                params[f"{name}.convs1.{m}.bias"], padding=get_padding(kr, d), dilation=d)
                t = prec.conv1d(act(t, f"{name}.activations.{2 * m + 1}"), weight(params, f"{name}.convs2.{m}"),
                                params[f"{name}.convs2.{m}.bias"], padding=get_padding(kr))
                h = h + t
            total = total + h
        x = total / n_k
    x = act(x, "activation_post", logscale=True)
    x = prec.conv1d(x, weight(params, "conv_post"), params["conv_post.bias"],
                    padding=get_padding(cfg["post_conv_kernel_size"]))
    return torch.tanh(x)
