"""Plain Vocos (Siuzdak 2023, arXiv:2306.00814): a 1-D ConvNeXt backbone and an inverse-STFT head.

The equations are the paper's and those of the upstream modules (fishaudio/vocoder's ConvNeXtEncoder and
ISTFTHead; the ConvNeXt block of Liu et al. 2022), with LayerNorm's eps 1e-6 throughout:

- the stem: conv (kernel k, "same" padding) -> LayerNorm over channels;
- stage i > 0 begins with LayerNorm -> pointwise conv (dims[i - 1] -> dims[i]);
- a block: depthwise conv (kernel k, "same") -> LayerNorm -> pointwise (C -> mlp_ratio C) -> exact (erf)
  GELU -> pointwise (mlp_ratio C -> C) -> times the layer scale gamma -> + the block's input;
- a final LayerNorm;
- the head: pointwise (dim -> 2 n_fft); channels [0, n_fft / 2] are log-magnitudes, exponentiated and
  clipped at 1e2, channels [n_fft, 3 n_fft / 2] phases; S = mag (cos p + i sin p); then the "same" iSTFT:
  the inverse real DFT of each frame's n_fft bins, times the periodic Hann window, overlap-added at the hop
  (``F.fold``, as upstream), divided by the overlap-added squared window, with (win - hop) / 2 samples
  trimmed at each end, so F frames give F x hop samples.

Each item is computed alone at its own length: no mask, no batching.  Every conv, the pointwise layers and
the depthwise one included, goes through ``prec.conv1d`` (the pointwise layers as kernel-1 convs), so the
TF32 control rounds them as well.

Departures from upstream, none of which changes what the model computes: the pointwise layers' weights
keep a Linear's (out, in) layout (upstream's ``nn.Linear``; the reference state dict's keys and shapes) and
run as kernel-1 convs; the imaginary parts of the DC and Nyquist bins are zeroed before the inverse real
DFT, whose definition gives them no part (a library's complex-to-real transform need not ignore them);
drop path, a training-time draw, is left out; weights are random, drawn by ``init``'s recipe.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.ops import Precision, hann

LN_EPS = 1e-6
MAG_CLIP = 1e2


def _hidden(backbone: dict, c: int) -> int:
    return int(backbone["mlp_ratio"] * c)


def shapes(gen: dict) -> dict[str, tuple]:
    """The state dict's keys and shapes, in the reference's names (``backbone.*``, ``head.out``)."""
    b, head = gen["backbone"], gen["head"]
    dims, k = b["dims"], b["kernel_size"]
    out = {"backbone.downsample_layers.0.0.weight": (dims[0], b["input_channels"], k),
           "backbone.downsample_layers.0.0.bias": (dims[0],),
           "backbone.downsample_layers.0.1.weight": (dims[0],), "backbone.downsample_layers.0.1.bias": (dims[0],)}
    for i in range(1, len(dims)):
        p = f"backbone.downsample_layers.{i}"
        out.update({f"{p}.0.weight": (dims[i - 1],), f"{p}.0.bias": (dims[i - 1],),
                    f"{p}.1.weight": (dims[i], dims[i - 1], 1), f"{p}.1.bias": (dims[i],)})
    for i, (c, depth) in enumerate(zip(dims, b["depths"])):
        h = _hidden(b, c)
        for j in range(depth):
            p = f"backbone.stages.{i}.{j}"
            out.update({f"{p}.dwconv.weight": (c, 1, k), f"{p}.dwconv.bias": (c,),
                        f"{p}.norm.weight": (c,), f"{p}.norm.bias": (c,),
                        f"{p}.pwconv1.weight": (h, c), f"{p}.pwconv1.bias": (h,),
                        f"{p}.pwconv2.weight": (c, h), f"{p}.pwconv2.bias": (c,), f"{p}.gamma": (c,)})
    out.update({"backbone.norm.weight": (dims[-1],), "backbone.norm.bias": (dims[-1],),
                "head.out.weight": (2 * head["n_fft"], head["dim"], 1), "head.out.bias": (2 * head["n_fft"],)})
    return out


def init(gen: dict, key: str) -> tuple[float, float]:
    """(mean, std) of the normal draw for parameter ``key``: conv and linear weights of variance 1 / fan-in,
    so each layer keeps its input's scale; the head's projection at 0.5 / sqrt(dim), so the log-magnitudes
    of the unit-scale features stay under log(100) but for a few in a million; layer scales 0.1 (within
    10%), so that every block adds to its residual (upstream's 1e-6 init would leave the blocks silent);
    LayerNorm gains 1 and biases small."""
    name = key.rsplit(".", 1)[-1]
    if key == "head.out.weight":
        return 0.0, 0.5 / gen["head"]["dim"] ** 0.5
    if name == "gamma":
        return 0.1, 0.01
    shape = shapes(gen)[key]
    if len(shape) > 1:
        fan_in = 1
        for n in shape[1:]:
            fan_in *= n
        return 0.0, fan_in ** -0.5
    if name == "weight":  # a LayerNorm's gain
        return 1.0, 0.1
    return 0.0, 0.05


def _layer_norm(params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm of (B, C, T) x over its channels."""
    y = F.layer_norm(x.transpose(1, 2), (x.shape[1],), params[f"{name}.weight"], params[f"{name}.bias"], LN_EPS)
    return y.transpose(1, 2)


def _pointwise(params: dict, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    w = params[f"{name}.weight"]
    return prec.conv1d(x, w if w.dim() == 3 else w[:, :, None], params[f"{name}.bias"])


def backbone(params: dict, mel: torch.Tensor, b: dict, prec: Precision) -> torch.Tensor:
    """mel (B, num_mels, F) -> features (B, dims[-1], F)."""
    k = b["kernel_size"]
    stem = "backbone.downsample_layers.0.0"
    x = prec.conv1d(mel, params[f"{stem}.weight"], params[f"{stem}.bias"], padding=k // 2)
    x = _layer_norm(params, "backbone.downsample_layers.0.1", x)
    for i, (c, depth) in enumerate(zip(b["dims"], b["depths"])):
        if i > 0:
            x = _layer_norm(params, f"backbone.downsample_layers.{i}.0", x)
            x = _pointwise(params, f"backbone.downsample_layers.{i}.1", x, prec)
        for j in range(depth):
            p = f"backbone.stages.{i}.{j}"
            y = prec.conv1d(x, params[f"{p}.dwconv.weight"], params[f"{p}.dwconv.bias"],
                            padding=b["dilation"] * (k - 1) // 2, dilation=b["dilation"], groups=c)
            y = _layer_norm(params, f"{p}.norm", y)
            y = _pointwise(params, f"{p}.pwconv2", F.gelu(_pointwise(params, f"{p}.pwconv1", y, prec)), prec)
            x = x + params[f"{p}.gamma"][None, :, None] * y
    return _layer_norm(params, "backbone.norm", x)


def istft_same(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """(B, n_fft / 2 + 1, F) real and imaginary parts -> (B, F x hop) audio, the "same" iSTFT above."""
    if win != n_fft:
        raise ValueError("the 'same' iSTFT here takes win_length == n_fft")
    im = torch.cat([torch.zeros_like(im[:, :1]), im[:, 1:-1], torch.zeros_like(im[:, -1:])], dim=1)
    f = re.shape[-1]
    window = torch.tensor(hann(win), dtype=torch.float32, device=re.device)
    frames = torch.fft.irfft(torch.complex(re, im), n=n_fft, dim=1) * window[None, :, None]  # (B, n_fft, F)
    size = (f - 1) * hop + win
    y = F.fold(frames, output_size=(1, size), kernel_size=(1, win), stride=(1, hop))[:, 0, 0]
    envelope = F.fold((window * window)[None, :, None].expand(1, win, f), output_size=(1, size),
                      kernel_size=(1, win), stride=(1, hop))[0, 0, 0]
    pad = (win - hop) // 2
    return y[:, pad:size - pad] / envelope[pad:size - pad]


def forward(params: dict, mel: torch.Tensor, gen: dict, prec: Precision, remat: bool = False) -> torch.Tensor:
    """mel (B, num_mels, F) -> waveform (B, 1, F x hop); ``remat`` is accepted for the common signature."""
    head = gen["head"]
    n_fft, bins = head["n_fft"], head["n_fft"] // 2 + 1
    x = _pointwise(params, "head.out", backbone(params, mel, gen["backbone"], prec), prec)  # (B, 2 n_fft, F)
    mag = torch.clamp(torch.exp(x[:, :bins]), max=MAG_CLIP)
    phase = x[:, n_fft:n_fft + bins]
    audio = istft_same(mag * torch.cos(phase), mag * torch.sin(phase), n_fft, head["hop_length"], head["win_length"])
    return audio[:, None, :]
