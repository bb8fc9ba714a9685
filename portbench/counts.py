"""Operation and byte counts of the algorithm, the same whatever implements it.

FLOPs are 2 x the multiply-adds of every convolution and transposed
convolution of the algorithm at the shapes the inputs need: a transposed conv
costs c_in * c_out * k per input sample, a conv c_in * c_out * k per output
position.  BigVGAN's anti-aliased activation counts as the depthwise convs it
is: the 2x upsampling FIR (12 taps, transposed, 12 multiply-adds per input
sample and channel) and the decimating one (12 per output sample and
channel), 24 per sample and channel in all.  Elementwise operations (the
Snake, SiLU, tanh, residual adds, masks), the FFTs of the spectra and the mel
filterbank's projection are left out.  Only each item's own frames count: the
padding of a batch is not work its inputs need.

A training step counts, from the dataflow of the port's ``train/gan.py`` at
the commit that added this benchmark: the generator's forward, backpropagated
to its weights and inputs, 3x; the discriminators on the fake crop in the
generator phase with their weights held, so backpropagated to the input
only, 2x; on the real crop there, without gradient, 1x; on the real crop in
the discriminator phase, backpropagated to the weights only, 2x; on the
detached fake crop there, 2x.  So 3 G + 7 D a step.  A later change that
removes redundant work does not lower the count.
"""

from __future__ import annotations

from portbench.reference.gan import MRD_CHANNELS, MRD_LAYERS

FIR_MACS = 24  # per sample and channel of one anti-aliased activation


def _stages(gen: dict):
    uic = gen["upsample_initial_channel"]
    for i, (u, k) in enumerate(zip(gen["upsample_rates"], gen["upsample_kernel_sizes"])):
        yield u, k, uic // 2**i, uic // 2 ** (i + 1)


def stage_convs(gen: dict, c: int) -> list[int]:
    """Kernel sizes of the convs of one stage of width c (two a dilation of each resblock)."""
    pairs = zip(gen["resblock_kernel_sizes"], gen["resblock_dilation_sizes"])
    return [kr for kr, ds in pairs for _ in range(2 * len(ds))]


def upsampler_stage_macs(gen: dict, frames: int, aa: bool) -> list[dict]:
    """Per upsample stage: {"c", "t" (samples at the stage's rate), "up" (the transposed conv's MACs),
    "convs" (the resblock convs' MACs), "fir" (the anti-aliased activations' MACs, 0 without ``aa``)}."""
    out, t = [], frames
    for u, k, c_in, c in _stages(gen):
        up = c_in * c * k * t
        t *= u
        kernels = stage_convs(gen, c)
        out.append({"c": c, "t": t, "up": up, "convs": sum(c * c * kr * t for kr in kernels),
                    "fir": FIR_MACS * c * t * len(kernels) if aa else 0, "kernels": kernels})
    return out


def upsampler_forward_flops(gen: dict, frames: int, aa: bool) -> float:
    """FLOPs of one forward of a HiFiGAN-skeleton generator over ``frames`` mel frames; ``aa``: BigVGAN's
    anti-aliased activations (each conv's input, and the post activation)."""
    stages = upsampler_stage_macs(gen, frames, aa)
    last = stages[-1]
    macs = gen["num_mels"] * gen["upsample_initial_channel"] * gen["pre_conv_kernel_size"] * frames
    macs += sum(s["up"] + s["convs"] + s["fir"] for s in stages)
    macs += (FIR_MACS * last["c"] * last["t"] if aa else 0) + last["c"] * gen["post_conv_kernel_size"] * last["t"]
    return 2.0 * macs


def amp_stage_bound_s(gen: dict, frames: int, peak_flops: float, bytes_per_s: float) -> float:
    """The least time of one forward's AMP stages: the sum over stages of max(the stage's FLOPs (its convs
    and activations) / peak, bytes / bandwidth), the bytes being its input and output activations (fp32,
    the items' own frames) and its weights (convs, biases, Snake alpha and beta), each counted once."""
    total = 0.0
    for s in upsampler_stage_macs(gen, frames, aa=True):
        c, t = s["c"], s["t"]
        flops = 2.0 * (s["convs"] + s["fir"])
        weights = sum(c * c * kr + c for kr in s["kernels"]) + 2 * c * len(s["kernels"])
        nbytes = 4.0 * (2 * c * t + weights)
        total += max(flops / peak_flops, nbytes / bytes_per_s)
    return total


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def mpd_macs(train: dict, batch: int, samples: int) -> int:
    mpd = train["mpd"]
    k, stride, chs = mpd["kernel_size"], mpd["stride"], mpd["channels"]
    total = 0
    for p in mpd["periods"]:
        h = -(-samples // p)
        for c_in, c_out in zip(chs[:-1], chs[1:]):
            h = _conv_out(h, k, stride, k // 2)
            total += batch * p * h * c_out * c_in * k
        total += batch * p * h * chs[-1] * 3
    return total


def mrd_macs(train: dict, batch: int, samples: int) -> int:
    total = 0
    for n_fft, hop, _ in train["mrd_resolutions"]:
        f = n_fft // 2 + 1
        w = (samples + (n_fft - hop) - n_fft) // hop + 1
        for ((kh, kw), (sh, sw), (ph, pw)), c_in, c_out in zip(MRD_LAYERS, MRD_CHANNELS[:-1], MRD_CHANNELS[1:]):
            f, w = _conv_out(f, kh, sh, ph), _conv_out(w, kw, sw, pw)
            total += batch * f * w * c_out * c_in * kh * kw
        total += batch * f * w * MRD_CHANNELS[-1] * 9
    return total


def gan_step_flops(cfg: dict, forward_flops, batch: int, frames: int) -> float:
    """FLOPs of one training step (3 G + 7 D, see above) on ``batch`` clips of ``frames`` mel frames."""
    train = cfg["train"]
    g = forward_flops(cfg, batch * frames)
    d = 2.0 * (mpd_macs(train, batch, train["crop_length"]) + mrd_macs(train, batch, train["crop_length"]))
    return 3.0 * g + 7.0 * d
