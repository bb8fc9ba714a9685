"""Counts of ``configs/vocos-huge-44k.json``: Vocos' convs and matmuls, and its ConvNeXt MLPs' bound.

By ``portbench/counts.py``'s rules: 2 x the multiply-adds of the stem conv, the stage transitions'
pointwise convs, every block's depthwise conv and two pointwise layers, and the head's projection, at the
items' own frames; LayerNorms, GELU, the layer scale, masks, the exp, cos and sin, the FFTs and the
overlap-add are left out.  No training step: no cell trains it.
"""


def _blocks(cfg: dict):
    """(C, hidden width) of every ConvNeXt block."""
    b = cfg["generator"]["backbone"]
    for c, depth in zip(b["dims"], b["depths"]):
        for _ in range(depth):
            yield c, int(b["mlp_ratio"] * c)


def forward_flops(cfg: dict, frames: int) -> float:
    b, head = cfg["generator"]["backbone"], cfg["generator"]["head"]
    dims, k = b["dims"], b["kernel_size"]
    macs = b["input_channels"] * dims[0] * k
    macs += sum(c_in * c for c_in, c in zip(dims[:-1], dims[1:]))
    macs += sum(c * k + 2 * c * h for c, h in _blocks(cfg))
    macs += head["dim"] * 2 * head["n_fft"]
    return 2.0 * macs * frames


def mlp_bound_s(cfg: dict, frames: int, peak_flops: float, bytes_per_s: float) -> float:
    """The least time of one forward's ConvNeXt MLPs (pwconv1 -> GELU -> pwconv2) over ``frames`` rows: the
    sum over blocks of max(FLOPs / peak, bytes / bandwidth), the FLOPs 2 x R x 2 C h, the bytes those of the
    fp32 input and output rows (R x C each), both weights (2 C h) and both biases (h + C), each counted once.
    The hidden (R, h) tensor is not counted, so that a fused MLP cannot read above 100%."""
    total = 0.0
    for c, h in _blocks(cfg):
        flops = 4.0 * frames * c * h
        nbytes = 4.0 * (2 * frames * c + 2 * c * h + h + c)
        total += max(flops / peak_flops, nbytes / bytes_per_s)
    return total
