"""Anti-aliased Snake: the filters, the snake arithmetic and the plain version.

Counterpart of ``vocoder_tpu/ops/antialias.py``.  The reference wraps every
Snake activation in ``alias_free_torch``'s 2x Kaiser-sinc upsample -> snake ->
2x decimating low-pass.  Both FIRs edge-replicate their input, so the
composition has a closed form with clamped indices (x (B, C, T), f the
12-tap filter shared by up and down):

    y2[2v]   = 2 * sum_j f[11-2j] * x[clamp(v-3+j)]          (j < 6)
    y2[2v+1] = 2 * sum_j f[10-2j] * x[clamp(v-2+j)]
    z[t]     = sum_m f[m] * snake(y2[clamp(2t+m-5, 0, 2T-1)])   (m < 12)

``aa_snake_plain`` evaluates exactly that; it equals the JAX package's
polyphase interior plus its edge splice (``aa_snake_poly4``) at every
sample, and it is what the CUDA kernels (``csrc/aa_snake.cuh``) compute.
With per-item ``lengths`` (a right-padded batch) row b is that function of
``x[b, :, :L_b]`` alone, edge-replicated at its own end, then zeros: the
JAX package's ``aa_snake_poly4_masked``, which needs L_b >= 32, while this
one is exact at every length, 0 and 1 included.
Arithmetic is fp32 whatever the input dtype (fp64 for an fp64 input, for
``torch.autograd.gradcheck``); the result is cast back once.

``aa_snake_plain_vjp`` is the exact VJP of that function, edges included
(the clamped indices fold their gradients back onto the first and last
samples): the backward of K1 under autograd, in plain PyTorch.  It takes
x, alpha and beta only and recomputes the pre-activations, as the JAX
package's ``aa_snake_core_bwd`` does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """LPF design matching alias_free_torch.filter.kaiser_sinc_filter1d."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2

    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)

    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    f = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    f = f / f.sum()
    return f.astype(np.float32)


def upsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: int | None = None) -> torch.Tensor:
    """x: (B, C, T) -> (B, C, T*ratio); alias_free_torch.resample.UpSample1d."""
    c = x.shape[1]
    kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    pad = kernel_size // ratio - 1
    pad_left = pad * ratio + (kernel_size - ratio) // 2
    pad_right = pad * ratio + (kernel_size - ratio + 1) // 2
    filt = torch.as_tensor(kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, kernel_size), device=x.device, dtype=x.dtype)
    x = F.pad(x, (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(x, filt.view(1, 1, -1).expand(c, 1, -1), stride=ratio, groups=c)
    return y[..., pad_left : y.shape[-1] - pad_right]


def downsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: int | None = None) -> torch.Tensor:
    """x: (B, C, T) -> (B, C, T//ratio); alias_free_torch.resample.DownSample1d."""
    c = x.shape[1]
    kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    even = kernel_size % 2 == 0
    pad_left = kernel_size // 2 - int(even)
    pad_right = kernel_size // 2
    filt = torch.as_tensor(kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, kernel_size), device=x.device, dtype=x.dtype)
    x = F.pad(x, (pad_left, pad_right), mode="replicate")
    return F.conv1d(x, filt.view(1, 1, -1).expand(c, 1, -1), stride=ratio, groups=c)


@functools.lru_cache(maxsize=None)
def polyphase_taps():
    """(f_e, f_o, g_o, g_e): the ratio-2 Kaiser-sinc filter's polyphase taps.

    With f the 12-tap filter shared by up- and downsample at ratio 2:
        se[u] = snake(2 * sum_j x[u-5+j] * f_e[j])      f_e[j] = f[11-2j]
        so[u] = snake(2 * sum_j x[u-5+j] * f_o[j])      f_o[j] = f[10-2j]
        z[t]  = sum_a g_o[a]*se[t+a] + g_e[a]*so[t+a]   g_o[a]=f[2a+1], g_e[a]=f[2a]
    """
    f = kaiser_sinc_filter1d(0.25, 0.3, 12).astype(np.float64)
    f_e = np.asarray([f[11 - 2 * j] for j in range(6)])
    f_o = np.asarray([f[10 - 2 * j] for j in range(6)])
    g_o = np.asarray([f[2 * a_ + 1] for a_ in range(6)])
    g_e = np.asarray([f[2 * a_] for a_ in range(6)])
    return f_e, f_o, g_o, g_e


# sin^2 by a Cody-Waite range reduction and a polynomial, exactly as the JAX
# package evaluates it.  The snake argument |alpha*v| reaches tens to
# hundreds, where a single-constant reduction (or CUDA's __sinf) loses
# accuracy; this form stays within 6e-7 of libm over +-300.
_TWO_PI = 6.283185307179586
_INV_TWO_PI = 1.0 / _TWO_PI
_TP_HI = 6.28125
_TP_MID = 0.0019350051879882812
_TP_LO = 3.0199159795074593e-07
# cos(r) = sum_i c_i (r^2)^i on r in [-pi, pi]; |err| <= 3.6e-8.
_COS_COEF = (
    0.9999999922907286,
    -0.4999999177267109,
    0.04166652436474753,
    -0.0013887970410899468,
    2.4773424196945306e-05,
    -2.71133732450103e-07,
    1.7369133647437146e-09,
)
# sin(r) = r * sum_i s_i (r^2)^i on r in [-pi, pi]; |err| <= 7.7e-9.
_SIN_COEF = (
    0.9999999994768398,
    -0.16666666108562112,
    0.008333323685091395,
    -0.0001984064754254522,
    2.7538258044539417e-06,
    -2.4752169156660884e-08,
    1.3697464704976747e-10,
)


def sin_sq(w: torch.Tensor) -> torch.Tensor:
    """sin^2(w), elementwise, fp32."""
    u = 2.0 * w
    k = torch.round(u * _INV_TWO_PI)
    r = ((u - k * _TP_HI) - k * _TP_MID) - k * _TP_LO  # r in [-pi, pi]
    r2 = r * r
    cos = torch.full_like(r2, _COS_COEF[-1])
    for c_i in _COS_COEF[-2::-1]:
        cos = cos * r2 + c_i
    return 0.5 - 0.5 * cos


def fast_sin(w: torch.Tensor) -> torch.Tensor:
    """sin(w), elementwise, fp32 (odd polynomial after the same reduction)."""
    k = torch.round(w * _INV_TWO_PI)
    r = ((w - k * _TP_HI) - k * _TP_MID) - k * _TP_LO
    r2 = r * r
    s = torch.full_like(r2, _SIN_COEF[-1])
    for c_i in _SIN_COEF[-2::-1]:
        s = s * r2 + c_i
    return r * s


def snake(v: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """v + sin^2(alpha v) / (beta + 1e-9) on (B, C, T) in v's dtype; alpha/beta (C,) already exp'ed."""
    a = alpha.to(v.dtype)[:, None]
    inv_b = 1.0 / (beta.to(v.dtype)[:, None] + 1e-9)
    return v + inv_b * sin_sq(v * a)


def snake_params(alpha: torch.Tensor, beta: torch.Tensor | None, logscale: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw Snake/SnakeBeta parameters -> (alpha, beta) as the snake uses them, exp'ed in their own dtype:
    a bf16 parameter's exp is rounded to bf16, as the JAX package's ``jnp.exp`` of its bf16 parameters is
    and as K1 and K2 round it (``csrc/aa_snake.cuh::snake_params``), in training and in eval alike."""
    beta = alpha if beta is None else beta
    if logscale:
        return alpha.exp(), beta.exp()
    return alpha, beta


def item_lengths(lengths, b: int, t: int) -> list[int]:
    """Per-item lengths read back to the host and clamped to [0, t], as the kernels clamp them."""
    values = torch.as_tensor(lengths).reshape(-1).tolist()
    if len(values) != b:
        raise ValueError(f"lengths: expected {b} values, got {len(values)}")
    return [min(max(int(v), 0), t) for v in values]


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _upsampled(x: torch.Tensor) -> torch.Tensor:
    """y2 (B, C, 2T): the 2x upsampled x by the clamped polyphase form, in the compute dtype."""
    t = x.shape[-1]
    f_e, f_o, _, _ = (v.tolist() for v in polyphase_taps())
    xp = F.pad(x.to(_compute_dtype(x)), (6, 6), mode="replicate")  # xp[q] = x[clamp(q - 6)]
    even = sum(f_e[j] * xp[..., 3 + j : 3 + j + t] for j in range(6))  # y2[2v] / 2
    odd = sum(f_o[j] * xp[..., 4 + j : 4 + j + t] for j in range(6))  # y2[2v + 1] / 2
    return 2.0 * torch.stack([even, odd], dim=-1).flatten(-2)


def aa_snake_plain(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, lengths=None) -> torch.Tensor:
    """Anti-aliased snake on (B, C, T) by the clamped closed form above.

    alpha/beta are the (C,) fp32 parameters, already exp'ed under logscale.
    ``lengths`` (B,): each item alone over its first L_b samples, zeros after.
    """
    t = x.shape[-1]
    if lengths is not None:
        z = torch.zeros_like(x)
        for i, n in enumerate(item_lengths(lengths, x.shape[0], t)):
            if n:
                z[i, :, :n] = aa_snake_plain(x[i : i + 1, :, :n], alpha, beta)[0]
        return z
    _, _, g_o, g_e = (v.tolist() for v in polyphase_taps())
    y2 = _upsampled(x)
    s = F.pad(snake(y2, alpha, beta), (5, 6), mode="replicate")  # s[i] = snake(y2[clamp(i - 5)])
    # z[t] = sum_m f[m] s[2t + m], with f[2a] = g_e[a] and f[2a + 1] = g_o[a].
    z = sum(g_e[a] * s[..., 2 * a : 2 * a + 2 * t : 2] + g_o[a] * s[..., 2 * a + 1 : 2 * a + 1 + 2 * t : 2]
            for a in range(6))
    return z.to(x.dtype)


def aa_snake_plain_vjp(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, gz: torch.Tensor):
    """(dx, d alpha, d beta) of ``aa_snake_plain(x, alpha, beta)`` for the upstream gradient gz.

    alpha/beta are the (C,) parameters as the snake uses them (already exp'ed);
    the chain rule through ``exp`` stays with the caller's autograd.  With
    s = snake(v) = v + sin^2(a v) / (b + 1e-9):
        ds/dv = 1 + a sin(2 a v) / (b + 1e-9),   ds/da = v sin(2 a v) / (b + 1e-9),
        ds/db = -sin^2(a v) / (b + 1e-9)^2,
    and each FIR's adjoint is the correlation with its taps reversed.  Every
    clamped index adds its gradient to the sample it copies: the snake outputs
    past either end of y2 to y2[0] and y2[2T - 1], the x samples past either end
    to x[0] and x[T - 1] (the JAX package's ``dx.at[:, 0]`` and ``[:, t - 1]`` adds).
    """
    b, c, t = x.shape
    f_e, f_o, g_o, g_e = (v.tolist() for v in polyphase_taps())
    y2 = _upsampled(x)
    cdt = y2.dtype
    # z[t] = sum_a g_e[a] s[2t + 2a] + g_o[a] s[2t + 2a + 1]  ->  ds over s's 2T + 11 samples.
    gzp = F.pad(gz.to(cdt), (5, 6))  # gzp[q] = gz[q - 5], zero outside
    ds_e = sum(g_e[a] * gzp[..., 5 - a : 11 - a + t] for a in range(6))  # ds[2u], u < T + 6
    ds_o = sum(g_o[a] * gzp[..., 5 - a : 10 - a + t] for a in range(6))  # ds[2u + 1], u < T + 5
    ds = torch.cat([torch.stack([ds_e[..., : t + 5], ds_o], dim=-1).flatten(-2), ds_e[..., t + 5 :]], dim=-1)
    dv = ds[..., 5 : 2 * t + 5].clone()  # s[i] = snake(y2[clamp(i - 5, 0, 2T - 1)])
    dv[..., 0] += ds[..., :5].sum(-1)
    dv[..., -1] += ds[..., 2 * t + 5 :].sum(-1)

    a = alpha.to(cdt)[:, None]
    inv_b = 1.0 / (beta.to(cdt)[:, None] + 1e-9)
    s2 = fast_sin(2.0 * a * y2)
    d_alpha = inv_b[:, 0] * (dv * y2 * s2).sum(dim=(0, 2))
    d_beta = -(inv_b[:, 0] ** 2) * (dv * sin_sq(a * y2)).sum(dim=(0, 2))
    dy2 = (dv * (1.0 + a * inv_b * s2)).unflatten(-1, (t, 2))

    # y2[2v] = 2 sum_j f_e[j] xp[v + 3 + j], y2[2v + 1] = 2 sum_j f_o[j] xp[v + 4 + j].
    d_even, d_odd = 2.0 * dy2[..., 0], 2.0 * dy2[..., 1]
    dxp = torch.zeros(b, c, t + 12, dtype=cdt, device=x.device)
    for j in range(6):
        dxp[..., 3 + j : 3 + j + t] += f_e[j] * d_even
        dxp[..., 4 + j : 4 + j + t] += f_o[j] * d_odd
    dx = dxp[..., 6 : t + 6].clone()  # xp[q] = x[clamp(q - 6, 0, T - 1)]
    dx[..., 0] += dxp[..., :6].sum(-1)
    dx[..., -1] += dxp[..., t + 6 :].sum(-1)
    return dx.to(x.dtype), d_alpha.to(alpha.dtype), d_beta.to(beta.dtype)
