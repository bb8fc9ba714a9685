"""The port's plain kernels and front end against the JAX package, on the CPU.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as the JAX package's own tests run them) and through the
port with CPU tensors, which take the plain PyTorch versions.  Layouts: JAX
is (B, T, C), the port (B, C, T); the tests transpose at that boundary.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu.models import bigvgan as jbigvgan
from vocoder_tpu.ops import antialias as jaa
from vocoder_tpu.ops import spectral as jspectral
from vocoder_tpu.ops.pallas import amp_block as jamp
from vocoder_tpu.ops.pallas.aa_snake import fused_aa_snake
from vocoder_tpu_torch import ops
from vocoder_tpu_torch.convert import amp_block_state_dict_from_jax
from vocoder_tpu_torch.models.bigvgan import AMPBlock, BigVGANConfig
from vocoder_tpu_torch.nn import fold_weight_norm
from vocoder_tpu_torch.ops import antialias as taa
from vocoder_tpu_torch.ops import build
from vocoder_tpu_torch.ops.aa_snake import AASnakeFunction, aa_snake, aa_snake_bwd_kernel
from vocoder_tpu_torch.ops import amp_block
from vocoder_tpu_torch.ops.amp_block import amp_stage, amp_stage_plain, pack_conv_weight
from vocoder_tpu_torch.ops.linear_3xtf32 import tf32_split as k3_split
from vocoder_tpu_torch.ops.spectral import log_mel_spectrogram, mel_filterbank
from vocoder_tpu_torch.tools import k1_variants, k2_phases, timing


def _to_port(x: np.ndarray) -> torch.Tensor:  # (B, T, C) -> (B, C, T)
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def _from_port(x: torch.Tensor) -> np.ndarray:
    return x.detach().numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("logscale", [False, True])
@pytest.mark.parametrize("t,c", [(128, 16), (256, 32), (64, 128), (40, 4)])
def test_aa_snake_plain_matches_pallas_and_poly4(t, c, logscale):
    """Shapes from tests/test_pallas_aa_snake.py (lane folds 8, 4 and 1) plus a T < 64 at fold 32;
    each new shape costs the Pallas interpreter a ~2 s compile."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    alpha = (rng.standard_normal(c) * 0.3).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.3).astype(np.float32)
    xj, aj, bj = jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta)

    got = _from_port(aa_snake(_to_port(x), torch.from_numpy(alpha), torch.from_numpy(beta), logscale))
    pallas = np.asarray(fused_aa_snake(xj, aj, bj, logscale, interpret=True))
    poly4 = np.asarray(jaa.aa_snake_poly4(xj, aj, bj, logscale))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, poly4, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [1, 7, 300])
def test_closed_form_equals_composition(t):
    """The clamped closed form is the reference's up -> snake -> down, edges included."""
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((2, 5, t)).astype(np.float32))
    a, b = taa.snake_params(torch.from_numpy(rng.standard_normal(5).astype(np.float32) * 0.3),
                            torch.from_numpy(rng.standard_normal(5).astype(np.float32) * 0.3), True)
    want = taa.downsample1d(taa.snake(taa.upsample1d(x), a, b))
    torch.testing.assert_close(taa.aa_snake_plain(x, a, b), want, rtol=1e-5, atol=1e-5)


def test_poly_sin_accuracy():
    """The range-reduced polynomials stay within 6e-7 of libm over +-300 (tests/test_amp_fused.py)."""
    w = torch.linspace(-300.0, 300.0, 400001)
    w64 = w.double().numpy()
    np.testing.assert_allclose(taa.sin_sq(w).numpy(), np.sin(w64) ** 2, atol=6e-7)
    np.testing.assert_allclose(taa.fast_sin(w).numpy(), np.sin(w64), atol=6e-7)


def test_cuda_header_constants_match_python():
    """csrc/aa_snake.cuh hard-codes the FIR taps (and, for its FMA arithmetic, the
    doubled taps and 2 pi split in two floats) and the sin polynomial: they
    must be the Python ones."""
    src = (Path(__file__).resolve().parents[1] / "vocoder_tpu_torch" / "csrc" / "aa_snake.cuh").read_text()
    taps = re.search(r"kFilt\[12\] = \{([^}]*)\}", src).group(1)
    got = np.asarray([float(v.strip().rstrip("f")) for v in taps.split(",")], np.float32)
    np.testing.assert_array_equal(got, taa.kaiser_sinc_filter1d(0.25, 0.3, 12))
    doubled = re.search(r"kFilt2\[12\] = \{([^}]*)\}", src).group(1)
    assert [v.strip() for v in doubled.split(",")] == [f"2 * {v.strip()}" for v in taps.split(",")]
    two_pi = {name: np.float32(float(v.rstrip("f"))) for name, v in re.findall(r"(kTwoPi\w+) = ([-\d.e]+f)", src)}
    assert two_pi["kTwoPiHi"] == np.float32(2 * np.pi)
    assert two_pi["kTwoPiLo"] == np.float32(2 * np.pi - np.float64(np.float32(2 * np.pi)))
    for coef in taa._COS_COEF:
        assert repr(coef) in src
    for const in (taa._TP_HI, taa._TP_MID, taa._TP_LO):
        assert repr(const) in src


def test_backward_kernel_constants_match_python():
    """csrc/aa_snake_bwd.cu hard-codes the sine polynomial of ``aa_snake_plain_vjp`` and takes the taps, the
    cosine polynomial and the 2 pi split from aa_snake.cuh (checked above); its tile, kThreads * kRun - 6
    outputs, is the edge the card checks aim at (1274, tests/test_torch_cuda.py and chip_smoke.py)."""
    src = (build.CSRC / "aa_snake_bwd.cu").read_text()
    assert '#include "aa_snake.cuh"' in src
    for coef in taa._SIN_COEF:
        assert repr(coef) in src
    threads, run = (int(re.search(rf"{name} = (\d+);", src).group(1)) for name in ("kThreads", "kRun"))
    assert threads * run - 6 == 1274 and run % 2 == 1


def test_backward_kernel_wrapper_refuses_what_it_cannot_take():
    """The backward kernel's wrapper checks its inputs before it loads the library, so its refusals hold on
    the CPU too: a gz that does not match x, an x that is not contiguous, parameters of another width, a
    backward that would need a graph (``create_graph``) and tensors off the card raise."""
    x, a = torch.randn(2, 4, 30), torch.ones(4)
    with pytest.raises(ValueError, match="does not match"):
        aa_snake_bwd_kernel(x, a, a, torch.randn(2, 4, 29))
    with pytest.raises(ValueError, match="does not match"):
        aa_snake_bwd_kernel(x, a, a, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        aa_snake_bwd_kernel(x.transpose(0, 1), a, a, x.transpose(0, 1))
    with pytest.raises(ValueError, match="alpha"):
        aa_snake_bwd_kernel(x, torch.ones(3), a, x)
    with pytest.raises(RuntimeError, match="second derivative"):
        aa_snake_bwd_kernel(x.clone().requires_grad_(True), a, a, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        aa_snake_bwd_kernel(x, a, a, x)


def test_function_backward_on_the_cpu_is_the_plain_vjp():
    """On the CPU ``AASnakeFunction``'s backward is ``aa_snake_plain_vjp`` itself: the card's backward kernel
    is not reached and its count stays, and ``ops.launch_counts`` reports that count."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 50, generator=gen, requires_grad=True)
    alpha, beta = ((0.5 + torch.rand(3, generator=gen)).requires_grad_(True) for _ in range(2))
    gz = torch.randn(2, 3, 50, generator=gen)
    before = aa_snake.bwd_launches
    got = torch.autograd.grad(AASnakeFunction.apply(x, alpha, beta), (x, alpha, beta), gz)
    want = taa.aa_snake_plain_vjp(x.detach(), alpha.detach(), beta.detach(), gz)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert aa_snake.bwd_launches == before == ops.launch_counts()["aa_snake_bwd"]


@pytest.mark.parametrize("tool, source, variant", [
    *(("k1_variants", "aa_snake.cu", v) for v in k1_variants.VARIANTS),
    *(("k2_phases", "amp_conv_mma.cu", v) for v in k2_phases.CUTS),
    *(("k2_phases", "amp_conv_wgmma.cu", v) for v in k2_phases.WGMMA_CUTS),
])
def test_timing_tool_variants_find_their_text(tool, source, variant):
    """The timing tools build each variant by replacing pieces of a kernel source, each of which must
    still be there exactly once, or the tool fails on the card."""
    if tool == "k1_variants":
        pairs = k1_variants.VARIANTS[variant]
    else:
        pairs = [(k2_phases.WGMMA_CUTS if source == "amp_conv_wgmma.cu" else k2_phases.CUTS)[variant][:2]]
    src = (build.CSRC / source).read_text()
    assert timing.edit(src, variant, pairs) != src


def test_length_mask_matches_jax():
    from vocoder_tpu import nn as jnn
    from vocoder_tpu_torch.nn import length_mask

    x = np.random.default_rng(6).standard_normal((3, 10, 4)).astype(np.float32)
    lens = np.asarray([10, 3, 0])
    want = np.asarray(jnn.length_mask(jnp.asarray(x), jnp.asarray(lens)))
    np.testing.assert_array_equal(_from_port(length_mask(_to_port(x), torch.from_numpy(lens))), want)
    xt = _to_port(x)
    assert length_mask(xt, None) is xt


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that lies neither on the CPU nor on a CUDA card gets no fallback."""
    x = torch.empty(1, 16, 64, device="meta")
    p = torch.empty(16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        aa_snake(x, p, p, True)
    with pytest.raises(RuntimeError, match="no kernel"):
        amp_stage([], x, True)


def _port_blocks(jax_blocks, c, kernel_sizes, dilation_sizes, activation="snakebeta", logscale=True):
    cfg = BigVGANConfig(activation=activation, snake_logscale=logscale)
    blocks = []
    for jb, k, ds in zip(jax_blocks, kernel_sizes, dilation_sizes):
        blk = AMPBlock(c, k, ds, cfg)
        blk.load_state_dict(amp_block_state_dict_from_jax(jax.tree.map(np.asarray, jb)))
        blocks.append(fold_weight_norm(blk))
    return blocks


def _jax_stage_cfg(c, kernel_sizes, dilation_sizes, activation="snakebeta", logscale=True):
    return jbigvgan.BigVGANConfig(
        hop_length=4, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
        resblock_kernel_sizes=kernel_sizes, resblock_dilation_sizes=dilation_sizes,
        num_mels=8, upsample_initial_channel=2 * c, activation=activation, snake_logscale=logscale,
    )


def test_amp_stage_plain_matches_pallas_kernel():
    """The JAX fused-stage kernel's own setup and tolerance (tests/test_amp_fused.py:46-66), fold 1, C = 128."""
    kernel_sizes, dilation_sizes, c = (3, 5), ((1, 2), (1, 3)), 128
    cfg = _jax_stage_cfg(c, kernel_sizes, dilation_sizes)
    keys = jax.random.split(jax.random.key(0), len(kernel_sizes))
    jblocks = [jbigvgan._amp_init(k, c, ks, ds, cfg) for k, ks, ds in zip(keys, kernel_sizes, dilation_sizes)]
    xf = (np.random.default_rng(1).standard_normal((2, 128, 128)) * 0.5).astype(np.float32)

    want = np.asarray(jamp.amp_stage_fused(jblocks, jnp.asarray(xf), kernel_sizes, dilation_sizes, True, 1,
                                           interpret=True))
    got = amp_stage(_port_blocks(jblocks, c, kernel_sizes, dilation_sizes), _to_port(xf), True)
    np.testing.assert_allclose(_from_port(got), want, rtol=2e-4, atol=2e-5)


def tf32_split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``v`` as ``hi + lo``, both tf32 values (fp32 with the low 13 mantissa bits zero), as
    csrc/amp_conv_mma.cu's fp32 route splits each operand, with the bits of ``cvt.rna.tf32.f32``:
    round to nearest, ties away from zero."""

    def rna(u: torch.Tensor) -> torch.Tensor:
        return ((u.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(v)
    return hi, rna(v - hi)


def conv1d_3xtf32(a, w, bias, padding: int, dilation: int = 1) -> torch.Tensor:
    """F.conv1d from the fp32 route's operands and products: ``lo·hi + hi·lo + hi·hi`` of the tf32
    splits, small terms first; tf32 x tf32 products are exact in fp32.  The order of the sums is
    not the kernel's: this sums three whole convs, the kernel adds each 8-channel step's three
    products into its running sum."""
    (a_hi, a_lo), (w_hi, w_lo) = tf32_split(a), tf32_split(w)
    kw = dict(padding=padding, dilation=dilation)
    return F.conv1d(a_lo, w_hi, None, **kw) + F.conv1d(a_hi, w_lo, None, **kw) + F.conv1d(a_hi, w_hi, bias, **kw)


def test_tf32_split_rounds_to_nearest_ties_away():
    """The fp32 route's operand split (cvt.rna.tf32.f32, twice): hi and lo keep 10 explicit mantissa
    bits (the low 13 are zero), hi is v rounded to nearest with ties away from zero, and hi + lo
    is v within 2^-22 |v|."""
    rng = np.random.default_rng(9)
    v = (rng.standard_normal(100_000) * np.exp2(rng.integers(-30, 30, 100_000))).astype(np.float32)
    # Exact ties (the 13 dropped bits are 1 then zeros) at 1.x, the last one carrying into the exponent.
    ties = ((np.asarray([0, 1, 3, 0x155, 0x3FF], np.uint32) << 13) | 0x1000 | (127 << 23)).view(np.float32)
    v = np.concatenate([v, ties, -ties, np.float32([0.0, -0.0, 1.0, -3.5])])
    hi, lo = (t.numpy() for t in tf32_split(torch.from_numpy(v)))
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any()
    # Round to nearest, ties away, computed in float64 from the value, not the bits.
    v64 = v.astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.where(v64 == 0, 1.0, np.abs(v64)))) - 10)
    np.testing.assert_array_equal(hi, np.sign(v64) * np.floor(np.abs(v64) / ulp + 0.5) * ulp)
    np.testing.assert_array_equal(hi[-len(ties) - 4 : -4], -(ties + np.float32(2**-11)))  # away from zero
    assert (np.abs(hi.astype(np.float64) + lo - v64) <= np.exp2(-22) * np.abs(v64)).all()


def test_amp_stage_3xtf32_matches_pallas_kernel():
    """The fp32 route's arithmetic (plain aa-snake, tf32-split operands, three F.conv1d a conv:
    conv1d_3xtf32) against the JAX fused kernel in fp32 at its tolerance, with the setup of
    test_amp_stage_plain_matches_pallas_kernel at C = 64 (fold 2) and BigVGAN's (3, 7, 11) x
    (1, 3, 5).  Three passes read max-abs 2.4e-7 against the kernel here (outputs up to 2.2);
    one pass of TF32 (hi x hi alone) reads 4.1e-5, outside the tolerance: the reason for three."""
    kernel_sizes, dilation_sizes, c, t = (3, 7, 11), ((1, 3, 5),) * 3, 64, 512
    cfg = _jax_stage_cfg(c, kernel_sizes, dilation_sizes)
    keys = jax.random.split(jax.random.key(0), len(kernel_sizes))
    jblocks = [jbigvgan._amp_init(k, c, ks, ds, cfg) for k, ks, ds in zip(keys, kernel_sizes, dilation_sizes)]
    x = (np.random.default_rng(1).standard_normal((1, t, c)) * 0.5).astype(np.float32)

    xf = jnp.asarray(x.reshape(1, t // 2, 2 * c))  # time-folded by 2: C * fold = 128 lanes
    want = np.asarray(jamp.amp_stage_fused(jblocks, xf, kernel_sizes, dilation_sizes, True, 2, interpret=True))
    want = want.reshape(1, t, c)
    blocks = _port_blocks(jblocks, c, kernel_sizes, dilation_sizes)
    got = _from_port(amp_stage_plain(blocks, _to_port(x), True, conv=conv1d_3xtf32))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)

    def one_pass(a, w, bias, **kw):
        return F.conv1d(tf32_split(a)[0], tf32_split(w)[0], bias, **kw)

    single = _from_port(amp_stage_plain(blocks, _to_port(x), True, conv=one_pass))
    assert not np.allclose(single, want, rtol=2e-4, atol=2e-5)


def _random_jax_blocks(rng, c, kernel_sizes, dilation_sizes, cfg):
    """Weights at a scale where every branch matters: unit-norm conv rows at gain 0.5."""
    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['v']"):
            return rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("['g']"):
            return (0.5 + 0.05 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['b']"):
            return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)
        return ((0.0 if cfg.snake_logscale else 1.0) + 0.2 * rng.standard_normal(s.shape)).astype(np.float32)

    out = []
    for k, ds in zip(kernel_sizes, dilation_sizes):
        shapes = jax.eval_shape(lambda key, k=k, ds=ds: jbigvgan._amp_init(key, c, k, ds, cfg), jax.random.key(0))
        out.append(jax.tree_util.tree_map_with_path(fill, shapes))
    return out


@pytest.mark.parametrize("activation,logscale", [("snakebeta", True), ("snake", False)])
@pytest.mark.parametrize("c", [16, 64])
def test_amp_stage_plain_matches_amp_apply(c, activation, logscale):
    """Full BigVGAN block shape (3, 7, 11) x (1, 3, 5): mean of the JAX _amp_apply chains."""
    kernel_sizes, dilation_sizes = (3, 7, 11), ((1, 3, 5),) * 3
    cfg = _jax_stage_cfg(c, kernel_sizes, dilation_sizes, activation, logscale)
    rng = np.random.default_rng(c)
    jblocks = _random_jax_blocks(rng, c, kernel_sizes, dilation_sizes, cfg)
    x = rng.standard_normal((2, 200, c)).astype(np.float32)

    xj = jnp.asarray(x)
    outs = [jbigvgan._amp_apply(jax.tree.map(jnp.asarray, jb), xj, k, ds, cfg)
            for jb, k, ds in zip(jblocks, kernel_sizes, dilation_sizes)]
    want = np.asarray(sum(outs) / len(outs))
    blocks = _port_blocks(jblocks, c, kernel_sizes, dilation_sizes, activation, logscale)
    got = amp_stage_plain(blocks, _to_port(x), logscale)
    np.testing.assert_allclose(_from_port(got), want, rtol=2e-4, atol=2e-5)


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def test_amp_stage_plain_bf16_matches_pallas_kernel(monkeypatch):
    """bf16 x: the plain stage rounds each conv input to bf16 as the fused kernel
    rounds its matmul operands to mm_dtype = x.dtype.  The snake parameters reach
    the JAX stage in bf16, as its bf16 eval casts them, so both sides take their
    exp in bf16.  Interior rows only (the JAX wrapper splices the edge rows from
    its XLA oracle); measured 1.0e-3 (1.6e-3 with the conv inputs left in fp32)."""
    kernel_sizes, dilation_sizes, c, t = (3, 7, 11), ((1, 3, 5),) * 3, 128, 512
    cfg = _jax_stage_cfg(c, kernel_sizes, dilation_sizes)
    rng = np.random.default_rng(2)
    jblocks = _random_jax_blocks(rng, c, kernel_sizes, dilation_sizes, cfg)
    # Biases and snake parameters as bf16 values, so both sides hold the same numbers.
    jblocks = jax.tree_util.tree_map_with_path(
        lambda path, v: v if jax.tree_util.keystr(path).endswith(("['v']", "['g']")) else _bf16_exact(v), jblocks)
    x = _bf16_exact(rng.standard_normal((1, t, c)).astype(np.float32))

    # The edge oracle runs XLA convs, which need one dtype: run it in fp32 (those rows are not compared).
    oracle = jbigvgan._amp_apply
    monkeypatch.setattr(jbigvgan, "_amp_apply", lambda p, v, *a: oracle(p, v.astype(jnp.float32), *a).astype(v.dtype))
    jblocks16 = jax.tree_util.tree_map_with_path(
        lambda path, v: v.astype(jnp.bfloat16) if jax.tree_util.keystr(path).endswith(("['alpha']", "['beta']")) else v,
        jblocks)
    want = np.asarray(jamp.amp_stage_fused(jblocks16, jnp.asarray(x, jnp.bfloat16), kernel_sizes, dilation_sizes,
                                           True, 1, interpret=True).astype(jnp.float32))
    blocks = [b.to(torch.bfloat16) for b in _port_blocks(jblocks, c, kernel_sizes, dilation_sizes)]
    got = _from_port(amp_stage(blocks, _to_port(x).to(torch.bfloat16), True).float())

    left, right = jamp._halos(kernel_sizes, dilation_sizes, 1)
    got, want = got[:, left : t - right], want[:, left : t - right]
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2e-3


def test_pack_conv_weight():
    """The tensor-core kernel's weight layout: pack[j, o, i] == w[o, i, j], bf16 kept."""
    w = torch.from_numpy(np.random.default_rng(8).standard_normal((32, 16, 5)).astype(np.float32)).to(torch.bfloat16)
    packed = pack_conv_weight(w)
    assert packed.shape == (5, 32, 16) and packed.dtype == torch.bfloat16 and packed.is_contiguous()
    for j, o, i in np.ndindex(5, 32, 16):
        assert packed[j, o, i] == w[o, i, j]


@pytest.mark.parametrize("dtype,c", [(torch.float32, 64), (torch.float32, 128), (torch.float32, 32),
                                     (torch.bfloat16, 64)])
def test_wgmma_weight_pack(dtype, c):
    """The wgmma kernel's B operand (``StagePlan.halves``): at fp32 and C in ``WGMMA_TIME_TILES`` each conv of
    the plan, in launch order, keeps a contiguous (2, K, C, C) pack, hi then lo of ``tf32_split`` (K3's split)
    of ``pack_conv_weight``'s output.  The kernel's TMA map reads it as 2 K C rows of C: tap j's hi half at
    rows j C + o, its lo half at rows (K + j) C + o, input channel i in column i.  Other dtypes and widths
    keep none, and a plan on the CPU holds no maps."""
    cfg = BigVGANConfig(hop_length=4, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), num_mels=8,
                        upsample_initial_channel=2 * c)
    from vocoder_tpu_torch.models.bigvgan import BigVGAN, random_state_dict

    model = BigVGAN(cfg)
    model.load_state_dict(random_state_dict(cfg, seed=4))
    blocks = list(fold_weight_norm(model).to(dtype).eval().resblocks[:3])
    plan = amp_block.stage_plan(blocks, True)
    assert plan.maps == [] and plan.map_addrs == []
    if dtype != torch.float32 or c not in amp_block.WGMMA_TIME_TILES:
        assert plan.halves == []
        return
    convs = [(conv, blk.kernel_size) for blk in blocks for pair in zip(blk.convs1, blk.convs2) for conv in pair]
    assert len(plan.halves) == len(convs) == 18
    for halves, (conv, k) in zip(plan.halves, convs):
        assert halves.shape == (2, k, c, c) and halves.dtype == torch.float32 and halves.is_contiguous()
        assert torch.equal(halves, torch.stack(k3_split(pack_conv_weight(conv.weight))))
        rows = halves.view(2 * k * c, c)
        for h, half in enumerate(k3_split(conv.weight.detach())):
            for j in range(k):
                assert torch.equal(rows[(h * k + j) * c : (h * k + j + 1) * c], half[:, :, j])


def test_wgmma_shape_rule():
    """The wgmma kernel takes a stage from (C, B, T) and the SM count alone: on 132 SMs, C = 64 and 128 at every
    grid, and C = 256 once its grid (one block a 64-time tile and item) passes a quarter of the SMs, so BigVGAN's
    b16 stages at 256 frames and a request's stage 0 from 34 tiles (265 frames) on; never a width outside
    ``WGMMA_TIME_TILES`` (C = 32, 16, 192)."""
    wins = amp_block.wgmma_wins
    assert amp_block.WGMMA_TIME_TILES == {64: 128, 128: 128, 256: 64}
    assert all(wins(c, 16, 256 * 8 * 2**i, 132) for i, c in enumerate((256, 128, 64)))
    assert wins(128, 1, 1, 132) and wins(64, 1, 128, 132)
    assert not wins(256, 1, 33 * 64, 132) and wins(256, 1, 33 * 64 + 1, 132) and wins(256, 1, 265 * 8, 132)
    assert not wins(256, 1, 256 * 8, 132) and wins(256, 3, 12 * 64, 132)
    assert not any(wins(c, 16, 65536, 132) for c in (16, 32, 192))


@pytest.mark.parametrize("resolution", ["44100_512_2048", "24000_256_1024"])
def test_log_mel_matches_jax(resolution):
    from vocoder_tpu.config import RESOLUTIONS

    r = RESOLUTIONS[resolution]
    rng = np.random.default_rng(3)
    audio = (0.3 * rng.standard_normal((2, 8 * r["hop_length"] + 37))).astype(np.float32)
    kw = dict(sample_rate=r["sampling_rate"], n_fft=r["n_fft"], hop_length=r["hop_length"],
              win_length=r["win_length"], n_mels=r["num_mels"], f_max=r["sampling_rate"] // 2)
    want = np.asarray(jspectral.log_mel_spectrogram(jnp.asarray(audio), **kw))
    got = log_mel_spectrogram(torch.from_numpy(audio), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        jspectral.mel_filterbank(r["sampling_rate"], r["n_fft"], r["num_mels"]),
        mel_filterbank(r["sampling_rate"], r["n_fft"], r["num_mels"]),
    )


def test_wav_io_and_resample_match_jax_package(tmp_path):
    from vocoder_tpu.data import audio_io as jio
    from vocoder_tpu.data import resample as jres
    from vocoder_tpu_torch.data import audio_io, resample

    rng = np.random.default_rng(4)
    audio = np.clip(0.2 * rng.standard_normal((2, 1001)), -0.99, 0.99).astype(np.float32)
    audio_io.write_wav(tmp_path / "a.wav", audio, 22050)
    got, sr = audio_io.read_wav(tmp_path / "a.wav")
    want, want_sr = jio.read_wav(tmp_path / "a.wav")
    assert sr == want_sr == 22050
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, audio, atol=1.0 / 32768)
    np.testing.assert_allclose(resample.resample(got, 22050, 44100), jres.resample(got, 22050, 44100),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(audio_io.UnsupportedFormatError, match="no decoder"):  # an audio suffix without a decoder
        audio_io.read_audio(tmp_path / "a.m4a")


def test_chunked_synthesis_matches_jax():
    from vocoder_tpu.parallel.streaming import chunked_synthesis as jchunked
    from vocoder_tpu_torch.parallel.streaming import chunked_synthesis

    hop = 4
    mel = np.random.default_rng(5).standard_normal((1, 3, 150)).astype(np.float32)
    weights = np.arange(1, 4, dtype=np.float32)

    def port_fn(m):
        return torch.repeat_interleave(torch.einsum("c,bct->bt", torch.from_numpy(weights), m), hop, -1)[:, None]

    def jax_fn(m):
        return jnp.repeat(jnp.einsum("c,bct->bt", weights, m), hop, axis=-1)[:, None]

    got = chunked_synthesis(port_fn, torch.from_numpy(mel), hop_length=hop, chunk_frames=72, overlap_frames=32)
    want = jchunked(jax_fn, jnp.asarray(mel), hop_length=hop, chunk_frames=72, overlap_frames=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
