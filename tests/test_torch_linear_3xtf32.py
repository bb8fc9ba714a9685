"""The 3xTF32 Linear (``ops/linear_3xtf32.py``) on the CPU: its operand split, its plain arithmetic against an
fp64 product at the ConvNeXt MLP's widths and the routing rule of ``ConvNeXtBlock``.  The weight pack's cache is
held to the rule of every such cache in ``tests/test_torch_weight_cache.py``.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``); here the launcher is monkeypatched
where a test needs the kernel's route taken.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_ops import tf32_split as k2_split
from vocoder_tpu_torch.models import convnext
from vocoder_tpu_torch.models.convnext import ConvNeXtBlock, ConvNeXtConfig
from vocoder_tpu_torch.ops import linear_3xtf32 as lin3

# The MLP widths (C, hidden): vocos-huge's four stages at mlp_ratio 4, and Vocos base's (512, 1536).
WIDTHS = [(352, 1408), (704, 2816), (1408, 5632), (2816, 11264), (512, 1536)]

# Relative L2 distance to the fp64 product, fixed before any reading: the split drops lo·lo (2^-22 of a
# product) and the three fp32 products each round their sums over up to 11,264 terms (~1e-6 for data
# like this), so 1e-5 holds with room; one pass of TF32 (hi·hi alone) keeps ~3 digits and reads ~1e-4 to
# 1e-3, outside it.  The card tests hold the kernel to the same 1e-5.
REL_L2 = 1e-5


def _values(kind: str) -> torch.Tensor:
    rng = np.random.default_rng(9)
    if kind == "wide":  # 30 binades either side of 1
        v = rng.standard_normal(50_000) * np.exp2(rng.integers(-30, 30, 50_000))
    elif kind == "ties":  # the 13 dropped bits exactly half, at 1.x; the last carries into the exponent
        t = ((np.asarray([0, 1, 3, 0x155, 0x3FF], np.uint32) << 13) | 0x1000 | (127 << 23)).view(np.float32)
        v = np.concatenate([t, -t, [0.0, -0.0, 1.0, -3.5]])
    else:  # activations and weights at the model's scales
        v = rng.standard_normal(50_000) * 0.05
    return torch.from_numpy(np.asarray(v, np.float32))


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().double() - b.detach()).norm() / b.detach().norm())


@pytest.mark.parametrize("kind", ["wide", "ties", "model"])
def test_split_is_k2s_and_exact_to_2_pow_minus_22(kind):
    """The kernel's split is K2's (tests/test_torch_ops.py::tf32_split) to the bit; hi and lo keep 10
    explicit mantissa bits (the low 13 are zero) and hi + lo is x within 2^-22 |x|."""
    v = _values(kind)
    hi, lo = lin3.tf32_split(v)
    want_hi, want_lo = k2_split(v)
    assert torch.equal(hi.view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(lo.view(torch.int32), want_lo.view(torch.int32))
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    v64 = v.double()
    assert ((hi.double() + lo.double() - v64).abs() <= 2.0**-22 * v64.abs()).all()


def _linear(k: int, n: int, seed: int) -> torch.nn.Linear:
    rng = np.random.default_rng(seed)
    lin = torch.nn.Linear(k, n)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy((rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)))
        lin.bias.copy_(torch.from_numpy((0.05 * rng.standard_normal(n)).astype(np.float32)))
    return lin


@pytest.mark.parametrize("c,hidden", WIDTHS)
def test_plain_three_products_match_fp64(c, hidden):
    """pwconv1 (C -> hidden, with GELU) and pwconv2 (hidden -> C) of one block in the kernel's arithmetic,
    each against the fp64 product of the same operands, at 33 rows (a ragged tile)."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.standard_normal((33, c)).astype(np.float32))
    for lin, gelu in ((_linear(c, hidden, 1), True), (_linear(hidden, c, 2), False)):
        want = x.double() @ lin.weight.double().T + lin.bias.double()
        want = F.gelu(want) if gelu else want
        got = lin3.linear_3xtf32_plain(x, lin.weight, lin.bias, gelu)
        assert _rel_l2(got, want) < REL_L2
        single = F.linear(lin3.tf32_split(x)[0], lin3.tf32_split(lin.weight)[0], lin.bias)
        assert _rel_l2(F.gelu(single) if gelu else single, want) > REL_L2  # one TF32 pass fails the bound
        x = want.float()  # pwconv2 reads pwconv1's GELU output, as in the block


def _block(dtype=torch.float32) -> ConvNeXtBlock:
    torch.manual_seed(0)
    return ConvNeXtBlock(16, ConvNeXtConfig(dims=(16,), depths=(1,), layer_scale_init_value=0.1)).to(dtype).eval()


@pytest.fixture
def kernel_on_cpu(monkeypatch):
    """The routing rule taken on the CPU as on the card, with the launcher replaced by a recorder around the
    plain version; also records every tp.linear the block calls."""
    calls = {"kernel": [], "library": []}

    def launcher(x, linear, gelu=False):
        calls["kernel"].append(gelu)
        lin3.packed_weight(linear)  # as the kernel's wrapper takes its B operands
        return lin3.linear_3xtf32_plain(x, linear.weight, linear.bias, gelu)

    def library(module, x):  # tp.linear of a Linear that no rank shards
        calls["library"].append(module)
        return F.linear(x, module.weight, module.bias)

    monkeypatch.setattr(lin3, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(lin3, "linear_3xtf32", launcher)
    monkeypatch.setattr(convnext.tp, "linear", library)
    return calls


@pytest.mark.parametrize("case", ["fp32_inference", "no_grad_with_grad_params", "bf16", "grad_enabled",
                                  "tensor_parallel", "inference_tensor_weights", "cpu_tensor"])
def test_block_routes_by_what_it_observes(case, kernel_on_cpu, monkeypatch):
    """fp32 without a recorded gradient goes to the kernel (pwconv1 with GELU, then pwconv2), twice for two
    forwards, with each weight split once; weights made under inference mode (no version counter) go there too
    and are split again at every call.  bf16, a recorded gradient and a tensor-parallel Linear take tp.linear;
    so does a CPU tensor once the rule asks for the card again.  The library route counts in ``library_mlps``
    only for CUDA tensors."""
    if case == "inference_tensor_weights":
        with torch.inference_mode():
            block = _block()
    else:
        block = _block(torch.bfloat16 if case == "bf16" else torch.float32)
    x = torch.randn(2, 9, 16, dtype=torch.bfloat16 if case == "bf16" else torch.float32)
    if case == "tensor_parallel":
        monkeypatch.setattr(block.pwconv2, "tp_layer", object(), raising=False)
    if case == "cpu_tensor":
        monkeypatch.setattr(lin3, "KERNEL_DEVICE", "cuda")
    before, builds = ConvNeXtBlock.library_mlps, lin3.weight_packs.builds
    for _ in range(2):
        if case == "grad_enabled":
            y = block(x)
        elif case == "no_grad_with_grad_params":
            with torch.no_grad():
                y = block(x)
        else:
            with torch.inference_mode():
                y = block(x)
    to_kernel = case in ("fp32_inference", "no_grad_with_grad_params", "inference_tensor_weights")
    assert kernel_on_cpu["kernel"] == ([True, False] * 2 if to_kernel else [])
    assert kernel_on_cpu["library"] == ([] if to_kernel else [block.pwconv1, block.pwconv2] * 2)
    assert lin3.weight_packs.builds - builds == (4 if case == "inference_tensor_weights" else 2 if to_kernel else 0)
    assert ConvNeXtBlock.library_mlps == before  # CPU tensors are not counted
    assert y.dtype == x.dtype and y.shape == x.shape


def test_kernel_route_equals_library_route_on_the_cpu(kernel_on_cpu):
    """The block through the (plain) kernel route against its tp.linear route: fp32 rounding apart."""
    block, x = _block(), torch.randn(2, 9, 16)
    with torch.inference_mode():
        got = block(x)
    assert kernel_on_cpu["kernel"] == [True, False]
    want = block(x).detach()  # grad enabled: the library route
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
