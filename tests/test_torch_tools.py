"""The port's card tools, in the parts that run without a card."""

from __future__ import annotations

import types

import pytest
import torch

from vocoder_tpu_torch.tools import profile_forward, sass_diff, timing

_DUMP = """
\tcode for sm_90a
\t\tFunction : _ZN44_GLOBAL__N__{tag}_11_aa_snake_cu_{hash}15aa_snake_kernelIfEEvPKT_
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   {op} ;                                 /* 0x000fe20000000f00 */
"""


def test_sass_parse_drops_addresses_and_the_files_tag():
    """Two builds of one kernel from files in other places name it with other anonymous-namespace
    tags; the parser keys both alike and keeps only the instructions."""
    a = sass_diff.parse_sass(_DUMP.format(tag="29ecee68", hash="f69d9d4f", op="EXIT"))
    b = sass_diff.parse_sass(_DUMP.format(tag="124768de", hash="7e739fc3", op="EXIT"))
    assert list(a) == list(b) == ["_ZN15aa_snake_kernelIfEEvPKT_"]
    assert a == b
    assert a["_ZN15aa_snake_kernelIfEEvPKT_"] == ["LDC R1, c[0x0][0x28]", "EXIT"]


@pytest.mark.parametrize("a, b, want", [
    (["X", "Y", "Z"], ["X", "Y", "Z"], 0),
    (["X", "Y", "Z"], ["X", "W", "Z"], 1),
    (["X", "Y", "Z"], ["X", "Z"], 1),
    (["X"], ["X", "Y", "Z"], 2),
])
def test_sass_differing_lines(a, b, want):
    assert sass_diff.differing_lines(a, b) == want


def test_edit_replaces_each_text_once_and_refuses_a_missing_one():
    assert timing.edit("a b c", "v", [("b", "B"), ("c", "C")]) == "a B C"
    with pytest.raises(RuntimeError, match="exactly one"):
        timing.edit("a b b", "v", [("b", "B")])
    with pytest.raises(RuntimeError, match="exactly one"):
        timing.edit("a b c", "v", [("d", "D")])


def test_kernel_times_leave_out_the_spans_device_copies():
    """The profiler lists a span's device-side range beside the kernels it holds; only kernels count."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(name, device, us, span=False):
        return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=span,
                                     time_range=types.SimpleNamespace(elapsed_us=lambda: us))

    prof = types.SimpleNamespace(events=lambda: [
        event("gen.forward", cuda, 100.0, span=True), event("gen.mlp", cuda, 60.0, span=True),
        event("gemm", cuda, 40.0), event("gemm", cuda, 20.0), event("gelu", cuda, 5.0),
        event("aten::linear", cpu, 70.0)])
    assert dict(profile_forward.kernel_times(prof)) == {"gemm": [40.0, 20.0], "gelu": [5.0]}
