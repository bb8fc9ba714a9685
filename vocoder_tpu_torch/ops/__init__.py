"""The hand kernels (K1 ``aa_snake``, K2 ``amp_stage``, the ConvNeXt MLP's ``linear_3xtf32``) beside their plain
versions, and their build (``build``)."""


def launch_counts() -> dict[str, int]:
    """Each hand kernel's launches in this process: K1, its backward (calls), K2's fp32 (3xTF32) route and
    those of its launches that took the wgmma kernel, K2's bf16 route, and the 3xTF32 Linear."""
    from vocoder_tpu_torch.ops.aa_snake import aa_snake
    from vocoder_tpu_torch.ops.amp_block import amp_stage
    from vocoder_tpu_torch.ops.linear_3xtf32 import linear_3xtf32

    return {"aa_snake": aa_snake.launches, "aa_snake_bwd": aa_snake.bwd_launches,
            "amp_conv_mma_3xtf32": amp_stage.launches,
            "amp_conv_wgmma": amp_stage.wgmma_launches, "amp_conv_mma": amp_stage.mma_launches,
            "linear_3xtf32": linear_3xtf32.launches}
