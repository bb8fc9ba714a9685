"""The hand kernels (K1 ``aa_snake``, K2 ``amp_stage``) beside their plain versions, and their build (``build``)."""


def launch_counts() -> dict[str, int]:
    """Each hand kernel's launches in this process: K1, and K2's fp32 (3xTF32) and bf16 routes."""
    from vocoder_tpu_torch.ops.aa_snake import aa_snake
    from vocoder_tpu_torch.ops.amp_block import amp_stage

    return {"aa_snake": aa_snake.launches, "amp_conv_mma_3xtf32": amp_stage.launches,
            "amp_conv_mma": amp_stage.mma_launches}
