"""Published dense peaks of the cards the benchmark knows, by ``torch.cuda.get_device_name()``.

NVIDIA H100 SXM (data sheet, dense, at the 700 W limit): 495 TFLOP/s on the tensor cores in TF32, 989 in bf16,
3.35 TB/s of HBM3.  An fp32 configuration is held against the TF32 rate: the port's fp32-accurate kernels already
run on the tensor cores (K2's 3xTF32 route), so the 67 TFLOP/s of the CUDA cores is no ceiling for them.  The
card's power limit is printed beside every reading.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": {"float32": 495e12, "bfloat16": 989e12}, "bytes_per_s": 3.35e12},
}
