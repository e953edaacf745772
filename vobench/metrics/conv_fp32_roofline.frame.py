"""`conv_fp32_roofline.frame`: Kernel 4's share of its roofline per frame
(fp32 FFMA peak, TF32 off)."""

from vobench import readers

UNIT = "%"
LAYER = "conv kernel 4 (ops/conv_cuda.py, csrc/conv_fp32.cu)"
MOVES = "frame_ms_p50"

read = readers.roofline(["conv_fp32_kernel", "conv_fp32_dense_kernel"], "fp32")
