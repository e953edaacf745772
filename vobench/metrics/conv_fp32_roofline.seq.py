"""`conv_fp32_roofline.seq`: Kernel 4's share of its roofline per segment (2N
images)."""

from vobench import readers

UNIT = "%"
LAYER = "conv kernel 4 (ops/conv_cuda.py, csrc/conv_fp32.cu)"
MOVES = "seq_frames_per_s"

read = readers.roofline(["conv_fp32_kernel", "conv_fp32_dense_kernel"], "fp32")
