"""`conv_bf16_roofline.seq`: Kernel 3's share of its roofline per segment (2N
images)."""

from vobench import readers

UNIT = "%"
LAYER = "conv kernel 3 (ops/conv_cuda.py, csrc/conv_bf16.cu)"
MOVES = "seq_frames_per_s"

read = readers.roofline(["conv_bf16_kernel", "conv_dense_kernel"], "bf16")
