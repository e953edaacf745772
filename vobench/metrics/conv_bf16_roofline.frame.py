"""`conv_bf16_roofline.frame`: Kernel 3's share of its roofline per frame: the
least time of the trunk's convs at two images from layer shapes over the
device time of the kernels so named."""

from vobench import readers

UNIT = "%"
LAYER = "conv kernel 3 (ops/conv_cuda.py, csrc/conv_bf16.cu)"
MOVES = "frame_ms_p50"

read = readers.roofline(["conv_bf16_kernel", "conv_dense_kernel"], "bf16")
