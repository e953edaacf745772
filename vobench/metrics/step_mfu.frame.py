"""`step_mfu.frame`: The whole step's share of the chip's peak: the trunk's
model FLOPs (2 x outputs x K of every conv, two images a frame) of the
frames the traced window completed, over the window at the precision's
peak."""

from vobench import readers

UNIT = "%"
LAYER = "device (H100)"
MOVES = "frame_ms_p50"

read = readers.mfu
