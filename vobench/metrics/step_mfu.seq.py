"""`step_mfu.seq`: The whole step's share of the chip's peak over a traced
window of segments."""

from vobench import readers

UNIT = "%"
LAYER = "device (H100)"
MOVES = "seq_frames_per_s"

read = readers.mfu
