"""`device_idle_pct.seq`: The share of the traced window in which no kernel,
copy or fill ran."""

from vobench import readers

UNIT = "%"
LAYER = "device (H100)"
MOVES = "seq_frames_per_s"

read = readers.idle
