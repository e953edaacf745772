"""`device_idle_pct.frame`: The share of the traced window in which no kernel,
copy or fill ran."""

from vobench import readers

UNIT = "%"
LAYER = "device (H100)"
MOVES = "frame_ms_p50"

read = readers.idle
