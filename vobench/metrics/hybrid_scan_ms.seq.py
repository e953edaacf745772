"""`hybrid_scan_ms.seq`: The hybrid's sequential scan of the prior-dependent
solve, CUDA-event ms per segment, median."""

from vobench import readers

UNIT = "ms"
LAYER = "online hybrid (parallel.sharding.OnlineHybrid)"
MOVES = "seq_frames_per_s"

read = readers.median_of("phase_ms", "scan")
