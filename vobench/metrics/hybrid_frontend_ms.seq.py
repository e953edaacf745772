"""`hybrid_frontend_ms.seq`: The hybrid's front-end phase (trunk and
postprocess over the segment's 2N images) as its own CUDA graph, CUDA-event
ms per segment, median."""

from vobench import readers

UNIT = "ms"
LAYER = "online hybrid (parallel.sharding.OnlineHybrid)"
MOVES = "seq_frames_per_s"

read = readers.median_of("phase_ms", "frontend")
