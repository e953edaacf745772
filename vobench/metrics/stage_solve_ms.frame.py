"""`stage_solve_ms.frame`: The solve stage of `process_instrumented` (chain,
triangulation, RANSAC, gates, LM, landmark fusion), median ms per frame."""

from vobench import readers

UNIT = "ms"
LAYER = "per-frame step program (pipeline.OnlineVO, StepProgram)"
MOVES = "frame_ms_p50"

read = readers.median_of("stage_ms", "solve")
