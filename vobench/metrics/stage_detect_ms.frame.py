"""`stage_detect_ms.frame`: The front-end stage of `process_instrumented`
(preprocessing, trunk, detector postprocess; its own CUDA graph closed by a
host read), median ms over the frames of the traced run's stage part."""

from vobench import readers

UNIT = "ms"
LAYER = "per-frame step program (pipeline.OnlineVO, StepProgram)"
MOVES = "frame_ms_p50"

read = readers.median_of("stage_ms", "detect")
