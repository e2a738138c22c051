"""Host runtime: frame pipeline, checkpointing, CLI, telemetry.

The analogue of the reference's L1/L2 runtime — the event-bus
worker threads (src/EventsThread.{h,cpp}), the frame scheduler
(src/SlamGpuPipeline/SlamGpuPipeline.cpp) and the WebSocket telemetry
server (src/WebSocket/WebSocketCom.cpp) — rebuilt as a thin asynchronous
host layer around jitted device programs.
"""

from jetracer_orbslam2_tpu.runtime.pipeline import FramePipeline, PipelineStats
from jetracer_orbslam2_tpu.runtime.checkpoint import (
    save_checkpoint, load_checkpoint)

__all__ = [
    "FramePipeline",
    "PipelineStats",
    "save_checkpoint",
    "load_checkpoint",
]
