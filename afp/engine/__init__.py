"""L3 streaming runtime: config, fused pipeline, engine orchestration,
presets, checkpoints, metrics."""
from .batch import (broadcast_gains, with_per_stream_agc,
                    with_per_stream_filters, with_per_stream_gains)
from .checkpoint import load_checkpoint, save_checkpoint
from .config import DEFAULT_EQ_BANDS, EQBand, PipelineParams, StreamConfig
from .engine import StreamEngine
from .metrics import EngineMetrics
from .pipeline import DeviceParams, Pipeline, StreamState
from .presets import PresetStore

__all__ = [
    "DEFAULT_EQ_BANDS", "EQBand", "PipelineParams", "StreamConfig",
    "DeviceParams", "Pipeline", "StreamState",
    "StreamEngine", "EngineMetrics", "PresetStore",
    "save_checkpoint", "load_checkpoint",
    "broadcast_gains", "with_per_stream_agc",
    "with_per_stream_filters", "with_per_stream_gains",
]
