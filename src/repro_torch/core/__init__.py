"""COVAP core in PyTorch: bucket plans, the coarse filter, error feedback,
static comm schedules, the zero-copy arena, the segmented and flat-bucket
sync pipelines, the overlap engine (the fused overlap and the deferred
param all-gather of sharded sync) and the analytic CCR."""
from . import (
    arena,
    bucketing,
    ccr,
    comm,
    compressors,
    error_feedback,
    filter,
    overlap,
    schedule,
    stages,
)
from .bucketing import BucketPlan, ReadyOrder, build_plan, build_ready_order
from .comm import Compressor, SyncStats
from .compressors import get_compressor
from .error_feedback import EFSchedule
from .filter import compression_ratio, selected_buckets
from .schedule import CollectiveCall, CommSchedule
from .stages import SyncPipeline

__all__ = [
    "arena",
    "bucketing",
    "ccr",
    "comm",
    "compressors",
    "error_feedback",
    "filter",
    "overlap",
    "schedule",
    "stages",
    "BucketPlan",
    "ReadyOrder",
    "build_plan",
    "build_ready_order",
    "Compressor",
    "SyncStats",
    "get_compressor",
    "EFSchedule",
    "compression_ratio",
    "selected_buckets",
    "CollectiveCall",
    "CommSchedule",
    "SyncPipeline",
]
