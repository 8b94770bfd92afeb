"""COVAP core in PyTorch: bucket plans, the coarse filter, error feedback,
static comm schedules, the zero-copy arena, the segmented and flat-bucket
sync pipelines and the deferred param all-gather of sharded sync."""
from . import (
    arena,
    bucketing,
    comm,
    compressors,
    error_feedback,
    filter,
    overlap,
    schedule,
    stages,
)
from .bucketing import BucketPlan, build_plan
from .comm import Compressor, SyncStats
from .compressors import get_compressor
from .error_feedback import EFSchedule
from .filter import compression_ratio, selected_buckets
from .schedule import CollectiveCall, CommSchedule
from .stages import SyncPipeline

__all__ = [
    "arena",
    "bucketing",
    "comm",
    "compressors",
    "error_feedback",
    "filter",
    "overlap",
    "schedule",
    "stages",
    "BucketPlan",
    "build_plan",
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
