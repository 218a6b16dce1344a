"""Shape-bucketed plan specialization & dispatch (beyond-paper).

Partitions the declared dynamic-shape space into buckets, re-runs the
compile-time pipeline once per bucket under the bucket's tighter bounds,
and dispatches each call to its bucket's plan in O(log n) per dim — the
compilation–runtime split of BladeDISC++ sharpened by SoD²-style
shape-space pre-partitioning.
"""
from .buckets import (DEFAULT_BUCKETS_PER_DIM, BucketSpace, BucketsSpec,
                      DimBuckets, build_bucket_space)
from .table import BucketKey, BucketPlan, SpecializationTable

__all__ = [
    "DEFAULT_BUCKETS_PER_DIM", "BucketSpace", "BucketsSpec", "DimBuckets",
    "build_bucket_space",
    "BucketKey", "BucketPlan", "SpecializationTable",
]
