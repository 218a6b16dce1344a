"""Shape-space partitioning for plan specialization (dispatch stage 1).

One schedule/remat/arena plan for a whole declared range (`s ∈ [16, 4096]`)
pays worst-case conservatism at `s = 32`.  BladeDISC++ resolves what the
compile time cannot decide at runtime; SoD²-style pre-partitioning goes the
other way: split the declared shape space into *buckets*, give each bucket
its own tighter ``BoundEnv``, and let the compile-time pipeline decide more
per bucket.  This module owns the partition itself:

* ``DimBuckets`` — one dim's range cut into contiguous integer sub-ranges,
  represented by the ascending list of inclusive *upper* edges (the last
  edge may be ``None`` for a range with no declared upper bound).  Lookup
  is ``bisect`` over the edges — O(log n) per dim — and a value sitting
  exactly on an edge deterministically lands in the **lower** bucket
  (edges are inclusive).
* ``BucketSpace`` — the cross product over dims; a concrete env maps to a
  key ``(i_0, i_1, ...)``, one index per dim in sorted-name order.
* ``build_bucket_space`` — builds the partition from declared dim ranges
  and the user's ``optimize(..., buckets=...)`` spec: **geometric** by
  default (edges spaced by a constant ratio, matching how activation
  memory scales with shape), or explicit per-dim cut points / counts.
"""
from __future__ import annotations

import itertools
from bisect import bisect_left
from dataclasses import dataclass
from typing import (Dict, Iterator, List, Mapping, Optional, Sequence, Tuple,
                    Union)

from ..symbolic.intervals import Interval

# default geometric bucket count per bounded dim for buckets="geometric"
DEFAULT_BUCKETS_PER_DIM = 4

BucketsSpec = Union[bool, int, str, Mapping[str, Union[int, Sequence[int]]]]


@dataclass(frozen=True)
class DimBuckets:
    """One dim's declared range split into contiguous integer sub-ranges.

    ``uppers`` are the inclusive upper edges, ascending; only the last may
    be ``None`` (no declared upper bound — the final bucket is open).
    Bucket ``i`` covers ``[lo, uppers[0]]`` for ``i == 0`` and
    ``[uppers[i-1] + 1, uppers[i]]`` after.
    """

    name: str
    lo: int
    uppers: Tuple[Optional[int], ...]

    def __post_init__(self) -> None:
        if not self.uppers:
            raise ValueError(f"dim {self.name!r}: empty bucket edge list")
        finite = [u for u in self.uppers if u is not None]
        if None in self.uppers[:-1]:
            raise ValueError(
                f"dim {self.name!r}: only the last edge may be open (None)")
        if any(b <= a for a, b in zip(finite, finite[1:])):
            raise ValueError(
                f"dim {self.name!r}: edges must be strictly ascending, "
                f"got {self.uppers}")
        if finite and finite[0] < self.lo:
            raise ValueError(
                f"dim {self.name!r}: first edge {finite[0]} below lo={self.lo}")

    @property
    def n(self) -> int:
        return len(self.uppers)

    def index_of(self, v: int) -> int:
        """Bucket index for a concrete dim value — O(log n) bisect.

        Values on an edge land in the lower bucket (edges are inclusive
        upper bounds), so dispatch at a boundary is deterministic.  Values
        outside the partition raise: silently clamping into an edge bucket
        would group an out-of-contract request under a bucket whose plan
        (and arena bound) does not cover it.
        """
        if v < self.lo or (self.uppers[-1] is not None
                           and v > self.uppers[-1]):
            hi = "inf" if self.uppers[-1] is None else self.uppers[-1]
            raise ValueError(
                f"dim {self.name!r}={v} outside the bucketed range "
                f"[{self.lo}, {hi}]")
        finite = self.uppers[:-1] if self.uppers[-1] is None else self.uppers
        return min(bisect_left(finite, v), self.n - 1)

    def range_of(self, i: int) -> Interval:
        lo = self.lo if i == 0 else self.uppers[i - 1] + 1
        return Interval(lo, self.uppers[i])


@dataclass(frozen=True)
class BucketSpace:
    """Cross product of per-dim partitions; env -> bucket key lookup."""

    dims: Tuple[DimBuckets, ...]       # sorted by dim name

    @property
    def dim_names(self) -> Tuple[str, ...]:
        return tuple(d.name for d in self.dims)

    @property
    def n_buckets(self) -> int:
        out = 1
        for d in self.dims:
            out *= d.n
        return out

    def key_of(self, env: Mapping[str, int]) -> Tuple[int, ...]:
        """Bucket key for a concrete dim binding (one bisect per dim)."""
        try:
            return tuple(d.index_of(env[d.name]) for d in self.dims)
        except KeyError as e:
            raise KeyError(
                f"env {dict(env)!r} misses bucketed dim {e.args[0]!r}") from None

    def ranges_of(self, key: Tuple[int, ...]) -> Dict[str, Interval]:
        """The per-dim sub-ranges the bucket ``key`` covers."""
        if len(key) != len(self.dims):
            raise ValueError(f"key {key} does not match dims {self.dim_names}")
        return {d.name: d.range_of(i) for d, i in zip(self.dims, key)}

    def keys(self) -> Iterator[Tuple[int, ...]]:
        """All bucket keys, lexicographic."""
        return itertools.product(*(range(d.n) for d in self.dims))

    def describe(self, key: Tuple[int, ...]) -> str:
        parts = []
        for d, i in zip(self.dims, key):
            iv = d.range_of(i)
            hi = "inf" if iv.hi is None else str(iv.hi)
            parts.append(f"{d.name}∈[{iv.lo},{hi}]")
        return " ".join(parts)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        body = ", ".join(f"{d.name}:{d.n}" for d in self.dims)
        return f"BucketSpace({body}; {self.n_buckets} buckets)"


def _nearest_nth_root(p: int, n: int) -> int:
    """Nearest integer to the real ``n``-th root of ``p``, exactly.

    Pure integer arithmetic: the float seed is only a starting guess and
    is corrected by exact comparisons, so every process computes the same
    value regardless of libm/FPU differences.
    """
    r = max(int(round(p ** (1.0 / n))), 0)
    while r > 0 and r ** n > p:
        r -= 1
    while (r + 1) ** n <= p:
        r += 1
    # round toward the real root: root >= r + 1/2  iff  2^n * p >= (2r+1)^n
    return r + 1 if (2 ** n) * p >= (2 * r + 1) ** n else r


def _geometric_uppers(lo: int, hi: int, n: int) -> Tuple[int, ...]:
    """``n`` edges spaced by a constant ratio from ``lo`` to ``hi``.

    Each interior edge is the nearest integer to ``(lo^(n-k) * hi^k)^(1/n)``
    computed in exact integer arithmetic — identical on every host, so SPMD
    programs that each build their own :class:`SpecializationTable` from the
    same spec are guaranteed to dispatch any in-range env to the same bucket
    (a float-pow formulation can round an edge differently across machines
    and silently split replicas across buckets).

    Degenerate ranges / counts collapse buckets rather than erroring:
    edges that round onto a previous edge are dropped.
    """
    lo = max(lo, 1)
    if n <= 1 or hi <= lo:
        return (hi,)
    uppers: List[int] = []
    prev = lo - 1
    for k in range(1, n):
        u = _nearest_nth_root(lo ** (n - k) * hi ** k, n)
        if u <= prev or u >= hi:
            continue
        uppers.append(u)
        prev = u
    uppers.append(hi)
    return tuple(uppers)


def _dim_buckets(name: str, iv: Interval,
                 spec: Union[None, int, Sequence[int]],
                 default_n: int) -> DimBuckets:
    lo = 1 if iv.lo is None else iv.lo
    if spec is None:                       # un-bucketed dim: one bucket
        return DimBuckets(name, lo, (iv.hi,))
    if isinstance(spec, bool):
        raise TypeError(f"buckets[{name!r}] must be an int count or a "
                        f"sequence of edges, got {spec!r}")
    if isinstance(spec, int):
        if spec < 1:
            raise ValueError(f"buckets[{name!r}] must be >= 1, got {spec}")
        if iv.hi is None:
            raise ValueError(
                f"dim {name!r} has no declared upper bound; geometric "
                f"bucketing needs one — pass explicit edges instead")
        return DimBuckets(name, lo, _geometric_uppers(lo, iv.hi, spec))
    # explicit interior cut points; the final bucket runs to the declared hi
    edges = sorted(int(e) for e in spec)
    if any(e < lo for e in edges):
        raise ValueError(f"buckets[{name!r}]: edge below declared lo={lo}")
    if iv.hi is not None:
        edges = [e for e in edges if e < iv.hi]
    uppers = tuple(dict.fromkeys(edges)) + (iv.hi,)
    return DimBuckets(name, lo, uppers)


def build_bucket_space(declared_ranges: Mapping[str, Interval],
                       spec: BucketsSpec, *,
                       default_n: int = DEFAULT_BUCKETS_PER_DIM) -> BucketSpace:
    """Build the partition from declared dim ranges and a ``buckets=`` spec.

    ``spec`` forms:

    * ``True`` or ``"geometric"`` — every dim with a declared upper bound
      gets ``default_n`` geometric buckets; unbounded dims keep one bucket;
    * an ``int`` — geometric with that count per bounded dim;
    * a mapping ``{dim: count | [edges...]}`` — per-dim control; edges are
      interior cut points (the final bucket runs to the declared upper
      bound); dims absent from the mapping keep one bucket.
    """
    if not declared_ranges:
        raise ValueError(
            "buckets requires declared dim ranges — pass "
            "optimize(..., dynamic_dims={...}) alongside buckets=...")
    per_dim: Dict[str, Union[None, int, Sequence[int]]] = {}
    if spec is True or spec == "geometric":
        per_dim = {name: default_n if iv.hi is not None else None
                   for name, iv in declared_ranges.items()}
    elif isinstance(spec, bool):           # False slipped through
        raise ValueError("buckets=False is not a partition; omit the arg")
    elif isinstance(spec, int):
        per_dim = {name: spec if iv.hi is not None else None
                   for name, iv in declared_ranges.items()}
    elif isinstance(spec, Mapping):
        unknown = sorted(set(spec) - set(declared_ranges))
        if unknown:
            raise ValueError(
                f"buckets names {unknown} carry no declared range "
                f"(declared: {sorted(declared_ranges)})")
        per_dim = {name: spec.get(name) for name in declared_ranges}
    else:
        raise TypeError(f"unrecognized buckets spec {spec!r}")
    dims = tuple(_dim_buckets(name, declared_ranges[name], per_dim[name],
                              default_n)
                 for name in sorted(declared_ranges))
    space = BucketSpace(dims)
    if space.n_buckets <= 1:
        raise ValueError(
            "buckets spec produced a single bucket — the partition would "
            "only duplicate the whole-range plan; widen the spec or drop it")
    return space
