"""Plan-aware observability: compile tracing, runtime telemetry, exports.

Port of ``repro/core/obs``.  Three coordinated layers over the
symbolic-shape pipeline:

* :mod:`.trace` — hierarchical compile-phase spans + a structured
  decision log, recorded by ``optimize`` and every bucket specialization
  (background compiles included, on their own track);
* :mod:`.telemetry` — a fixed-capacity per-call ring buffer behind a
  single disabled-path attribute check (the ≤2% overhead contract), plus
  exact per-instruction memory timelines reconstructed off the hot path
  (:mod:`.timeline`: the plan's symbolic events replayed at one env and
  diffed against the plan's predicted occupancy);
* :mod:`.export` / :mod:`.explain` — Chrome-trace/Perfetto JSON,
  Prometheus text metrics, and the human-readable
  ``DynamicShapeFunction.explain()`` report.
"""
from .explain import build_explain
from .export import chrome_trace, chrome_trace_json, prometheus_text
from .telemetry import (AdmissionEvent, CallRecord, Telemetry,
                        TelemetryRing)
from .timeline import (Timeline, TimelineDiff, TimelinePoint,
                       actual_timeline, diff_timeline, planned_timeline)
from .trace import (NULL_TRACER, Decision, DecisionLog, NullTracer, Span,
                    Tracer)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Span",
    "Decision", "DecisionLog",
    "Telemetry", "TelemetryRing", "CallRecord", "AdmissionEvent",
    "Timeline", "TimelinePoint", "TimelineDiff",
    "actual_timeline", "planned_timeline", "diff_timeline",
    "chrome_trace", "chrome_trace_json", "prometheus_text",
    "build_explain",
]
