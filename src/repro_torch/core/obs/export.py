"""Export surfaces: Chrome-trace JSON and Prometheus-style text metrics.

Port of ``repro/core/obs/export.py`` (it imports no framework).
``chrome_trace`` serializes a :class:`.trace.Tracer`'s span forest (plus,
optionally, sampled runtime timelines) into the Trace Event Format that
``chrome://tracing`` and Perfetto load directly: complete events
(``ph: "X"``) with microsecond timestamps, one track per recording thread
— so background-specialize compiles render alongside the main thread's
pipeline instead of interleaved with it.

``prometheus_text`` renders the text exposition format (``# HELP`` /
``# TYPE`` / samples) over a compiled function and/or a serve-path
``BucketBatcher`` — per-bucket hit/miss/admission-hold counters and
arena-bound gauges, ready for a ``/metrics`` endpoint.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .trace import Span


def _span_events(span: Span, pid: int, out: List[Dict[str, Any]]) -> None:
    out.append({
        "name": span.name,
        "ph": "X",
        "ts": span.t0_ns / 1e3,            # Trace Event ts unit: us
        "dur": span.duration_ns / 1e3,
        "pid": pid,
        "tid": span.tid,
        "args": {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                     else repr(v))
                 for k, v in span.attrs.items()},
    })
    for c in span.children:
        _span_events(c, pid, out)


def chrome_trace(tracer, timelines: Optional[List] = None,
                 pid: int = 1) -> Dict[str, Any]:
    """Trace Event Format dict for a Tracer (json.dump straight to disk).

    ``timelines``: optional ``(seq, Timeline)`` pairs (e.g.
    ``Telemetry.timelines``) appended as counter events (``ph: "C"``) so
    the memory curve renders under the compile spans."""
    events: List[Dict[str, Any]] = []
    thread_names: Dict[int, str] = {}
    for root in getattr(tracer, "roots", []):
        for s in root.walk():
            if s.tid not in thread_names and s.thread_name:
                thread_names[s.tid] = s.thread_name
        _span_events(root, pid, events)
    # thread metadata first, so viewers label tracks by thread name
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": name}} for tid, name in thread_names.items()]
    for seq, tl in (timelines or []):
        for pt in tl.points:
            events.append({
                "name": f"memory (call {seq})",
                "ph": "C",
                "ts": float(pt.idx),       # pseudo-time: program counter
                "pid": pid,
                "tid": 0,
                "args": {"device_used": pt.device_used,
                         "arena_in_use": pt.arena_in_use},
            })
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def chrome_trace_json(tracer, timelines: Optional[List] = None) -> str:
    return json.dumps(chrome_trace(tracer, timelines))


# -- Prometheus text exposition ------------------------------------------------

def _key_label(key) -> str:
    if key is None:
        return "whole_range"
    return "_".join(str(k) for k in key)


def _metric(lines: List[str], name: str, kind: str, help_text: str,
            samples: List) -> None:
    """Append one metric family; ``samples`` = [(labels_dict|None, value)]."""
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} {kind}")
    for labels, value in samples:
        if labels:
            lab = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
            lines.append(f"{name}{{{lab}}} {value}")
        else:
            lines.append(f"{name} {value}")


def prometheus_text(fn=None, batcher=None, prefix: str = "repro") -> str:
    """Text-format metrics snapshot for a compiled function and/or a
    serve-path batcher.  Safe to call concurrently with traffic (reads
    are snapshots under the table/batcher locks)."""
    lines: List[str] = []

    if fn is not None:
        table = fn.specialization_table
        if table is not None:
            st = table.stats()
            _metric(lines, f"{prefix}_bucket_hits_total", "counter",
                    "Dispatch hits per specialization bucket.",
                    [({"bucket": _key_label(k)}, row["hits"])
                     for k, row in table.per_bucket_stats().items()])
            _metric(lines, f"{prefix}_bucket_misses_total", "counter",
                    "Dispatch misses per specialization bucket.",
                    [({"bucket": _key_label(k)}, row["misses"])
                     for k, row in table.per_bucket_stats().items()])
            _metric(lines, f"{prefix}_bucket_arena_bound_bytes", "gauge",
                    "Guaranteed worst-case arena bytes per compiled bucket.",
                    [({"bucket": _key_label(k)}, row["arena_bound_bytes"])
                     for k, row in table.per_bucket_stats().items()
                     if row["arena_bound_bytes"] is not None])
            _metric(lines, f"{prefix}_specializations_total", "counter",
                    "Bucket pipeline compilations (incl. recompiles).",
                    [(None, st["specialize_count"])])
            _metric(lines, f"{prefix}_bucket_evictions_total", "counter",
                    "Bucket plans evicted by LRU retention.",
                    [(None, st["evictions"])])
        bound = fn.arena_bound_bytes
        if bound is not None:
            _metric(lines, f"{prefix}_arena_bound_bytes", "gauge",
                    "Whole-range guaranteed worst-case arena bytes.",
                    [(None, bound)])
        tel = fn.telemetry
        if tel is not None:
            _metric(lines, f"{prefix}_calls_total", "counter",
                    "Dispatched calls recorded by telemetry.",
                    [(None, tel.n_calls)])
            _metric(lines, f"{prefix}_dispatch_ns_total", "counter",
                    "Cumulative bucket-dispatch overhead in nanoseconds.",
                    [(None, tel.dispatch_ns_total)])
        # the degradation ladder's counters (resilience enabled)
        res = getattr(fn, "resilience", None)
        if res is not None:
            rc = res.counters()
            _metric(lines, f"{prefix}_degraded_calls_total", "counter",
                    "Calls that walked at least one degradation rung.",
                    [(None, rc["degraded_calls"])])
            _metric(lines, f"{prefix}_retries_total", "counter",
                    "Degradation-ladder retries by rung.",
                    [({"rung": "transient"}, rc["retries_transient"]),
                     ({"rung": "fallback"}, rc["retries_fallback"])])
            _metric(lines, f"{prefix}_request_failures_total", "counter",
                    "Requests rejected after exhausting the ladder.",
                    [(None, rc["failures"])])
            _metric(lines, f"{prefix}_malformed_requests_total", "counter",
                    "Requests rejected as malformed (never retried).",
                    [(None, rc["malformed"])])
        table = fn.specialization_table
        if table is not None:
            bs = table.breaker.stats()["by_state"]
            _metric(lines, f"{prefix}_quarantined_buckets", "gauge",
                    "Buckets currently quarantined by the compile breaker.",
                    [(None, bs.get("open", 0) + bs.get("half-open", 0))])

    if batcher is not None:
        _metric(lines, f"{prefix}_batcher_pending", "gauge",
                "Requests queued in the batcher.",
                [(None, batcher.pending())])
        _metric(lines, f"{prefix}_batcher_held_total", "counter",
                "Bucket groups held back by admission control.",
                [(None, batcher.held_count)])
        held_by = getattr(batcher, "held_by_key", None)
        if held_by:
            _metric(lines, f"{prefix}_batcher_held_by_bucket_total",
                    "counter", "Admission-control holds per bucket.",
                    [({"bucket": _key_label(k)}, v)
                     for k, v in held_by.items()])
        shed_by = getattr(batcher, "shed_by_outcome", None)
        if shed_by is not None:
            _metric(lines, f"{prefix}_batcher_shed_total", "counter",
                    "Requests shed by the batcher, by reason.",
                    [({"outcome": k}, v)
                     for k, v in sorted(shed_by.items())] or
                    [(None, 0)])
    return "\n".join(lines) + "\n"
