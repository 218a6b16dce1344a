"""``DynamicShapeFunction.explain()`` — the human-readable compile report.

Port of ``repro/core/obs/explain.py``.  Renders everything the pipeline
decided for one compiled function:

* the phase span tree (durations + structured attributes) recorded by the
  :class:`.trace.Tracer` during ``optimize`` and every bucket compile;
* the decision log (schedule guard, exchange swaps, bucket reuse, frozen
  remat methods, slot packing, kernel selection);
* per-slot symbolic sizes + the liveness intervals packed into each slot
  (derived from the finished
  :class:`~repro_torch.core.memplan.assign.ArenaPlan` — the plan *is* the
  record, nothing is duplicated at plan time);
* frozen-vs-runtime remat decisions per candidate;
* the kernel variant selected per kernel node, per plan;
* the bucket dispatch table (per-bucket hits/misses/bounds);
* reserved-cap vs measured size per value-dependent bounded dim;
* optionally, the plan-vs-actual memory timeline diff at one env.

Plain functions over the public objects: nothing here is needed to run a
plan, so importing stays cheap and the report can never drift from the
artifacts it reads.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from .trace import Span


def _fmt_bytes(b: Optional[int]) -> str:
    if b is None:
        return "unbounded"
    if b >= 1 << 20:
        return f"{b / (1 << 20):.2f} MiB"
    if b >= 1 << 10:
        return f"{b / (1 << 10):.1f} KiB"
    return f"{b} B"


def _fmt_attrs(attrs: Dict[str, Any]) -> str:
    parts = []
    for k, v in attrs.items():
        if isinstance(v, dict):
            if not v:
                continue
            v = "{" + ", ".join(f"{kk}: {vv}" for kk, vv in v.items()) + "}"
        parts.append(f"{k}={v}")
    return " ".join(parts)


def _render_span(span: Span, lines: List[str], depth: int) -> None:
    pad = "  " * depth
    attrs = _fmt_attrs(span.attrs)
    lines.append(f"{pad}{span.name:<12} {span.duration_ns / 1e6:8.2f} ms"
                 f"{'  ' + attrs if attrs else ''}")
    for c in span.children:
        _render_span(c, lines, depth + 1)


def render_spans(tracer) -> List[str]:
    """The compile span forest, one indented line per span."""
    lines: List[str] = []
    for root in getattr(tracer, "roots", []):
        _render_span(root, lines, 0)
    return lines


def render_decisions(decisions, limit: int = 40) -> List[str]:
    entries = decisions.entries()
    lines: List[str] = []
    for d in entries[:limit]:
        detail = _fmt_attrs(d.detail)
        lines.append(f"[{d.kind}] {d.subject}: {d.choice} — {d.why}"
                     f"{'  (' + detail + ')' if detail else ''}")
    if len(entries) > limit:
        lines.append(f"... {len(entries) - limit} more "
                     f"(DynamicShapeFunction.decisions.entries())")
    return lines


def render_slots(arena_plan) -> List[str]:
    """Per-slot symbolic sizes + the liveness intervals packed into each."""
    lines: List[str] = []
    lines.append(
        f"arena bound {_fmt_bytes(arena_plan.arena_bound_bytes)} | "
        f"{arena_plan.n_slots} arena slots | reuse: "
        f"{arena_plan.n_provable_reuses} provable + "
        f"{arena_plan.n_checked_reuses} checked + "
        f"{arena_plan.n_donated_reuses} donated")
    liveness = arena_plan.liveness
    for s in arena_plan.slots:
        kind = "external" if s.external else "arena"
        hi = f" <= {_fmt_bytes(s.size_hi)}" if s.size_hi is not None else ""
        lines.append(f"slot {s.sid:>3} [{kind:>8}] size={s.size_expr}{hi}")
        for vid in s.members:
            iv = liveness.get(vid)
            asg = arena_plan.assignment.get(vid)
            tags = []
            if asg is not None and asg.reused:
                tags.append("provable" if asg.provable else "checked")
                if asg.donated:
                    tags.append("donated")
            span = f"[{iv.start}, {iv.end}]" if iv is not None else "[?]"
            size = str(iv.nbytes_expr) if iv is not None else "?"
            lines.append(f"    %{vid:<5} live {span:<12} {size}"
                         f"{'  (' + ', '.join(tags) + ')' if tags else ''}")
    return lines


def render_remat(plan) -> List[str]:
    """Frozen-vs-runtime regeneration decision per remat candidate."""
    lines: List[str] = []
    if not plan.candidates:
        return ["no remat candidates"]
    frozen = plan.static_methods
    lines.append(f"{len(plan.candidates)} candidates, "
                 f"{len(frozen)} frozen at compile time, "
                 f"{len(plan.candidates) - len(frozen)} decided at runtime")
    for vid, cand in sorted(plan.candidates.items()):
        method = frozen.get(vid)
        if method is not None:
            decided = f"frozen: {method}"
        else:
            decided = "runtime policy"
        notes = []
        if cand.recompute is not None:
            notes.append(f"recompute impact {cand.recompute.impact}")
        elif cand.recompute_pruned_by_bounds:
            notes.append("recompute pruned by interval bounds")
        else:
            notes.append("offload only")
        lines.append(f"  %{vid:<5} {decided:<18} "
                     f"bytes {cand.bytes_interval}  {'; '.join(notes)}")
    return lines


def render_kernel_selection(fn) -> List[str]:
    """Chosen kernel variant per node, per plan (whole-range + buckets).

    Each line shows the variant the Hopper cost model baked into that
    plan's ``Compute`` (the op's ``impl``), the modeled speedup over the
    default variant at the plan's probe corners, and the variants ruled
    out at the range's hi corner with the reason; ``[measured]`` marks a
    choice re-selected from measured timings (the measured fallback)."""
    def _plan_lines(label: str, plan) -> List[str]:
        ls: List[str] = []
        for nid, sel in sorted(plan.kernel_selections.items()):
            tags = []
            if sel.measured:
                tags.append("measured")
            if not sel.is_default:
                tags.append(f"model x{sel.model_speedup:.2f} vs default")
            ls.append(
                f"  {label} %{nid} {sel.prim_name}: {sel.variant.name}  "
                f"{sel.describe_bounds()}"
                f"{'  [' + ', '.join(tags) + ']' if tags else ''}")
            if sel.invalid:
                ls.append("      ruled out: " + "; ".join(
                    f"{name} ({why})" for name, why in sel.invalid.items()))
        return ls

    lines = _plan_lines("whole-range", fn.plan)
    table = fn.specialization_table
    if table is not None:
        for key in table.compiled_keys:
            bp = table.peek(key)
            if bp is not None and bp.plan is not fn.plan:
                lines.extend(_plan_lines(f"bucket {key}", bp.plan))
    return lines or ["(no selectable kernels in this graph)"]


def render_resilience(fn) -> List[str]:
    """The resilience section.  The port has no degradation ladder yet, so
    it says so, then the compile breaker's quarantine state (the bucket
    table has its breaker)."""
    lines = ["not enabled (no degradation ladder in this port yet)"]
    table = fn.specialization_table
    if table is not None:
        q = table.quarantined()
        if q:
            for key in q:
                lines.append(
                    f"  quarantined bucket {key}: "
                    f"{table.breaker.state(key)}, re-probe in "
                    f"{table.breaker.retry_in_s(key):.3f}s "
                    f"({table.breaker.cause(key)!r})")
        else:
            lines.append("  no buckets quarantined")
    return lines


def render_buckets(table) -> List[str]:
    st = table.stats()
    lines = [f"{table.n_buckets} buckets | hits {st['hits']} | "
             f"misses {st['misses']} | specializations "
             f"{st['specialize_count']} | evictions {st['evictions']} | "
             f"resident {st['resident']}"]
    for key, row in table.per_bucket_stats().items():
        lines.append(
            f"  bucket {key}: hits={row['hits']} misses={row['misses']} "
            f"arena_bound={_fmt_bytes(row['arena_bound_bytes'])}"
            f"{' [resident]' if row['resident'] else ''}")
    return lines


def render_bound_dims(fn, env: Optional[Dict[str, int]] = None) -> List[str]:
    """Reserved-cap vs measured-size per value-dependent bounded dim.

    Planning reserved every dependent slot at the cap expression; a call
    measures the actual extent at its BindDim step.  With an ``env`` the
    cap is evaluated concretely, and — when the env carries a measured
    value for the dim (e.g. ``RunReport.env`` from a finished call) — the
    reserved-vs-measured byte ratio per dependent register is shown."""
    from ..ir.dynamism import complete_bound_env

    g = fn.plan.graph
    lines: List[str] = []
    cap_env = None
    if env is not None:
        # caps evaluate over base dims only: strip any measured values
        base = {k: v for k, v in env.items() if k not in g.bound_dims}
        cap_env = complete_bound_env(g, base)
    for name, cap in g.bound_dims.items():
        line = f"{name} <= {cap}"
        if cap_env is not None:
            line += f" = {cap_env[name]}"
            measured = env.get(name)
            if measured is not None:
                line += f"  measured {measured}"
        lines.append(line)
        prog = fn.program
        if prog is None or cap_env is None:
            continue
        for r in prog.bound_dep_regs.get(name, ()):
            expr = prog.nbytes_exprs[r]
            reserved = expr.evaluate(cap_env)
            slot_line = (f"    %{prog.vid_of[r]:<5} reserved "
                         f"{_fmt_bytes(reserved)}")
            if env.get(name) is not None:
                tight = expr.evaluate({**cap_env, name: env[name]})
                slot_line += f"  measured {_fmt_bytes(tight)}"
            lines.append(slot_line)
    return lines


def build_explain(fn, env: Optional[Dict[str, int]] = None) -> str:
    """Assemble the full report for a ``DynamicShapeFunction``."""
    rep = fn.report
    out: List[str] = []
    out.append("=" * 72)
    out.append("DynamicShapeFunction.explain()")
    out.append("=" * 72)
    out.append(
        f"nodes={len(fn.plan.graph.nodes)} "
        f"candidates={rep.n_candidates} "
        f"scheduled_order={'kept' if rep.used_scheduled_order else 'reverted'} "
        f"peak_bound={_fmt_bytes(rep.peak_bound_bytes)} "
        f"arena_bound={_fmt_bytes(rep.arena_bound_bytes)}")

    out.append("")
    out.append("-- compile phases " + "-" * 54)
    out.extend(render_spans(fn.trace) or ["(no spans recorded)"])

    out.append("")
    out.append("-- decisions " + "-" * 59)
    out.extend(render_decisions(fn.decisions) or ["(none recorded)"])

    if fn.plan.arena_plan is not None:
        out.append("")
        out.append("-- arena slots " + "-" * 57)
        out.extend(render_slots(fn.plan.arena_plan))

    out.append("")
    out.append("-- rematerialization " + "-" * 51)
    out.extend(render_remat(fn.plan))

    if fn.plan.kernel_selections:
        out.append("")
        out.append("-- kernel selection " + "-" * 52)
        out.extend(render_kernel_selection(fn))

    bound_dims = fn.plan.graph.bound_dims
    if bound_dims:
        out.append("")
        out.append("-- value-dependent bounded dims " + "-" * 40)
        out.extend(render_bound_dims(fn, env))

    table = fn.specialization_table
    if table is not None:
        out.append("")
        out.append("-- bucket dispatch " + "-" * 53)
        out.extend(render_buckets(table))

    out.append("")
    out.append("-- resilience " + "-" * 58)
    out.extend(render_resilience(fn))

    if env is not None and fn.program is not None:
        out.append("")
        out.append("-- plan vs actual @ env " + "-" * 48)
        diff = fn.memory_timeline(env)
        out.append(diff.summary())
        status = "OK" if diff.ok else "DRIFT"
        out.append(f"verdict: {status} ({len(diff.unexplained)} unexplained "
                   f"allocations)")

    tel = fn.telemetry
    if tel is not None:
        out.append("")
        out.append("-- runtime telemetry " + "-" * 51)
        for k, v in tel.summary().items():
            out.append(f"{k}: {v}")

    return "\n".join(out)
