"""The global symbolic shape graph (paper §2.1) + declared dim ranges.

Collects algebraic relationships between symbolic dimensions — e.g.
``@S0 = 12 * @S1`` derived from a ``DynamicReshapeOp`` — and uses them to
*canonicalize* ``SymbolicExpr``s so that expressions written over different
symbol sets become comparable.  Comparison is layered:

1. canonicalize the difference polynomial and decide by its constant value
   when it is constant;
2. otherwise fall back to **interval bounds**: every symbolic dim carries a
   declared range (``declare_range``; default ``[1, +inf)``), the difference
   is evaluated in interval arithmetic, and interval separation decides.

Layer 2 is what bounded dynamic shapes buy us (torch_xla-style ``<=N``
dims): with ranges declared, many previously "incomparable" scheduling and
remat decisions resolve at compile time, and peak memory gets a guaranteed
worst-case bound.  ``cmp_stats`` records which layer resolved each query so
benchmarks can report the interval layer's contribution.

Every query is **memoized**.  Interned expression ``uid``s key three memo
tables (canonicalize / compare / interval_of); each entry records which
dim ranges its answer depended on and at what *range generation*, so a
later ``declare_range`` invalidates exactly the entries it can affect.
``specialized()`` (bucketed compilation) hands the child graph every
parent verdict that *narrowing cannot flip*: constant-layer verdicts are
range-independent, strict interval verdicts (LT/GT) only get more
separated as intervals shrink, and any verdict whose dims were not
narrowed is untouched.  ``cmp_stats`` carries ``cache_hit``/``cache_miss``
counters (and ``inherited``, the verdict count carried over at
specialization) next to the per-layer resolution counts.
"""
from __future__ import annotations

import enum
from contextlib import contextmanager
from typing import Dict, Iterable, Mapping, Optional, Set, Tuple

from .expr import Atom, AtomT, ExprLike, SymbolicExpr
from .intervals import BoundEnv, Interval, RangeLike, as_interval


class Cmp(enum.Enum):
    LT = "LT"
    LE = "LE"
    EQ = "EQ"
    GE = "GE"
    GT = "GT"
    UNKNOWN = "UNKNOWN"


# verdicts that remain exact under any narrowing of the declared ranges:
# constant-layer verdicts never consult ranges, and strict interval
# separation (lo > 0 / hi < 0) only strengthens as intervals shrink.
_STRICT = (Cmp.LT, Cmp.GT)

CmpKey = Tuple[int, int]           # (lhs uid, rhs uid) of a compare query


class _CmpEntry:
    """Memoized compare verdict + what it depended on.

    ``operands`` pins the queried expressions: memo keys are interned
    ``uid``s, and holding the exprs keeps the interned instances (and so
    the uid ↔ structure binding) alive for as long as the entry is."""

    __slots__ = ("verdict", "layer", "diff", "deps", "dep_gens", "subst_gen",
                 "gen_total", "operands")

    def __init__(self, verdict: Cmp, layer: str, diff: SymbolicExpr,
                 deps: frozenset, dep_gens: Tuple[int, ...], subst_gen: int,
                 gen_total: int = 0,
                 operands: Tuple[SymbolicExpr, ...] = ()):
        self.verdict = verdict
        self.layer = layer          # 'const' | 'interval' | 'unknown'
        self.diff = diff            # canonical difference polynomial
        self.deps = deps            # dim names the verdict consulted
        self.dep_gens = dep_gens    # their range generations at compute time
        self.subst_gen = subst_gen
        self.gen_total = gen_total  # global range gen at compute time
        self.operands = operands


class _IvlEntry:
    __slots__ = ("interval", "deps", "dep_gens", "subst_gen", "gen_total",
                 "expr")

    def __init__(self, interval: Interval, deps: frozenset,
                 dep_gens: Tuple[int, ...], subst_gen: int,
                 gen_total: int = 0, expr: Optional[SymbolicExpr] = None):
        self.interval = interval
        self.deps = deps
        self.dep_gens = dep_gens
        self.subst_gen = subst_gen
        self.gen_total = gen_total  # global range gen at compute time
        self.expr = expr            # pins the keyed interned expression


class ShapeGraph:
    """Equalities between symbolic dims + declared ranges, with rewriting.

    ``add_equality(sym, expr)`` records ``sym == expr`` (the paper's
    ``@S0 = Mul @C12, @S1``).  Internally we keep a substitution map toward
    "root" symbols and apply it to fixpoint during canonicalization.
    ``declare_range(sym, lo, hi)`` records ``lo <= sym <= hi`` for the
    interval fallback.
    """

    def __init__(self) -> None:
        self._subst: Dict[AtomT, SymbolicExpr] = {}
        self._bounds = BoundEnv(default_lo=1)  # dynamic dims come from data
        # value-dependent bounded symbols: name -> symbolic cap expression
        # (insertion-ordered; chained caps may reference earlier entries)
        self._bound_caps: Dict[str, SymbolicExpr] = {}
        # how comparisons were resolved: constant difference, interval
        # separation, or not at all — consumed by benchmarks/symbolic_coverage
        # — plus the memo table's hit/miss counters and the number of
        # verdicts inherited from a parent graph at specialization time
        self.cmp_stats: Dict[str, int] = {
            "const": 0, "interval": 0, "unknown": 0,
            "cache_hit": 0, "cache_miss": 0, "inherited": 0,
        }
        # -- memo state -------------------------------------------------------
        self._subst_gen = 0                       # bumped by add_equality
        self._range_gen: Dict[str, int] = {}      # bumped by declare_range
        self._range_gen_total = 0                 # bumped by any declare_range
        # uid -> (original, canonical); the original pins the interned key
        self._canon_memo: Dict[int, Tuple[SymbolicExpr, SymbolicExpr]] = {}
        self._cmp_memo: Dict[CmpKey, _CmpEntry] = {}
        self._ivl_memo: Dict[int, _IvlEntry] = {}
        self._record: Optional[Set[CmpKey]] = None

    # -- building -------------------------------------------------------------
    def add_equality(self, sym: "AtomT | str", expr: ExprLike) -> None:
        if isinstance(sym, str):
            sym = Atom(sym)
        expr = SymbolicExpr.wrap(expr)
        # avoid trivial/cyclic rules
        if expr.atoms() == frozenset({sym}):
            return
        if sym in self._subst and self._subst[sym] == expr:
            return
        # normalize the rhs through existing rules before storing
        expr = self._apply(expr)
        if SymbolicExpr.from_atom(sym) == expr:
            return
        self._subst[sym] = expr
        # the rewrite system changed: every canonical form is suspect —
        # drop the memo *before* re-normalizing (which calls _apply)
        self._subst_gen += 1
        self._canon_memo.clear()
        # re-normalize existing rules so chains collapse eagerly
        for k in list(self._subst):
            if k != sym:
                self._subst[k] = self._apply(self._subst[k])
        self._canon_memo.clear()   # entries cached mid-renormalization

    def declare_range(self, sym: "Atom | str", lo: Optional[int] = None,
                      hi: Optional[int] = None) -> None:
        """Declare ``lo <= sym <= hi`` (either side may stay unbounded)."""
        name = sym.name if isinstance(sym, Atom) else str(sym)
        prev = self._bounds.lookup(name)
        lo = prev.lo if lo is None else int(lo)
        hi = prev.hi if hi is None else int(hi)
        if lo is not None and lo < 0:
            raise ValueError(f"dim {name!r} cannot be negative (lo={lo})")
        self._bounds.declare(name, Interval(lo, hi))
        # lazily invalidate memo entries that consulted this dim's range
        self._range_gen[name] = self._range_gen.get(name, 0) + 1
        self._range_gen_total += 1

    # backwards-compatible alias used by earlier code/tests
    def set_bounds(self, sym: "Atom | str", lo: Optional[int] = None,
                   hi: Optional[int] = None) -> None:
        self.declare_range(sym, lo, hi)

    def declare_bound(self, sym: "Atom | str", cap: ExprLike) -> None:
        """Declare a value-dependent bounded symbol: ``0 <= sym <= cap``.

        ``cap`` is a symbolic expression over input dims (or earlier
        bounded symbols).  The symbol's range is derived *through* the
        cap's interval under the current declared ranges, so
        ``compare``/``interval_of``/``bounds_of`` answer without any
        user-declared range for the symbol itself.  Re-declaring (e.g.
        under a narrowed ``specialized`` graph) only tightens: the upper
        end meets the previous declaration.  ``lo`` is 0, not the
        ``BoundEnv`` default of 1 — a measured extent can be empty.
        """
        name = sym.name if isinstance(sym, Atom) else str(sym)
        cap = SymbolicExpr.wrap(cap)
        self._bound_caps[name] = cap
        hi = self.interval_of(cap).hi
        prev = self._bounds.lookup(name)
        if prev.hi is not None and (hi is None or prev.hi < hi):
            hi = prev.hi
        self._bounds.declare(name, Interval(0, hi))
        self._range_gen[name] = self._range_gen.get(name, 0) + 1
        self._range_gen_total += 1

    @property
    def bound_caps(self) -> Mapping[str, SymbolicExpr]:
        return dict(self._bound_caps)

    @property
    def declared_ranges(self) -> Mapping[str, Interval]:
        return self._bounds.declared()

    def bound_env(self) -> BoundEnv:
        return self._bounds

    # -- memo plumbing ---------------------------------------------------------
    def _gens_of(self, deps: frozenset) -> Tuple[int, ...]:
        return tuple(self._range_gen.get(n, 0) for n in sorted(deps))

    def _entry_valid(self, ent) -> bool:
        if ent.subst_gen != self._subst_gen:
            return False
        # fast path: no declare_range at all since the entry was stored
        if ent.gen_total == self._range_gen_total:
            return True
        return ent.dep_gens == self._gens_of(ent.deps)

    @contextmanager
    def record_cmp_keys(self):
        """Record the ``(lhs uid, rhs uid)`` key of every ``compare`` inside
        the block (memo hits included).  The compile pipeline wraps its
        scheduling + remat phases in this to learn which verdicts those
        decisions stood on — the incremental-reuse check re-validates
        exactly that set under a narrowed graph.  Nests: an inner block
        records its own set and merges it into the outer one on exit (the
        remat search records per-candidate inside the pipeline's span)."""
        prev, keys = self._record, set()
        self._record = keys
        try:
            yield keys
        finally:
            self._record = prev
            if prev is not None:
                prev |= keys

    def note_cmp_keys(self, keys: Iterable[CmpKey]) -> None:
        """Merge ``keys`` into the active recording (no-op otherwise).

        Callers that answer a comparison-derived decision from their own
        memo (e.g. the remat search's pick memo) replay the compare keys
        the original computation consulted, so dependency recording stays
        complete even when the underlying ``compare`` calls are skipped."""
        if self._record is not None:
            self._record |= set(keys)

    # -- canonicalization -------------------------------------------------------
    def _apply(self, e: SymbolicExpr, max_iter: int = 16) -> SymbolicExpr:
        if not self._subst:
            return e
        hit = self._canon_memo.get(e.uid)
        if hit is not None:
            return hit[1]
        orig = e
        for _ in range(max_iter):
            new = e.substitute(self._subst)
            if new is e or new == e:
                break
            e = new
        self._canon_memo[orig.uid] = (orig, e)
        return e

    def canonicalize(self, e: ExprLike) -> SymbolicExpr:
        return self._apply(SymbolicExpr.wrap(e))

    # -- bounds ------------------------------------------------------------------
    def interval_of(self, e: ExprLike) -> Interval:
        """Sound integer interval of ``e`` under equalities + declared ranges."""
        e = SymbolicExpr.wrap(e)
        ent = self._ivl_memo.get(e.uid)
        if ent is not None and self._entry_valid(ent):
            return ent.interval
        c = self.canonicalize(e)
        iv = c.interval(self._bounds)
        deps = c.free_vars()
        self._ivl_memo[e.uid] = _IvlEntry(iv, deps, self._gens_of(deps),
                                          self._subst_gen,
                                          gen_total=self._range_gen_total,
                                          expr=e)
        return iv

    def bounds_of(self, e: ExprLike) -> Tuple[Optional[int], Optional[int]]:
        iv = self.interval_of(e)
        return iv.lo, iv.hi

    # -- comparison ---------------------------------------------------------------
    def _decide(self, d: SymbolicExpr) -> Tuple[Cmp, str, frozenset]:
        """(verdict, layer, range deps) of a canonical difference ``d``."""
        c = d.constant_value()
        if c is not None:
            if c == 0:
                return Cmp.EQ, "const", frozenset()
            return (Cmp.GT if c > 0 else Cmp.LT), "const", frozenset()
        deps = d.free_vars()
        iv = d.interval(self._bounds)
        lo, hi = iv.lo, iv.hi
        if lo is not None and lo > 0:
            return Cmp.GT, "interval", deps
        if hi is not None and hi < 0:
            return Cmp.LT, "interval", deps
        if lo is not None and lo >= 0:
            return Cmp.GE, "interval", deps
        if hi is not None and hi <= 0:
            return Cmp.LE, "interval", deps
        return Cmp.UNKNOWN, "unknown", deps

    def compare(self, e1: ExprLike, e2: ExprLike) -> Cmp:
        """Best-effort comparison of two SymbolicExprs (paper §2.1/2.2)."""
        a, b = SymbolicExpr.wrap(e1), SymbolicExpr.wrap(e2)
        key = (a.uid, b.uid)
        if self._record is not None:
            self._record.add(key)
        ent = self._cmp_memo.get(key)
        if ent is not None and self._entry_valid(ent):
            self.cmp_stats["cache_hit"] += 1
            self.cmp_stats[ent.layer] += 1
            return ent.verdict
        self.cmp_stats["cache_miss"] += 1
        d = self.canonicalize(a - b)
        verdict, layer, deps = self._decide(d)
        self.cmp_stats[layer] += 1
        self._cmp_memo[key] = _CmpEntry(verdict, layer, d, deps,
                                        self._gens_of(deps), self._subst_gen,
                                        gen_total=self._range_gen_total,
                                        operands=(a, b))
        return verdict

    def definitely_le(self, e1: ExprLike, e2: ExprLike) -> bool:
        return self.compare(e1, e2) in (Cmp.LT, Cmp.LE, Cmp.EQ)

    def definitely_lt(self, e1: ExprLike, e2: ExprLike) -> bool:
        return self.compare(e1, e2) is Cmp.LT

    def definitely_nonpositive(self, e: ExprLike) -> bool:
        return self.compare(e, 0) in (Cmp.LT, Cmp.LE, Cmp.EQ)

    def definitely_negative(self, e: ExprLike) -> bool:
        return self.compare(e, 0) is Cmp.LT

    # -- specialization ---------------------------------------------------------
    def specialized(self, ranges: Mapping[str, RangeLike]) -> "ShapeGraph":
        """A copy with ``ranges`` *narrowing* the declared dim ranges.

        Equalities and all declared ranges carry over; each dim named in
        ``ranges`` is met (intersected) with its existing declaration, so
        the result never widens what the original graph promised.  This is
        what bucketed plan specialization runs the compile-time pipeline
        under: a tighter ``BoundEnv`` resolves interval comparisons the
        whole-range graph could not.  ``cmp_stats`` start fresh so the
        specialized compile's resolution split is measurable on its own.

        The child inherits every memoized verdict that the narrowing
        provably cannot flip — constant-layer verdicts, strict interval
        verdicts (LT/GT), and anything whose dims were not narrowed —
        counted in the child's ``cmp_stats['inherited']``.
        """
        sub = ShapeGraph()
        sub._subst = dict(self._subst)
        for name, iv in self.declared_ranges.items():
            sub._bounds.declare(name, iv)
        narrowed: Set[str] = set()
        for name, r in ranges.items():
            iv = as_interval(r) if isinstance(r, (Interval, int)) else \
                Interval(*r)
            prev = self._bounds.lookup(name)
            met = prev.meet(iv)
            if met.is_empty():
                raise ValueError(
                    f"specialized range {iv!r} for dim {name!r} does not "
                    f"intersect its declared range "
                    f"{self._bounds.lookup(name)!r}")
            sub._bounds.declare(name, met)
            if met != prev:
                narrowed.add(name)
        # re-derive bounded symbols through their caps under the narrowed
        # ranges (insertion order: chained caps reference earlier ones).
        # declare_bound only tightens, so a bound dim whose cap got
        # narrower joins the ``narrowed`` set for memo-inheritance checks.
        for name, cap in self._bound_caps.items():
            sub.declare_bound(name, cap)
            if sub._bounds.lookup(name) != self._bounds.lookup(name):
                narrowed.add(name)
        # canonical forms share the substitution map verbatim
        sub._canon_memo = dict(self._canon_memo)
        inherited = 0
        for key, ent in self._cmp_memo.items():
            if not self._entry_valid(ent):
                continue
            stable = ent.layer == "const" or \
                (ent.layer == "interval" and ent.verdict in _STRICT) or \
                not (ent.deps & narrowed)
            if stable:
                sub._cmp_memo[key] = _CmpEntry(
                    ent.verdict, ent.layer, ent.diff, ent.deps,
                    sub._gens_of(ent.deps), sub._subst_gen,
                    gen_total=sub._range_gen_total,
                    operands=ent.operands)
                inherited += 1
        for uid, ient in self._ivl_memo.items():
            if self._entry_valid(ient) and not (ient.deps & narrowed):
                sub._ivl_memo[uid] = _IvlEntry(
                    ient.interval, ient.deps, sub._gens_of(ient.deps),
                    sub._subst_gen, gen_total=sub._range_gen_total,
                    expr=ient.expr)
        sub.cmp_stats["inherited"] = inherited
        return sub

    def verdicts_match(self, parent: "ShapeGraph",
                       keys: Iterable[CmpKey]) -> bool:
        """Re-validate the parent's verdicts for ``keys`` under *this*
        (narrowed) graph: ``True`` iff every one is unchanged.

        The incremental compile path calls this on a ``specialized()``
        child with the compare keys the parent's scheduling + remat phases
        consulted — when nothing flipped, those phases would reproduce the
        same decisions verbatim, so their results can be reused.  Each key
        is answered through this graph's memo (inherited-stable verdicts
        are hits; flippable ones recompute from the stored canonical
        difference and are cached for the rest of the bucket's compile),
        with ``cmp_stats`` counted exactly as the equivalent fresh queries
        would be.  Returns on the first flipped verdict — keys after it are
        left for whichever phase actually queries them."""
        for key in keys:
            ent = parent._cmp_memo.get(key)
            if ent is None or not parent._entry_valid(ent):
                return False              # parent can't vouch: recompile
            mine = self._cmp_memo.get(key)
            if mine is not None and self._entry_valid(mine):
                self.cmp_stats["cache_hit"] += 1
                self.cmp_stats[mine.layer] += 1
                verdict = mine.verdict
            else:
                self.cmp_stats["cache_miss"] += 1
                verdict, layer, deps = self._decide(ent.diff)
                self.cmp_stats[layer] += 1
                self._cmp_memo[key] = _CmpEntry(
                    verdict, layer, ent.diff, deps, self._gens_of(deps),
                    self._subst_gen, gen_total=self._range_gen_total,
                    operands=ent.operands)
            if verdict is not ent.verdict:
                # first flip decides: later keys are (lazily) re-decided by
                # whichever phase actually queries them
                return False
        return True

    # -- introspection ---------------------------------------------------------
    @property
    def equalities(self) -> Mapping[AtomT, SymbolicExpr]:
        return dict(self._subst)

    def memo_sizes(self) -> Dict[str, int]:
        """Entry counts of the three memo tables (observability)."""
        return {"canon": len(self._canon_memo), "cmp": len(self._cmp_memo),
                "interval": len(self._ivl_memo)}

    def __repr__(self) -> str:  # pragma: no cover
        rules = ", ".join(f"{k!r}={v!r}" for k, v in self._subst.items())
        ranges = ", ".join(f"{k}∈{v!r}" for k, v in sorted(self.declared_ranges.items()))
        body = "; ".join(x for x in (rules, ranges) if x)
        return f"ShapeGraph({body})"
