"""Integer interval arithmetic for symbolic-shape bounds analysis.

The paper's polynomial comparison (§2.1–2.2) frequently returns
"incomparable" because a difference polynomial has coefficients of mixed
sign.  Bounded dynamic shapes (torch_xla's ``<=N`` dims, SoD²/Tempo-style
value-range analysis) resolve many of those cases: once every symbolic dim
carries a declared range, every ``SymbolicExpr`` evaluates to a sound
``[lo, hi]`` integer interval, and interval separation decides the
comparison.

``Interval`` is a closed integer interval where ``lo is None`` means −∞ and
``hi is None`` means +∞.  All operations are *conservative*: the result
interval contains every value the operation can produce for operands drawn
from the input intervals.  floordiv / mod / max / min get exact rules (not
just corner products), matching the opaque ``OpAtom``s of ``expr.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple, Union

# Extended-integer helpers: values are int or None standing for an infinity.
# The direction of the infinity is carried by context (lo=None ⇒ −∞,
# hi=None ⇒ +∞), so arithmetic below is written per bound, not generically.


def _add(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None or b is None:
        return None
    return a + b


def _min2(a: Optional[int], b: Optional[int]) -> Optional[int]:
    """min for *lower* bounds (None = −∞ absorbs)."""
    if a is None or b is None:
        return None
    return min(a, b)


def _max2(a: Optional[int], b: Optional[int]) -> Optional[int]:
    """max for *upper* bounds (None = +∞ absorbs)."""
    if a is None or b is None:
        return None
    return max(a, b)


@dataclass(frozen=True)
class Interval:
    """Closed integer interval [lo, hi]; ``None`` = unbounded on that side."""

    lo: Optional[int] = None
    hi: Optional[int] = None

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def point(v: int) -> "Interval":
        return Interval(v, v)

    @staticmethod
    def top() -> "Interval":
        return Interval(None, None)

    @staticmethod
    def nonneg() -> "Interval":
        return Interval(0, None)

    # -- predicates -----------------------------------------------------------
    def is_point(self) -> bool:
        return self.lo is not None and self.lo == self.hi

    def contains(self, v: int) -> bool:
        if self.lo is not None and v < self.lo:
            return False
        if self.hi is not None and v > self.hi:
            return False
        return True

    def is_empty(self) -> bool:
        return self.lo is not None and self.hi is not None and self.lo > self.hi

    # -- lattice --------------------------------------------------------------
    def hull(self, other: "Interval") -> "Interval":
        """Smallest interval containing both (interval union hull)."""
        return Interval(_min2(self.lo, other.lo), _max2(self.hi, other.hi))

    def meet(self, other: "Interval") -> "Interval":
        """Intersection (may be empty)."""
        lo = other.lo if self.lo is None else (self.lo if other.lo is None else max(self.lo, other.lo))
        hi = other.hi if self.hi is None else (self.hi if other.hi is None else min(self.hi, other.hi))
        return Interval(lo, hi)

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, other: "IntervalLike") -> "Interval":
        other = as_interval(other)
        return Interval(_add(self.lo, other.lo), _add(self.hi, other.hi))

    def __neg__(self) -> "Interval":
        return Interval(None if self.hi is None else -self.hi,
                        None if self.lo is None else -self.lo)

    def __sub__(self, other: "IntervalLike") -> "Interval":
        return self + (-as_interval(other))

    def __mul__(self, other: "IntervalLike") -> "Interval":
        other = as_interval(other)
        # Corner products with infinity bookkeeping.  Each corner is a pair
        # (bound, sign-of-infinity); we fold them into (lo, hi) manually.
        corners = []
        for a, a_inf in ((self.lo, -1), (self.hi, +1)):
            for b, b_inf in ((other.lo, -1), (other.hi, +1)):
                if a is None and b is None:
                    corners.append((None, a_inf * b_inf))
                elif a is None:
                    if b == 0:
                        corners.append((0, 0))
                    else:
                        corners.append((None, a_inf * (1 if b > 0 else -1)))
                elif b is None:
                    if a == 0:
                        corners.append((0, 0))
                    else:
                        corners.append((None, b_inf * (1 if a > 0 else -1)))
                else:
                    corners.append((a * b, 0))
        lo: Optional[int] = None if any(v is None and s < 0 for v, s in corners) else \
            min(v for v, s in corners if v is not None)
        hi: Optional[int] = None if any(v is None and s > 0 for v, s in corners) else \
            max(v for v, s in corners if v is not None)
        # all-corners-infinite edge cases degrade to unbounded sides only
        finite = [v for v, _ in corners if v is not None]
        if not finite:
            return Interval(None, None)
        return Interval(lo, hi)

    def power(self, exp: int) -> "Interval":
        """Exact ``{x**exp : x in self}`` hull for a nonnegative int exponent.

        Computed from monotonicity (not repeated interval multiplication,
        which would treat the factors as independent and widen the result):
        odd powers are monotone; even powers are monotone in |x|.
        """
        if exp == 0:
            return Interval.point(1)
        if exp == 1:
            return self
        if exp % 2 == 1:
            return Interval(None if self.lo is None else self.lo ** exp,
                            None if self.hi is None else self.hi ** exp)
        # even: unbounded on either side means |x| is unbounded
        hi = None if (self.lo is None or self.hi is None) else \
            max(abs(self.lo), abs(self.hi)) ** exp
        if self.contains(0):
            lo = 0
        elif self.lo is not None and self.lo > 0:
            lo = self.lo ** exp
        else:  # entirely negative: nearest-to-zero corner is hi
            lo = self.hi ** exp
        return Interval(lo, hi)

    # -- the non-polynomial ops (exact rules for OpAtom) ----------------------
    def floordiv(self, other: "IntervalLike") -> "Interval":
        """Python floor division; exact over sign-constant denominator parts."""
        other = as_interval(other)
        pieces = []
        # positive denominator part [max(lo,1), hi]
        plo = 1 if other.lo is None else max(other.lo, 1)
        phi = other.hi
        if phi is None or phi >= plo:
            pieces.append(self._floordiv_signconst(Interval(plo, phi)))
        # negative denominator part [lo, min(hi,-1)]
        nhi = -1 if other.hi is None else min(other.hi, -1)
        nlo = other.lo
        if (nlo is None) or nlo <= nhi:
            pieces.append(self._floordiv_signconst(Interval(nlo, nhi)))
        if not pieces:  # denominator can only be 0 — undefined, stay sound
            return Interval.top()
        out = pieces[0]
        for p in pieces[1:]:
            out = out.hull(p)
        return out

    def _floordiv_signconst(self, d: "Interval") -> "Interval":
        """n // d where d's interval does not contain 0.

        x//d is monotone in the numerator and, for a fixed numerator,
        monotone in the denominator over a sign-constant range — so corner
        evaluation is exact.
        """
        corners = []
        unbounded_lo = unbounded_hi = False
        n_corners = [(self.lo, -1), (self.hi, +1)]
        d_corners = [(d.lo, -1), (d.hi, +1)]
        for n, n_inf in n_corners:
            for dd, d_inf in d_corners:
                if dd is not None and dd == 0:
                    continue
                if n is None and dd is None:
                    s = n_inf * d_inf
                    unbounded_lo |= s < 0
                    unbounded_hi |= s > 0
                elif n is None:
                    s = n_inf * (1 if dd > 0 else -1)
                    unbounded_lo |= s < 0
                    unbounded_hi |= s > 0
                elif dd is None:
                    # d at an infinite end: the quotient tends to 0 from
                    # above when n and d share a sign (floor 0), from below
                    # otherwise (floor −1).  d_inf > 0 iff this is the
                    # positive-denominator part's +∞ end.
                    if n == 0 or (n > 0) == (d_inf > 0):
                        corners.append(0)
                    else:
                        corners.append(-1)
                else:
                    corners.append(n // dd)
        lo = None if unbounded_lo else (min(corners) if corners else None)
        hi = None if unbounded_hi else (max(corners) if corners else None)
        return Interval(lo, hi)

    def mod(self, other: "IntervalLike") -> "Interval":
        """Python modulo (sign follows the denominator)."""
        other = as_interval(other)
        pieces = []
        # positive denominators: result in [0, d_hi - 1]
        plo = 1 if other.lo is None else max(other.lo, 1)
        phi = other.hi
        if phi is None or phi >= plo:
            if (phi is not None and plo == phi and self.lo is not None
                    and self.hi is not None and self.hi - self.lo < phi
                    and self.lo % phi <= self.hi % phi):
                # constant denominator + numerator within one residue window
                pieces.append(Interval(self.lo % phi, self.hi % phi))
            else:
                pieces.append(Interval(0, None if phi is None else phi - 1))
        # negative denominators: result in (d_lo, 0]
        nhi = -1 if other.hi is None else min(other.hi, -1)
        nlo = other.lo
        if (nlo is None) or nlo <= nhi:
            pieces.append(Interval(None if nlo is None else nlo + 1, 0))
        if not pieces:
            return Interval.top()
        out = pieces[0]
        for p in pieces[1:]:
            out = out.hull(p)
        return out

    def max_(self, other: "IntervalLike") -> "Interval":
        other = as_interval(other)
        lo = None if (self.lo is None and other.lo is None) else \
            max(x for x in (self.lo, other.lo) if x is not None)
        hi = _max2(self.hi, other.hi)
        return Interval(lo, hi)

    def min_(self, other: "IntervalLike") -> "Interval":
        other = as_interval(other)
        lo = _min2(self.lo, other.lo)
        hi = None if (self.hi is None and other.hi is None) else \
            min(x for x in (self.hi, other.hi) if x is not None)
        return Interval(lo, hi)

    # -- ordering between intervals (the Cmp fallback) ------------------------
    def definitely_lt(self, other: "IntervalLike") -> bool:
        other = as_interval(other)
        return self.hi is not None and other.lo is not None and self.hi < other.lo

    def definitely_le(self, other: "IntervalLike") -> bool:
        other = as_interval(other)
        return self.hi is not None and other.lo is not None and self.hi <= other.lo

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        lo = "-inf" if self.lo is None else str(self.lo)
        hi = "+inf" if self.hi is None else str(self.hi)
        return f"[{lo}, {hi}]"


IntervalLike = Union[int, Interval]


def as_interval(x: IntervalLike) -> Interval:
    if isinstance(x, Interval):
        return x
    if isinstance(x, int):
        return Interval.point(x)
    raise TypeError(f"cannot treat {type(x)} as Interval")


RangeLike = Union[Interval, Tuple[Optional[int], Optional[int]], int]


def _coerce_range(r: RangeLike) -> Interval:
    """Accept (lo, hi) tuples, Intervals, or a bare int upper bound."""
    if isinstance(r, Interval):
        return r
    if isinstance(r, int):
        # torch_xla-style "<=N": a bare int declares only the upper bound
        return Interval(1, r)
    lo, hi = r
    return Interval(None if lo is None else int(lo),
                    None if hi is None else int(hi))


class BoundEnv:
    """Per-dimension declared ranges backing ``SymbolicExpr.bounds``.

    Maps dim *names* to :class:`Interval`.  Unknown dims fall back to
    ``[default_lo, +inf)`` — tensor dims are at least ``default_lo``
    (1 by default: dynamic dims come from data).
    """

    def __init__(self, ranges: Optional[Mapping[str, RangeLike]] = None,
                 *, default_lo: int = 1):
        self._ranges: Dict[str, Interval] = {}
        self.default_lo = default_lo
        if ranges:
            for name, r in ranges.items():
                self.declare(name, _coerce_range(r))

    def declare(self, name: str, r: RangeLike) -> None:
        iv = _coerce_range(r)
        if iv.is_empty():
            raise ValueError(f"empty declared range for {name!r}: {iv}")
        self._ranges[name] = iv

    def lookup(self, name: str) -> Interval:
        iv = self._ranges.get(name)
        if iv is not None:
            return iv
        return Interval(self.default_lo, None)

    def declared(self) -> Mapping[str, Interval]:
        return dict(self._ranges)

    def __contains__(self, name: str) -> bool:
        return name in self._ranges

    def __repr__(self) -> str:  # pragma: no cover
        body = ", ".join(f"{k}={v!r}" for k, v in sorted(self._ranges.items()))
        return f"BoundEnv({body})"
