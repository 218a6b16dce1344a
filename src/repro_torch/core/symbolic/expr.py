"""SymbolicExpr: the algebraic representation of symbolic shape dimensions.

This is the paper's ``SymbolicExpr`` (§2.1): a canonical multivariate
polynomial over *atoms*.  An atom is either a plain symbolic dimension
(``@S0`` in the paper, a free variable such as a batch or sequence length)
or an *opaque* compound (floordiv / mod / max / min over sub-expressions)
which participates in the polynomial as an indivisible variable but can
still be evaluated numerically and bounded.

Representation: ``terms`` maps a *monomial* — a sorted tuple of
``(atom, exponent)`` pairs — to an integer coefficient.  The empty monomial
is the constant term.  This canonical form makes equality, addition and
multiplication exact, which is what the paper's comparisons build on.

Expressions are **hash-consed**: construction interns the canonical term
tuple in a weak table, so structurally-equal expressions are (almost
always) the *same* object, equality fast-paths on identity, the
structural hash is computed once, and every expression carries a stable
``uid`` that compile-path memo tables (``ShapeGraph``) key on.  The
common arithmetic cases — adding 0, multiplying by a constant, folding
constants — skip the general polynomial merge entirely.
"""
from __future__ import annotations

import itertools
import weakref
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Iterable, Mapping, Optional, Tuple, Union

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .intervals import BoundEnv, Interval

# declared ranges accepted by SymbolicExpr.interval / .bounds
BoundsLike = Union[None, "BoundEnv", Mapping[str, object]]

# ---------------------------------------------------------------------------
# Atoms
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Atom:
    """A symbolic dimension variable (paper's ``SymbolicDim``)."""

    name: str

    def evaluate(self, env: Mapping[str, int]) -> int:
        try:
            return int(env[self.name])
        except KeyError:
            raise KeyError(f"unbound symbolic dim {self.name!r}") from None

    def free_vars(self) -> frozenset:
        return frozenset({self.name})

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return self.name


@dataclass(frozen=True)
class OpAtom:
    """An opaque compound atom: floordiv/mod/max/min over SymbolicExprs.

    These arise from shape arithmetic that is not polynomial.  They are
    treated as indivisible variables by the polynomial algebra, remain
    evaluable, and expose conservative bounds.
    """

    op: str  # 'floordiv' | 'mod' | 'max' | 'min'
    operands: Tuple["SymbolicExpr", ...]

    def evaluate(self, env: Mapping[str, int]) -> int:
        vals = [x.evaluate(env) for x in self.operands]
        if self.op == "floordiv":
            return vals[0] // vals[1]
        if self.op == "mod":
            return vals[0] % vals[1]
        if self.op == "max":
            return max(vals)
        if self.op == "min":
            return min(vals)
        raise ValueError(f"unknown op atom {self.op}")

    def free_vars(self) -> frozenset:
        out: frozenset = frozenset()
        for x in self.operands:
            out |= x.free_vars()
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{self.op}({', '.join(map(repr, self.operands))})"


AtomT = Union[Atom, OpAtom]
Monomial = Tuple[Tuple[AtomT, int], ...]  # sorted by atom repr
_EMPTY: Monomial = ()


def _mono_key(item: Tuple[AtomT, int]) -> str:
    return repr(item[0])


def _mono_mul(a: Monomial, b: Monomial) -> Monomial:
    powers: Dict[AtomT, int] = {}
    for atom, exp in itertools.chain(a, b):
        powers[atom] = powers.get(atom, 0) + exp
    items = [(atom, exp) for atom, exp in powers.items() if exp != 0]
    items.sort(key=_mono_key)
    return tuple(items)


# ---------------------------------------------------------------------------
# SymbolicExpr
# ---------------------------------------------------------------------------


class SymbolicExpr:
    """Canonical integer polynomial over atoms.  Immutable, hash-consed."""

    __slots__ = ("terms", "_hash", "uid", "_atoms", "__weakref__")

    # canonical terms tuple -> the one live instance carrying it.  Weak so
    # transient compile-time expressions do not accumulate forever; memo
    # tables that key on ``uid`` hold strong refs to what they cache.
    _intern: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
    _uid_counter = itertools.count(1)
    # small-constant cache (strong refs: these recur constantly)
    _const_cache: Dict[int, "SymbolicExpr"] = {}

    def __new__(cls, terms: Mapping[Monomial, int]):
        clean = {m: c for m, c in terms.items() if c != 0}
        # sort monomials by (atom repr, exponent) pairs: exponents must
        # participate or `s` and `s^2` tie and the term order (hence the
        # canonical form) would depend on insertion order
        key = tuple(sorted(
            clean.items(),
            key=lambda kv: tuple((repr(a), e) for a, e in kv[0])))
        self = cls._intern.get(key)
        if self is not None:
            return self
        self = object.__new__(cls)
        self.terms = key
        self._hash = hash(key)
        self.uid = next(cls._uid_counter)
        self._atoms = None
        cls._intern[key] = self
        return self

    # -- constructors -------------------------------------------------------
    @staticmethod
    def constant(c: int) -> "SymbolicExpr":
        c = int(c)
        e = SymbolicExpr._const_cache.get(c)
        if e is None:
            e = SymbolicExpr({_EMPTY: c})
            if -4096 <= c <= 4096 or len(SymbolicExpr._const_cache) < 65536:
                SymbolicExpr._const_cache[c] = e
        return e

    @staticmethod
    def var(name: str) -> "SymbolicExpr":
        return SymbolicExpr({((Atom(name), 1),): 1})

    @staticmethod
    def from_atom(atom: AtomT) -> "SymbolicExpr":
        return SymbolicExpr({((atom, 1),): 1})

    @staticmethod
    def wrap(x: "ExprLike") -> "SymbolicExpr":
        if isinstance(x, SymbolicExpr):
            return x
        if isinstance(x, (int,)):
            return SymbolicExpr.constant(x)
        raise TypeError(f"cannot wrap {type(x)} as SymbolicExpr")

    # -- inspection ----------------------------------------------------------
    def as_dict(self) -> Dict[Monomial, int]:
        return dict(self.terms)

    def is_constant(self) -> bool:
        return all(m == _EMPTY for m, _ in self.terms)

    def constant_value(self) -> Optional[int]:
        if not self.terms:
            return 0
        if self.is_constant():
            return self.terms[0][1]
        return None

    def free_vars(self) -> frozenset:
        return frozenset(a.name for a in self.atom_closure()
                         if isinstance(a, Atom))

    def atoms(self) -> frozenset:
        out = set()
        for mono, _ in self.terms:
            for atom, _exp in mono:
                out.add(atom)
        return frozenset(out)

    def atom_closure(self) -> frozenset:
        """All atoms appearing at any depth (OpAtom operands included).

        Cached on the interned instance — this is the substitution fast
        path's disjointness test and the memo tables' dependency set.
        """
        if self._atoms is None:
            out = set()
            for mono, _ in self.terms:
                for atom, _exp in mono:
                    out.add(atom)
                    if isinstance(atom, OpAtom):
                        for op in atom.operands:
                            out |= op.atom_closure()
            self._atoms = frozenset(out)
        return self._atoms

    # -- algebra -------------------------------------------------------------
    def __add__(self, other: "ExprLike") -> "SymbolicExpr":
        if isinstance(other, int):
            if other == 0:
                return self
            other = SymbolicExpr.constant(other)
        elif not isinstance(other, SymbolicExpr):
            other = SymbolicExpr.wrap(other)
        if not other.terms:
            return self
        if not self.terms:
            return other
        acc = dict(self.terms)
        for m, c in other.terms:
            acc[m] = acc.get(m, 0) + c
        return SymbolicExpr(acc)

    __radd__ = __add__

    def __neg__(self) -> "SymbolicExpr":
        return SymbolicExpr({m: -c for m, c in self.terms})

    def __sub__(self, other: "ExprLike") -> "SymbolicExpr":
        return self + (-SymbolicExpr.wrap(other))

    def __rsub__(self, other: "ExprLike") -> "SymbolicExpr":
        return SymbolicExpr.wrap(other) + (-self)

    def __mul__(self, other: "ExprLike") -> "SymbolicExpr":
        if isinstance(other, int):
            if other == 1:
                return self
            if other == 0:
                return ZERO
            return SymbolicExpr({m: c * other for m, c in self.terms})
        other = SymbolicExpr.wrap(other)
        # constant × polynomial: scale coefficients, skip the double loop
        oc = other.constant_value()
        if oc is not None:
            return self * oc
        sc = self.constant_value()
        if sc is not None:
            return other * sc
        acc: Dict[Monomial, int] = {}
        for m1, c1 in self.terms:
            for m2, c2 in other.terms:
                m = _mono_mul(m1, m2)
                acc[m] = acc.get(m, 0) + c1 * c2
        return SymbolicExpr(acc)

    __rmul__ = __mul__

    def floordiv(self, other: "ExprLike") -> "SymbolicExpr":
        other = SymbolicExpr.wrap(other)
        oc = other.constant_value()
        if oc is not None and oc != 0:
            # exact division of every coefficient -> stay polynomial
            if all(c % oc == 0 for _, c in self.terms):
                return SymbolicExpr({m: c // oc for m, c in self.terms})
        sc = self.constant_value()
        if sc is not None and oc is not None and oc != 0:
            return SymbolicExpr.constant(sc // oc)
        return SymbolicExpr.from_atom(OpAtom("floordiv", (self, other)))

    def mod(self, other: "ExprLike") -> "SymbolicExpr":
        other = SymbolicExpr.wrap(other)
        sc, oc = self.constant_value(), other.constant_value()
        if sc is not None and oc is not None and oc != 0:
            return SymbolicExpr.constant(sc % oc)
        if oc is not None and oc != 0 and all(c % oc == 0 for _, c in self.terms):
            return SymbolicExpr.constant(0)
        return SymbolicExpr.from_atom(OpAtom("mod", (self, other)))

    @staticmethod
    def max_of(a: "ExprLike", b: "ExprLike") -> "SymbolicExpr":
        a, b = SymbolicExpr.wrap(a), SymbolicExpr.wrap(b)
        if a == b:
            return a
        ca, cb = a.constant_value(), b.constant_value()
        if ca is not None and cb is not None:
            return SymbolicExpr.constant(max(ca, cb))
        return SymbolicExpr.from_atom(OpAtom("max", (a, b)))

    @staticmethod
    def min_of(a: "ExprLike", b: "ExprLike") -> "SymbolicExpr":
        a, b = SymbolicExpr.wrap(a), SymbolicExpr.wrap(b)
        if a == b:
            return a
        ca, cb = a.constant_value(), b.constant_value()
        if ca is not None and cb is not None:
            return SymbolicExpr.constant(min(ca, cb))
        return SymbolicExpr.from_atom(OpAtom("min", (a, b)))

    # -- evaluation / substitution -------------------------------------------
    def evaluate(self, env: Mapping[str, int]) -> int:
        total = 0
        for mono, coeff in self.terms:
            v = coeff
            for atom, exp in mono:
                v *= atom.evaluate(env) ** exp
            total += v
        return total

    def substitute(self, mapping: Mapping[AtomT, "SymbolicExpr"]) -> "SymbolicExpr":
        """Replace atoms by expressions (used by the shape graph's rewriting)."""
        # fast path: nothing to replace anywhere in this expression
        if not mapping or self.atom_closure().isdisjoint(mapping):
            return self
        out = SymbolicExpr.constant(0)
        for mono, coeff in self.terms:
            term = SymbolicExpr.constant(coeff)
            for atom, exp in mono:
                rep = mapping.get(atom)
                if rep is None:
                    # rebuild OpAtoms whose operands may contain replaced atoms
                    if isinstance(atom, OpAtom):
                        new_ops = tuple(o.substitute(mapping) for o in atom.operands)
                        if new_ops != atom.operands:
                            base = _rebuild_op_atom(atom.op, new_ops)
                        else:
                            base = SymbolicExpr.from_atom(atom)
                    else:
                        base = SymbolicExpr.from_atom(atom)
                else:
                    base = rep
                for _ in range(exp):
                    term = term * base
            out = out + term
        return out

    # -- bounds ----------------------------------------------------------------
    def interval(self, env_bounds: "BoundsLike" = None) -> "Interval":
        """Conservative integer interval of this expression.

        ``env_bounds`` maps symbolic dim names to declared ranges — a
        :class:`~repro_torch.core.symbolic.intervals.BoundEnv`, a plain mapping
        ``{name: (lo, hi)}`` (``None`` = unbounded; a bare int declares
        only the upper bound), or ``None`` for the default assumption that
        every dim is ``>= 1``.  Opaque atoms (floordiv/mod/max/min) use the
        exact interval rules from :mod:`intervals`.
        """
        from .intervals import BoundEnv, Interval

        env = env_bounds if isinstance(env_bounds, BoundEnv) else BoundEnv(env_bounds)
        # fast path — size-style polynomials: every coefficient positive,
        # every atom a plain dim with a nonnegative declared range.  Such a
        # polynomial is monotone in every dim, so its exact hull is just the
        # two corner evaluations (no interval products, no .power calls)
        monotone = True
        for mono, coeff in self.terms:
            if coeff < 0:
                monotone = False
                break
            for atom, _exp in mono:
                if type(atom) is not Atom:
                    monotone = False
                    break
                lo = env.lookup(atom.name).lo
                if lo is None or lo < 0:
                    monotone = False
                    break
            else:
                continue
            break
        if monotone:
            lo_env, hi_env, bounded = {}, {}, True
            for mono, _coeff in self.terms:
                for atom, _exp in mono:
                    iv = env.lookup(atom.name)
                    lo_env[atom.name] = iv.lo
                    if iv.hi is None:
                        bounded = False
                    else:
                        hi_env[atom.name] = iv.hi
            return Interval(self.evaluate(lo_env),
                            self.evaluate(hi_env) if bounded else None)
        total = Interval.point(0)
        for mono, coeff in self.terms:
            term = Interval.point(coeff)
            for atom, exp in mono:
                term = term * _atom_interval(atom, env).power(exp)
            total = total + term
        return total

    def bounds(self, env_bounds: "BoundsLike" = None) -> Tuple[Optional[int], Optional[int]]:
        """``(lo, hi)`` integer bounds of this expression; see :meth:`interval`.

        ``None`` means unbounded in that direction.  Sound: for every env
        within the declared ranges, ``lo <= self.evaluate(env) <= hi``.
        """
        iv = self.interval(env_bounds)
        return iv.lo, iv.hi

    # -- dunder -----------------------------------------------------------------
    def __eq__(self, other: object) -> bool:
        if self is other:          # interned: the overwhelmingly common case
            return True
        if isinstance(other, int):
            c = self.constant_value()
            return c is not None and c == other
        if not isinstance(other, SymbolicExpr):
            return NotImplemented
        # structural fallback: interning is best-effort under threads, so
        # two live equal instances are possible (rare) and must still match
        return self.terms == other.terms

    def __hash__(self) -> int:
        return self._hash

    def __repr__(self) -> str:
        if not self.terms:
            return "0"
        parts = []
        for mono, coeff in self.terms:
            if not mono:
                parts.append(str(coeff))
                continue
            factors = "*".join(
                (repr(a) if e == 1 else f"{a!r}^{e}") for a, e in mono
            )
            if coeff == 1:
                parts.append(factors)
            elif coeff == -1:
                parts.append(f"-{factors}")
            else:
                parts.append(f"{coeff}*{factors}")
        return " + ".join(parts).replace("+ -", "- ")


def _rebuild_op_atom(op: str, operands: Tuple[SymbolicExpr, ...]) -> SymbolicExpr:
    if op == "floordiv":
        return operands[0].floordiv(operands[1])
    if op == "mod":
        return operands[0].mod(operands[1])
    if op == "max":
        return SymbolicExpr.max_of(*operands)
    if op == "min":
        return SymbolicExpr.min_of(*operands)
    raise ValueError(op)


def _atom_interval(atom: AtomT, env) -> "Interval":
    """Interval of a single atom under a BoundEnv (exact OpAtom rules)."""
    from .intervals import Interval

    if isinstance(atom, Atom):
        return env.lookup(atom.name)
    # opaque compound: recurse into operand expressions
    ops = [o.interval(env) for o in atom.operands]
    if atom.op == "floordiv":
        return ops[0].floordiv(ops[1])
    if atom.op == "mod":
        return ops[0].mod(ops[1])
    if atom.op == "max":
        out = ops[0]
        for o in ops[1:]:
            out = out.max_(o)
        return out
    if atom.op == "min":
        out = ops[0]
        for o in ops[1:]:
            out = out.min_(o)
        return out
    return Interval(0, None)  # unknown opaque op: nonnegative dim arithmetic


ExprLike = Union[int, SymbolicExpr]

ZERO = SymbolicExpr.constant(0)
ONE = SymbolicExpr.constant(1)


def size_of(shape: Iterable[ExprLike]) -> SymbolicExpr:
    """Element count of a shape whose dims are ints or SymbolicExprs."""
    out = ONE
    for d in shape:
        out = out * SymbolicExpr.wrap(d)
    return out
