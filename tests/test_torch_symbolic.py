"""The port's symbolic core against the reference's, on the same inputs.

Random expression recipes are built in both packages; canonical forms,
evaluations, intervals under declared ranges, ``ShapeGraph.compare``
verdicts and the narrowed (``specialized``) graph's answers must agree
exactly.  ``from_torch`` is checked on every sympy form it converts.
"""
import numpy as np
import pytest
import sympy
import torch

import repro.core.symbolic as R
import repro_torch.core.symbolic as P
from repro_torch.core.symbolic.from_torch import dim_to_expr

DIMS = ("b", "s", "t")


def _recipe(rng, depth):
    if depth == 0 or rng.rand() < 0.25:
        if rng.rand() < 0.7:
            return ("var", DIMS[rng.randint(len(DIMS))])
        return ("const", int(rng.randint(-3, 9)))
    op = ["add", "sub", "mul", "floordiv", "mod", "max", "min"][
        rng.randint(7)]
    a = _recipe(rng, depth - 1)
    if op in ("floordiv", "mod") and rng.rand() < 0.6:
        return (op, a, ("const", int(rng.randint(1, 7))))
    return (op, a, _recipe(rng, depth - 1))


def _build(mod, r):
    E = mod.SymbolicExpr
    kind = r[0]
    if kind == "var":
        return E.var(r[1])
    if kind == "const":
        return E.constant(r[1])
    a, b = _build(mod, r[1]), _build(mod, r[2])
    if kind == "add":
        return a + b
    if kind == "sub":
        return a - b
    if kind == "mul":
        return a * b
    if kind == "floordiv":
        return a.floordiv(b)
    if kind == "mod":
        return a.mod(b)
    if kind == "max":
        return E.max_of(a, b)
    return E.min_of(a, b)


def _ranges(rng):
    out = {}
    for d in DIMS:
        lo = int(rng.randint(1, 20))
        out[d] = (lo, lo + int(rng.randint(0, 200)))
    return out


def _safe_eval(e, env):
    try:
        return e.evaluate(env)
    except ZeroDivisionError:
        return "div0"


@pytest.mark.parametrize("seed", range(12))
def test_canonical_forms_evaluation_and_intervals_agree(seed):
    rng = np.random.RandomState(seed)
    ranges = _ranges(rng)
    for _ in range(25):
        r = _recipe(rng, 3)
        er, ep = _build(R, r), _build(P, r)
        assert repr(er) == repr(ep)
        assert er.free_vars() == ep.free_vars()
        env = {d: int(rng.randint(lo, hi + 1)) for d, (lo, hi) in ranges.items()}
        assert _safe_eval(er, env) == _safe_eval(ep, env)
        ir_, ip = er.interval(ranges), ep.interval(ranges)
        assert (ir_.lo, ir_.hi) == (ip.lo, ip.hi)


@pytest.mark.parametrize("seed", range(8))
def test_compare_verdicts_and_narrowing_agree(seed):
    rng = np.random.RandomState(100 + seed)
    ranges = _ranges(rng)
    sg_r, sg_p = R.ShapeGraph(), P.ShapeGraph()
    R.declare_dim_ranges(sg_r, ranges)
    P.declare_dim_ranges(sg_p, ranges)
    sg_r.add_equality("t", R.SymbolicExpr.var("s") * 2)
    sg_p.add_equality("t", P.SymbolicExpr.var("s") * 2)
    pairs = [(_recipe(rng, 2), _recipe(rng, 2)) for _ in range(30)]
    for a, b in pairs:
        vr = sg_r.compare(_build(R, a), _build(R, b))
        vp = sg_p.compare(_build(P, a), _build(P, b))
        assert vr.name == vp.name
        ir_ = sg_r.interval_of(_build(R, a))
        ip = sg_p.interval_of(_build(P, a))
        assert (ir_.lo, ir_.hi) == (ip.lo, ip.hi)
    assert sg_r.cmp_stats == sg_p.cmp_stats
    lo, hi = ranges["s"]
    narrow = {"s": (lo, lo + (hi - lo) // 3)}
    sub_r, sub_p = sg_r.specialized(narrow), sg_p.specialized(narrow)
    assert sub_r.cmp_stats["inherited"] == sub_p.cmp_stats["inherited"]
    for a, b in pairs:
        assert sub_r.compare(_build(R, a), _build(R, b)).name == \
            sub_p.compare(_build(P, a), _build(P, b)).name
    assert sub_r.cmp_stats == sub_p.cmp_stats
    assert repr(sub_r.canonicalize(_build(R, ("var", "t")))) == \
        repr(sub_p.canonicalize(_build(P, ("var", "t"))))


def test_declare_bound_agrees():
    sg_r, sg_p = R.ShapeGraph(), P.ShapeGraph()
    for sg, mod in ((sg_r, R), (sg_p, P)):
        mod.declare_dim_ranges(sg, {"b": (1, 8), "s": "16..512"})
        sg.declare_bound("__b0", mod.SymbolicExpr.var("b")
                         * mod.SymbolicExpr.var("s"))
    ir_ = sg_r.interval_of(R.SymbolicExpr.var("__b0") * 4)
    ip = sg_p.interval_of(P.SymbolicExpr.var("__b0") * 4)
    assert (ir_.lo, ir_.hi) == (ip.lo, ip.hi) == (0, 4 * 8 * 512)


@pytest.mark.parametrize("spec", [(1, 8), 64, "16..1024", "<=32", ">=4",
                                  "..9", "3.."])
def test_parse_range_spec_agrees(spec):
    assert R.parse_range_spec(spec) == P.parse_range_spec(spec)


# -- from_torch ---------------------------------------------------------------

_b, _s = sympy.Symbol("s26", integer=True, positive=True), \
    sympy.Symbol("s49", integer=True, positive=True)
_NAMES = {_b: "b", _s: "s"}


def _forms():
    from torch.utils._sympy.functions import FloorDiv, Mod, PythonMod
    return {
        "add": (_b + _s + 3, lambda b, s: b + s + 3),
        "mul": (4 * _b * _s, lambda b, s: 4 * b * s),
        "pow": (_s ** 2 * _b, lambda b, s: s * s * b),
        "floordiv": (FloorDiv(_b * _s + 5, 4), lambda b, s: (b * s + 5) // 4),
        "mod": (Mod(_s, 8), lambda b, s: s % 8),
        "pythonmod": (PythonMod(_b * _s, 3), lambda b, s: (b * s) % 3),
        "max": (sympy.Max(_b, _s, 7), lambda b, s: max(b, s, 7)),
        "min": (sympy.Min(_b * 2, _s), lambda b, s: min(2 * b, s)),
        "const": (sympy.Integer(12), lambda b, s: 12),
    }


@pytest.mark.parametrize("form", ["add", "mul", "pow", "floordiv", "mod",
                                  "pythonmod", "max", "min", "const"])
def test_from_torch_converts_each_sympy_form(form):
    expr, fn = _forms()[form]
    e = dim_to_expr(expr, _NAMES)
    assert e.free_vars() <= {"b", "s"}
    for b, s in [(1, 16), (3, 40), (8, 1024)]:
        assert e.evaluate({"b": b, "s": s}) == fn(b, s)


def test_from_torch_unknown_form_is_an_opaque_atom():
    e = dim_to_expr(sympy.ceiling(_b / 3), _NAMES)
    (name,) = e.free_vars()
    assert name.startswith("opaque<")


def test_from_torch_symint_renames_shape_env_symbols():
    from torch._dynamo.source import ConstantSource
    from torch.fx.experimental.symbolic_shapes import DimDynamic, ShapeEnv
    env = ShapeEnv(duck_shape=False)
    sym = env.create_symbol(5, source=ConstantSource("b"),
                            dynamic_dim=DimDynamic.DYNAMIC)
    si = env.create_symintnode(sym, hint=5)
    e = dim_to_expr((si * 3 + 1) // 2, {sym: "b"})
    assert e.free_vars() == {"b"}
    assert e.evaluate({"b": 7}) == (7 * 3 + 1) // 2
    assert dim_to_expr(9) == P.SymbolicExpr.constant(9)
    with pytest.raises(TypeError):
        dim_to_expr(torch.zeros(1))
