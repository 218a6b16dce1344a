"""Value-dependent bounded dynamism: the introduce/propagate split.

Port of ``repro/core/ir/dynamism.py``.  SoD² classifies dynamic-shape ops
into those that *introduce* dynamism (``nonzero``, ``masked_select``,
top-k with a data-dependent k, …) and those that merely *propagate* it.
This module is the registry for the introducing side: an op registered
here returns, beside its payload, an ``int32`` count scalar, and the
payload's output dim ``axis`` becomes a fresh *bounded symbol*
``__b<k>`` with a symbolic cap ``f(input dims)`` at capture (the op's
fake makes that dim an unbacked size, which ``ir.capture`` renames).

The memory contract is the bounded dynamic-shape model: the planner
reserves the cap (``f(input dims)`` is known at ``BindArg`` time), while
the runtime measures the actual extent right after the introducing
op (the ``BindDim`` step) and publishes it into the call env, so every
*later* allocation, free and checked reuse of a bound-dependent value
uses the tight size.  Unlike the reference, whose ops return a payload
padded to the cap, the port's ops return it tight: ``count`` rows, so
the caching allocator holds the tight bytes the accounting reports.

``complete_bound_env`` is the single source of truth for turning a
declared env (input dims only) into a fully-evaluable env: missing bound
dims are filled with their cap, *in introduction order* so chained caps
(a bounded op feeding another) resolve.  It is deterministic in the
declared env, which keeps the per-env resolve caches sound: cache keys
stay declared-env-keyed, cached sizes are cap sizes, and measured values
live only in per-call overlays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Mapping, Optional

from ..symbolic.expr import SymbolicExpr

if TYPE_CHECKING:  # pragma: no cover
    from .graph import Graph, Node


@dataclass(frozen=True)
class DimIntroSpec:
    """How a registered op introduces a bounded dim.

    ``padded_out``/``count_out`` index the op's outputs (the payload, and
    the int32 measured-extent scalar); ``axis`` is the payload dim that
    becomes bounded; the cap expression is read off input ``cap_arg``'s
    dim ``cap_axis`` (the reference's padded payload has the input's
    shape, so the cap is always a plain function of input dims).
    """
    padded_out: int = 0
    count_out: int = 1
    axis: int = 0
    cap_arg: int = 0
    cap_axis: int = 0


# op name (``Node.prim_name``) -> spec.  kernels/ops.py registers its ops
# here when imported; capture consults it per node.
INTRODUCES_DIM: Dict[str, DimIntroSpec] = {}


def register_introduces_dim(prim_name: str,
                            spec: Optional[DimIntroSpec] = None) -> None:
    INTRODUCES_DIM[prim_name] = spec or DimIntroSpec()


def introduces_dim(prim_name: str) -> Optional[DimIntroSpec]:
    return INTRODUCES_DIM.get(prim_name)


@dataclass(frozen=True)
class BoundIntro:
    """One bounded dim introduced by one graph node (trace-time record)."""
    name: str                  # the fresh bounded symbol, e.g. "__b0"
    cap: SymbolicExpr          # symbolic upper bound f(input dims)
    node_id: int               # the introducing node
    padded_out: int            # node output index of the payload
    count_out: int             # node output index of the int32 count
    axis: int                  # payload dim rewritten to the bound symbol


def complete_bound_env(graph: "Graph", env: Mapping[str, int],
                       ) -> Dict[str, int]:
    """Fill missing bounded dims of ``graph`` with their cap values.

    Caller-provided values (e.g. measured extents from a previous run's
    report env) are kept; only absent bound dims are completed, in
    introduction order so chained caps resolve.  Deterministic in the
    declared env — safe to use behind declared-env-keyed caches.
    """
    bound = getattr(graph, "bound_dims", None)
    if not bound:
        return dict(env)
    out = dict(env)
    for name, cap in bound.items():
        if name not in out:
            out[name] = max(0, int(cap.evaluate(out)))
    return out
