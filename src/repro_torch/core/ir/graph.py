"""Computation-graph IR over which the paper's analyses run.

A ``Graph`` is a flat list of ``Node``s (one per aten or custom-op call)
connected by ``Value``s (tensors).  Every Value carries its shape as a tuple
of ``SymbolicExpr`` dims and its byte count as a ``SymbolicExpr`` — this is
the "dynamic shape graph" of the paper, with the symbolic shape information
attached (§2.1).

How PyTorch's aliasing maps onto byte accounting:

* **Views alias their base.**  The output of a view op (``view``,
  ``_unsafe_view``, ``select``, ``slice``, ``transpose``, ``t``, ``expand``,
  ``split``... — any op whose schema returns an alias, plus
  ``_unsafe_view``, which reuses its input's storage) is a Value with
  ``base`` set to the root Value that owns the storage.  A view carries
  **0 bytes**, and every consumer of a view also lists the root base among
  its ``invals`` (after the op's own arguments, ``Node.n_args``), so the
  base stays live until the last consumer of any of its views.  That is
  what PyTorch's caching allocator really holds: a storage is returned only
  when no tensor aliasing it remains.
* **Returned views are copied.**  A graph output that is a view of an
  intermediate gets an ``aten.clone`` node (see ``ir.capture``): the
  returned tensor then owns its bytes, and the base frees at its last use,
  as the reference's slice/squeeze outputs do.
* **Shape arithmetic is not a node.**  ``aten.sym_size.int`` and Python
  ``operator`` nodes compute sizes, not tensors: they carry 0 bytes and are
  folded into the consuming op's arguments as ``SymbolicExpr``s, resolved
  for each call's dim binding.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..symbolic import SymbolicExpr, ZERO, size_of


class Value:
    """A tensor edge in the graph."""

    __slots__ = (
        "id", "dims", "dtype", "producer", "out_index", "consumers", "kind",
        "const_val", "name", "base", "_nbytes_expr",
    )

    def __init__(
        self,
        vid: int,
        dims,
        dtype: torch.dtype,
        kind: str = "intermediate",  # 'input' | 'const' | 'intermediate'
        const_val: Any = None,
        name: str = "",
        base: Optional["Value"] = None,
    ):
        self.id = vid
        self.dims = tuple(dims)
        self.dtype = dtype
        self.producer: Optional["Node"] = None
        self.out_index: int = -1
        self.consumers: List["Node"] = []
        self.kind = kind
        self.const_val = const_val
        self.name = name
        self.base = base        # root storage owner when this is a view
        self._nbytes_expr = None

    @property
    def size_expr(self) -> SymbolicExpr:
        return size_of(self.dims)

    @property
    def nbytes_expr(self) -> SymbolicExpr:
        if self._nbytes_expr is None:
            self._nbytes_expr = ZERO if self.base is not None else \
                self.size_expr * int(self.dtype.itemsize)
        return self._nbytes_expr

    def is_materialized_input(self) -> bool:
        return self.kind in ("input", "const")

    def __repr__(self) -> str:  # pragma: no cover
        dims = "x".join(str(d) for d in self.dims) or "scalar"
        return f"%{self.id}:{self.dtype}[{dims}]"


class Node:
    """One op application.

    ``invals[:n_args]`` are the tensors the op reads (in the order its
    argument template refers to them); any further entries are view bases
    kept live by this node (see the module docstring)."""

    __slots__ = ("id", "prim", "prim_name", "invals", "outvals", "params",
                 "n_args")

    def __init__(self, nid: int, prim: Any, invals: List[Value],
                 outvals: List[Value], params: Dict[str, Any],
                 prim_name: Optional[str] = None,
                 n_args: Optional[int] = None):
        self.id = nid
        self.prim = prim
        self.prim_name = prim_name if prim_name is not None else str(prim)
        self.invals = invals
        self.outvals = outvals
        self.params = params
        self.n_args = len(invals) if n_args is None else n_args

    def __repr__(self) -> str:  # pragma: no cover
        return f"({self.id}:{self.prim_name} {self.invals} -> {self.outvals})"


# process-wide graph identity counter: per-env resolve caches are
# namespaced by it (ids restart at 0 per graph)
_GRAPH_UIDS = itertools.count()


@dataclass
class Graph:
    nodes: List[Node] = field(default_factory=list)
    inputs: List[Value] = field(default_factory=list)
    consts: List[Value] = field(default_factory=list)
    outputs: List[Value] = field(default_factory=list)
    # flat list of all values, id-indexed
    values: List[Value] = field(default_factory=list)
    in_tree: Any = None
    out_tree: Any = None
    uid: int = field(default_factory=lambda: next(_GRAPH_UIDS))

    _vid: itertools.count = field(default_factory=lambda: itertools.count())
    _nid: itertools.count = field(default_factory=lambda: itertools.count())

    # -- construction helpers -------------------------------------------------
    def new_value(self, dims, dtype, kind="intermediate", const_val=None,
                  name="", base=None) -> Value:
        v = Value(next(self._vid), dims, dtype, kind, const_val, name, base)
        self.values.append(v)
        return v

    def add_node(self, prim, invals: Sequence[Value], outvals: Sequence[Value],
                 params, *, prim_name: Optional[str] = None,
                 n_args: Optional[int] = None) -> Node:
        n = Node(next(self._nid), prim, list(invals), list(outvals),
                 dict(params), prim_name=prim_name, n_args=n_args)
        for i, ov in enumerate(outvals):
            ov.producer = n
            ov.out_index = i
        for iv in invals:
            iv.consumers.append(n)
        self.nodes.append(n)
        return n

    # -- queries ---------------------------------------------------------------
    def validate_order(self, order: Sequence[Node]) -> None:
        """Raise unless ``order`` is a valid topological order of the graph."""
        ids = [n.id for n in order]
        if len(ids) != len(self.nodes) or \
                set(ids) != {n.id for n in self.nodes}:
            raise ValueError("order must be a permutation of graph nodes")
        seen = set()
        for n in order:
            for iv in n.invals:
                if iv.producer is not None and iv.producer.id not in seen:
                    raise ValueError(
                        f"node {n.id}({n.prim_name}) scheduled before "
                        f"producer {iv.producer.id}({iv.producer.prim_name})")
            seen.add(n.id)

    def free_symbols(self) -> frozenset:
        out: frozenset = frozenset()
        for v in self.values:
            out |= v.size_expr.free_vars()
        return out

    def stats(self) -> Dict[str, int]:
        return {
            "nodes": len(self.nodes),
            "values": len(self.values),
            "inputs": len(self.inputs),
            "consts": len(self.consts),
            "outputs": len(self.outputs),
            "views": sum(1 for v in self.values if v.base is not None),
        }
