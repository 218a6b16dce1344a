"""Sharding rules: params / optimizer / batches / caches -> PartitionSpec.

Port of ``repro/launch/sharding.py``, the same strategy:
  * 2D param sharding: FSDP on ``data`` x tensor-parallel on ``model``;
  * TP shards attention heads / FFN columns / vocab where divisible by the
    model-axis size; non-divisible dims fall back to replication, recorded
    in ``fallbacks``;
  * MoE experts shard on ``model`` (EP);
  * ``pod`` is pure data parallelism.
Rules match parameter *names*.

A spec is the port's own :class:`PartitionSpec`: one entry per tensor
dim, each an axis name, a tuple of names or ``None``.  ``placements``
turns it into DTensor placements over the mesh (``Shard(d)`` /
``Replicate()``, one per mesh dim), and ``named`` into
:class:`NamedSharding` leaves, which ``Checkpointer.restore(shardings=)``
takes.

Per-layer leaves.  The reference stacks its layers (one leading axis for
``layers``, ``slstm`` and the caches, two for ``mlstm``); the port keeps
them in per-layer lists (``models/convert.py``).  A port leaf's spec is
the reference's rule applied to the *stacked* shape (each enclosing
list's length in front), with the stacked leading entries dropped: a
rule that reads the leading dims (an MoE layer's shared FFN is 3-D once
stacked; a cache's batch axis is 1, counted from the stacked shape) then
gives the reference's answer, and ``fallbacks`` is keyed by the
reference's (stacked) name, the list indices left out.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from torch.utils import _pytree as pytree

from .mesh import axis_sizes, dp_axes, model_axis_size


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of names, or ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A mesh and the DTensor placements of a leaf on it."""
    mesh: Any
    placements: Tuple[Any, ...]
    spec: PartitionSpec


def _divides(n, k: int) -> bool:
    return isinstance(n, int) and k > 0 and n % k == 0


def _key_name(k: Any) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _leaves(tree: Any) -> Tuple[List[Tuple[str, Tuple[int, ...], Any]], Any]:
    """Per leaf: its stacked name (list indices left out), the lengths of
    the lists it sits in (outermost first), and the leaf; and the spec."""
    flat, spec = pytree.tree_flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        node, parts, stack = tree, [], []
        for k in path:
            if isinstance(node, list):
                stack.append(len(node))
            else:
                parts.append(_key_name(k))
            node = k.get(node)
        out.append(("/".join(parts), tuple(stack), leaf))
    return out, spec


class ShardingRules:
    def __init__(self, mesh, *, fsdp: bool = True):
        self.mesh = mesh
        self.model = model_axis_size(mesh)
        self.data = axis_sizes(mesh).get("data", 1)
        self.dp = dp_axes(mesh)
        self.fsdp = fsdp
        self.fallbacks: Dict[str, str] = {}

    # -- helpers ----------------------------------------------------------------
    def _axis(self, name: str, dim_size, axis: Optional[str]):
        """axis if divisible else None (recorded as fallback)."""
        if axis is None:
            return None
        k = self.model if axis == "model" else self.data
        if axis == "data" and not self.fsdp:
            return None
        if _divides(dim_size, k):
            return axis
        self.fallbacks[name] = f"dim {dim_size} % {axis}({k}) != 0 -> replicated"
        return None

    def _dp_size(self) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.dp)

    def _dp_entry(self):
        return self.dp if len(self.dp) > 1 else self.dp[0]

    def spec_for(self, name: str, shape: Tuple[int, ...],
                 stack: Tuple[int, ...] = ()) -> PartitionSpec:
        """PartitionSpec for a parameter leaf by its (path) name; ``stack``:
        the lengths of the layer lists the leaf sits in, whose entries the
        rule sees in front of ``shape`` and the result leaves out."""
        return P(*self._stacked_spec(name, tuple(stack) + tuple(shape))
                 [len(stack):])

    def _stacked_spec(self, name: str, shape: Tuple[int, ...]
                      ) -> PartitionSpec:
        parts = name.split("/")
        base = parts[-1]
        is_moe = "moe" in parts and base in ("w1", "w2", "w3", "router")
        nd = len(shape)

        def two_d(row_axis, col_axis, rank=2):
            """rule for trailing `rank` dims; leading dims -> None."""
            lead = [None] * (nd - rank)
            dims = list(shape[nd - rank:])
            axes = [row_axis, col_axis][-rank:] if rank == 2 else [col_axis]
            out = []
            for d, a in zip(dims, axes):
                out.append(self._axis(name, d, a))
            return P(*(lead + out))

        # embeddings / lm head: vocab-parallel, contraction (D) unsharded so
        # the logits matmul keeps activations batch-sharded.
        if base == "embed":
            return two_d("model", None)
        if base == "lm_head":
            return two_d(None, "model")
        # attention (gqa)
        if base in ("wq", "wk", "wv"):
            return two_d("data", "model")
        if base == "wo":
            return two_d("model", "data")
        # MLA
        if base in ("w_dq", "w_dkv", "w_kr"):
            return two_d("data", "model")
        if base in ("w_uq", "w_uk", "w_uv"):  # (r, H, d): shard heads
            lead = [None] * (nd - 3)
            return P(*(lead + [self._axis(name, shape[-3], "data"),
                               self._axis(name, shape[-2], "model"), None]))
        if base == "w_o" and nd >= 3:          # (H, v, D)
            lead = [None] * (nd - 3)
            return P(*(lead + [self._axis(name, shape[-3], "model"), None,
                               self._axis(name, shape[-1], "data")]))
        # MoE experts: EP on the expert dim
        if is_moe and base in ("w1", "w3") and nd >= 3:  # (E, D, F)
            lead = [None] * (nd - 3)
            return P(*(lead + [self._axis(name, shape[-3], "model"),
                               self._axis(name, shape[-2], "data"), None]))
        if is_moe and base == "w2" and nd >= 3:          # (E, F, D)
            lead = [None] * (nd - 3)
            return P(*(lead + [self._axis(name, shape[-3], "model"), None,
                               self._axis(name, shape[-1], "data")]))
        if base == "router":
            return two_d("data", None)
        # dense FFN
        if base in ("w1", "w3"):
            return two_d("data", "model")
        if base == "w2":
            return two_d("model", "data")
        # SSM
        if base in ("in_proj", "up_proj"):
            return two_d("data", "model")
        if base in ("out_proj", "down_proj"):
            return two_d("model", "data")
        if base in ("x_proj",):
            return two_d("model", None)
        if base in ("dt_proj",):
            return two_d(None, "model")
        if base in ("a_log",):
            return two_d("model", None)
        # xlstm in-block projections (di, di)
        if base in ("w_igate", "w_fgate", "w_z", "w_i", "w_f", "w_o_gate"):
            return two_d("data", "model") if nd >= 2 else P(*([None] * nd))
        # 1-D / small: replicate
        return P(*([None] * nd))

    # -- pytree-level APIs ------------------------------------------------------
    def params_pspecs(self, params_shapes: Any) -> Any:
        """A spec per leaf of a parameter (or optimizer-moment) tree of
        tensors or ``TensorSpec``s."""
        flat, spec = _leaves(params_shapes)
        return pytree.tree_unflatten(
            [None if leaf is None else
             self.spec_for(name, tuple(leaf.shape), stack)
             for name, stack, leaf in flat], spec)

    def placements(self, spec: PartitionSpec) -> Tuple[Any, ...]:
        """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)``
        on each mesh dim that tensor dim ``d`` names, ``Replicate()``
        elsewhere.  A dim on ``("pod", "data")`` is sharded on both, pod
        the major one, as in JAX."""
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(self.mesh.mesh_dim_names)
        out: List[Any] = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            axes = () if entry is None else \
                (entry if isinstance(entry, tuple) else (entry,))
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"spec {spec}: dim {d}'s axes {axes} are "
                                 f"not in the mesh's order {names}")
            for i in idx:
                if out[i] != Replicate():
                    raise ValueError(f"spec {spec} uses mesh dim "
                                     f"{names[i]!r} twice")
                out[i] = Shard(d)
        return tuple(out)

    def named(self, pspecs: Any) -> Any:
        """A :class:`NamedSharding` per spec of ``pspecs``."""
        return pytree.tree_map(
            lambda s: None if s is None else
            NamedSharding(self.mesh, self.placements(s), s), pspecs,
            is_leaf=lambda x: isinstance(x, PartitionSpec) or x is None)

    def batch_specs(self, batch_shapes: Any) -> Any:
        """Shard leading (batch) dim on the DP axes when divisible."""
        dp_size = self._dp_size()

        def spec(leaf):
            shape = tuple(leaf.shape)
            b = shape[0] if shape else 1
            if _divides(b, dp_size):
                return P(*((self._dp_entry(),) + (None,) * (len(shape) - 1)))
            return P(*((None,) * len(shape)))
        return pytree.tree_map(lambda x: None if x is None else spec(x),
                               batch_shapes)

    def cache_specs(self, cache_shapes: Any) -> Any:
        """Decode caches: (L, B, S, H, hd)-style once stacked; batch on dp,
        heads/feature on model when divisible, else seq on data
        (long-context B=1)."""
        dp_size = self._dp_size()

        def spec(shape):
            nd = len(shape)
            out = [None] * nd
            if nd >= 2 and _divides(shape[1], dp_size):
                out[1] = self._dp_entry()
            # shard the widest remaining dim on model if divisible
            best, best_dim = None, 0
            for i in range(2, nd):
                if _divides(shape[i], self.model) and shape[i] > best_dim:
                    best, best_dim = i, shape[i]
            if best is not None:
                out[best] = "model"
            # B=1 long-context: shard seq (axis 2) on data
            if nd >= 3 and out[1] is None and _divides(shape[2], self.data) \
                    and shape[2] >= 4096:
                out[2] = "data"
            return P(*out)

        flat, tspec = _leaves(cache_shapes)
        return pytree.tree_unflatten(
            [None if leaf is None else
             P(*spec(stack + tuple(leaf.shape))[len(stack):])
             for _, stack, leaf in flat], tspec)
