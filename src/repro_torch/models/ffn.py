"""Feed-forward: SwiGLU and GeGLU, the dense-family FFNs of the reference
(``repro/models/ffn.py:24-47``), and its token-choice mixture of experts
(``:53-150``), in plain PyTorch as there.

The MoE dispatch is the reference's sort-based one: each example's
(token, choice) pairs are sorted by expert id, and the first ``cap`` pairs
of each expert's run are scattered into an (E, C, D) buffer per example;
the experts run as one grouped product over the expert dim.  Two things
are written so that the port routes exactly as the reference does and
gives the same answer on every run:

* the sort is stable (``jnp.argsort`` is; ``torch.argsort`` only with
  ``stable=True``): within an expert's run the order of the pairs decides
  which pass the capacity and which drop;
* the combine gathers each token's ``top_k`` slots and sums them in f32,
  in choice order, where the reference scatter-adds in the activations'
  dtype; a scatter-add on CUDA (``index_add_``) would add in no fixed
  order, so greedy tokens could change from run to run.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .common import dense_init


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def geglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
          w2: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu(approximate=True)``: the tanh form."""
    return (F.gelu(x @ w1, approximate="tanh") * (x @ w3)) @ w2


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return {"w1": dense_init(gen, (d_model, d_ff), dtype),
            "w3": dense_init(gen, (d_model, d_ff), dtype),
            "w2": dense_init(gen, (d_ff, d_model), dtype)}


def ffn_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              kind: str = "swiglu") -> torch.Tensor:
    fn = {"swiglu": swiglu, "geglu": geglu}.get(kind)
    if fn is None:
        raise NotImplementedError(f"ffn kind {kind!r} is not ported yet")
    return fn(x, params["w1"], params["w3"], params["w2"])


# -- Mixture of Experts ----------------------------------------------------------

# the experts' gate activation per ``ffn_kind`` (the reference's jax.nn.silu
# and jax.nn.gelu, whose default is the tanh form)
_EXPERT_ACT = {"swiglu": F.silu,
               "geglu": functools.partial(F.gelu, approximate="tanh")}


def _experts_init(gen: torch.Generator, n: int, shape: Tuple[int, int],
                  dtype: torch.dtype) -> torch.Tensor:
    """(n, *shape) expert weights, scaled by ``shape[0]`` (the reference's
    ``in_axis=1``), drawn one expert at a time: a full-width stack drawn
    at once would take 4x its bf16 bytes in f32 temporaries."""
    out = torch.empty((n, *shape), dtype=dtype, device=gen.device)
    if out.is_meta:
        return out
    for i in range(n):
        out[i] = dense_init(gen, shape, dtype)
    return out


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             n_shared: int, dtype: torch.dtype) -> Dict:
    """The router (D, E) in f32 whatever ``dtype``, as the reference's;
    the experts' ``w1``/``w3`` (E, D, F) and ``w2`` (E, F, D); a shared
    SwiGLU/GeGLU of width ``d_ff * n_shared`` when ``n_shared``."""
    p = {"router": dense_init(gen, (d_model, n_experts), torch.float32),
         "w1": _experts_init(gen, n_experts, (d_model, d_ff), dtype),
         "w3": _experts_init(gen, n_experts, (d_model, d_ff), dtype),
         "w2": _experts_init(gen, n_experts, (d_ff, d_model), dtype)}
    if n_shared:
        p["shared"] = ffn_init(gen, d_model, d_ff * n_shared, dtype)
    return p


class Routing(NamedTuple):
    """One MoE call's routing, per example (the leading B axis).  Pairs are
    ``n = token * top_k + choice``; ``sort_idx`` orders them by expert id,
    stably, and ``dest`` / ``token_of`` are in that sorted order."""
    probs: torch.Tensor     # (B, S, E) f32 router softmax
    top_p: torch.Tensor     # (B, S, k) f32, renormalised over the k
    top_i: torch.Tensor     # (B, S, k) int64 expert ids
    cap: int                # slots per expert per example
    sort_idx: torch.Tensor  # (B, N) int64
    dest: torch.Tensor      # (B, N) slot e * cap + pos, or e * cap: dropped
    token_of: torch.Tensor  # (B, N) the sorted pair's token

    def dropped(self) -> torch.Tensor:
        """Dropped (token, choice) pairs, a device scalar."""
        return (self.dest == self.probs.shape[-1] * self.cap).sum()


_observers: List[Callable[[Routing], None]] = []


@contextlib.contextmanager
def observe_routing(fn: Callable[[Routing], None]):
    """Call ``fn`` with the :class:`Routing` of every ``moe_apply`` run
    inside the block (to count dropped pairs or compare expert choices)."""
    _observers.append(fn)
    try:
        yield
    finally:
        _observers.remove(fn)


def capacity(s: int, top_k: int, capacity_factor: float,
             n_experts: int) -> int:
    """Slots per expert per example: ``max(1, round(s k cf / E))`` with
    Python's ``round`` (half to even), as the reference's."""
    return int(max(1, round(s * top_k * capacity_factor / n_experts)))


def moe_route(router: torch.Tensor, x: torch.Tensor, *, top_k: int,
              capacity_factor: float) -> Routing:
    """The reference's routing (``repro/models/ffn.py:86-115``).  The
    logits are f32 from x and the router cast to x's dtype, as the
    reference's ``preferred_element_type=jnp.float32``: the bf16 router's
    values are exact in f32, so the one f32 product of x's f32 copy gives
    the f32-accumulated product, where a bf16 product would round the
    logits to bf16 and flip near-tied experts."""
    b, s, _ = x.shape
    e = router.shape[1]
    nk = s * top_k
    logits = x.to(torch.float32) @ \
        router.to(x.dtype).to(torch.float32)                     # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)               # (B,S,k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    cap = capacity(s, top_k, capacity_factor, e)
    flat_e = top_i.reshape(b, nk)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    experts = torch.arange(e, device=x.device).expand(b, e).contiguous()
    run_start = torch.searchsorted(sorted_e, experts, right=False)
    pos = torch.arange(nk, device=x.device)[None, :] - \
        torch.gather(run_start, 1, sorted_e)
    dest = torch.where(pos < cap, sorted_e * cap + pos,
                       torch.full_like(pos, e * cap))
    return Routing(probs, top_p, top_i, cap, sort_idx, dest,
                   sort_idx // top_k)


def moe_apply(params: Dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25,
              ffn_kind: str = "swiglu") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, the f32 Switch-style
    aux load-balance loss).  Token-choice routing with per-example
    capacity; pairs past an expert's capacity are dropped (their slot is
    the overflow row ``e * cap``, written by any of them and discarded, as
    in the reference); the shared expert sees every token."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    act = _EXPERT_ACT.get(ffn_kind)
    if act is None:
        raise NotImplementedError(f"ffn kind {ffn_kind!r} is not ported yet")
    r = moe_route(params["router"], x, top_k=top_k,
                  capacity_factor=capacity_factor)
    for fn in _observers:
        fn(r)
    cap = r.cap

    # Switch-style aux loss over every token
    # bincount with minlength e (top_i < e), at a size known before the
    # values: a sharded step cannot trace bincount's value-dependent one
    idx = r.top_i.reshape(-1)
    counts = torch.zeros(e, dtype=idx.dtype, device=idx.device).scatter_add(
        0, idx, torch.ones_like(idx))
    frac_tokens = counts.to(torch.float32) / (b * s * top_k)
    aux = e * torch.sum(frac_tokens * r.probs.reshape(-1, e).mean(dim=0))

    # dispatch: each kept pair's token into its slot of (B, E*C + 1, D)
    xg = torch.gather(x, 1, r.token_of[..., None].expand(b, s * top_k, d))
    buf = torch.scatter(x.new_zeros((b, e * cap + 1, d)), 1,
                        r.dest[..., None].expand(b, s * top_k, d), xg)
    del xg
    buf = buf[:, :-1].reshape(b, e, cap, d)

    # the experts, one grouped product over the expert dim
    h = act(torch.einsum("becd,edf->becf", buf, params["w1"])) * \
        torch.einsum("becd,edf->becf", buf, params["w3"])
    del buf
    y = torch.einsum("becf,efd->becd", h, params["w2"])
    del h
    y_flat = torch.cat([y.reshape(b, e * cap, d), y.new_zeros((b, 1, d))],
                       dim=1)
    del y

    # combine: each token's k slots (in choice order), weighted, summed in f32
    slot = torch.scatter(torch.empty_like(r.dest), 1, r.sort_idx,
                         r.dest).view(b, s, top_k)
    out = None
    for j in range(top_k):
        yj = torch.gather(y_flat, 1, slot[:, :, j, None].expand(b, s, d))
        yj = yj.to(torch.float32) * r.top_p[:, :, j, None]
        out = yj if out is None else out + yj
    out = out.to(x.dtype)
    if "shared" in params:
        out = out + ffn_apply(params["shared"], x.reshape(b * s, d),
                              kind=ffn_kind).reshape(b, s, d)
    return out, aux
