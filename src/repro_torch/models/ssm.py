"""Mamba-style selective SSM (diagonal state) with a chunked scan: the
port of ``repro/models/ssm.py``.

The full-sequence forward (``ssm_apply``) splits the sequence into chunks
of ``chunk`` steps and walks them in a Python loop, carrying the f32 state
``h`` (B, d_inner, N) from one chunk to the next, as the reference's
``lax.scan`` over chunks does (``:120-122``): only one chunk's
(B, Q, d_inner, N) f32 tensors are alive at a time.  Inside a chunk the
recurrence ``h_t = exp(log_a_t) h_{t-1} + bu_t`` is an associative scan,
written as the odd-even recursion ``jax.lax.associative_scan`` runs, so
the f32 combines happen in the reference's order.  Decode
(``ssm_decode_step``) is the O(1) recurrent update over an ``SSMCache``.

All of it is plain PyTorch, as the reference is plain jnp: no TPU kernel
stands behind the SSM.  The reference's dtype steps are kept: ``dt * u``
is formed in the model dtype and then cast to f32, the state stays f32,
``a_log`` is f32 whatever the model dtype, and the decode's ``y`` is cast
to the input's dtype before the gate.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import dense_init


class SSMConfig(NamedTuple):
    d_model: int
    d_inner: int
    d_state: int = 16
    dt_rank: int = 0        # 0 -> ceil(d_model/16)
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def ssm_init(gen: torch.Generator, cfg: SSMConfig,
             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The reference's ``ssm_init`` leaves, the random ones drawn from
    ``gen`` in its key order (in_proj, conv_w, x_proj, dt_proj,
    out_proj); ``a_log`` is f32 whatever ``dtype``."""
    di, n, r = cfg.d_inner, cfg.d_state, cfg.rank
    dev = gen.device
    in_proj = dense_init(gen, (cfg.d_model, 2 * di), dtype)
    conv_w = dense_init(gen, (cfg.conv_kernel, di), dtype, scale=1.0)
    x_proj = dense_init(gen, (di, r + 2 * n), dtype)
    dt_proj = dense_init(gen, (r, di), dtype)
    out_proj = dense_init(gen, (di, cfg.d_model), dtype)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(di, dtype=dtype, device=dev),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": torch.full((di,), -4.0, dtype=dtype, device=dev),
        "a_log": torch.log(a)[None, :].repeat(di, 1),   # (di, N)
        "d_skip": torch.ones(di, dtype=dtype, device=dev),
        "out_proj": out_proj,
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: u (B,S,di), w (K,di); the taps summed in the
    reference's order."""
    k = w.shape[0]
    pad = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                      device=u.device)
    up = torch.cat([pad, u], dim=1)
    s = u.shape[1]
    out = sum(up[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _ssm_params_from_u(params: Dict, cfg: SSMConfig, u: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """u (B,S,di) -> dt (B,S,di), Bm (B,S,N), Cm (B,S,N)."""
    r, n = cfg.rank, cfg.d_state
    proj = u @ params["x_proj"]
    # a contiguous copy of the strided slice: a plan captured with a
    # symbolic b cannot prove it folds into one 2-D product, so it would
    # run a batched product where the eager step runs one, and on the card
    # the two round differently
    dt = F.softplus(proj[..., :r].contiguous() @ params["dt_proj"]
                    + params["dt_bias"])
    return dt, proj[..., r:r + n], proj[..., r + n:]


def _combine(x: List[torch.Tensor], y: List[torch.Tensor]
             ) -> List[torch.Tensor]:
    """The reference's combine: (la1, b1), (la2, b2) ->
    (la1 + la2, b1 * exp(la2) + b2)."""
    (la1, b1), (la2, b2) = x, y
    return [la1 + la2, b1 * torch.exp(la2) + b2]


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along dim 1 (``a`` as long as ``b`` or
    one longer)."""
    m = b.shape[1]
    pairs = torch.stack([a[:, :m], b], dim=2).flatten(1, 2)
    return pairs if a.shape[1] == m else torch.cat([pairs, a[:, m:]], dim=1)


def _associative_scan(elems: List[torch.Tensor]) -> List[torch.Tensor]:
    """Inclusive scan of ``_combine`` along dim 1 by the odd-even
    recursion of ``jax.lax.associative_scan``: pairs combined, the half
    scanned, the even positions completed from it, the two interleaved."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd],
                        [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _chunk_scan(log_a: torch.Tensor, bu: torch.Tensor, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Associative scan within a chunk.

    log_a, bu: (B, Q, di, N); h0: (B, di, N).
    h_t = exp(log_a_t) * h_{t-1} + bu_t
    Returns hs (B, Q, di, N) and final h (B, di, N).
    """
    la_c, b_c = _associative_scan([log_a, bu])
    hs = torch.exp(la_c) * h0[:, None] + b_c
    return hs, hs[:, -1]


def selective_scan_chunked(u: torch.Tensor, dt: torch.Tensor,
                           a_log: torch.Tensor, bm: torch.Tensor,
                           cm: torch.Tensor, d_skip: torch.Tensor,
                           h0: Optional[torch.Tensor] = None,
                           chunk: int = 256
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u,dt (B,S,di); bm,cm (B,S,N); returns y (B,S,di), h_final (B,di,N).

    The chunk split needs a concrete S: a symbolic one (``optimize`` with
    ``s`` dynamic) raises here, where the reference's ``min(chunk, s)``
    stops on an inconclusive comparison (``repro/models/ssm.py:100``)."""
    b, s, di = u.shape
    if not isinstance(s, int):
        raise ValueError(
            f"selective_scan_chunked: the sequence length {s} is symbolic; "
            f"the chunk split min({chunk}, s) needs a concrete one")
    n = bm.shape[-1]
    q = min(chunk, s)
    nchunks = -(-s // q)
    s_pad = nchunks * q
    if s_pad != s:
        u, dt, bm, cm = (F.pad(t, (0, 0, 0, s_pad - s))
                         for t in (u, dt, bm, cm))
    h = h0 if h0 is not None else torch.zeros(
        (b, di, n), dtype=torch.float32, device=u.device)
    a = -torch.exp(a_log.to(torch.float32))               # (di, N)
    ys = []
    for c in range(nchunks):
        sl = slice(c * q, (c + 1) * q)
        uc, dtc, bmc, cmc = u[:, sl], dt[:, sl], bm[:, sl], cm[:, sl]
        log_ac = dtc.to(torch.float32)[..., None] * a      # (B,Q,di,N)
        buc = (dtc * uc).to(torch.float32)[..., None] * bmc[:, :, None, :]
        hs, h = _chunk_scan(log_ac, buc, h)
        del log_ac, buc
        # the reference's einsum "bqdn,bqn->bqd" as a batched product: an
        # einsum over a size-1 batch takes another path than over b > 1,
        # so a plan captured with a symbolic b would not be bitwise at b = 1
        yc = torch.matmul(hs, cmc.to(torch.float32)[..., None])[..., 0]
        del hs
        yc = yc + uc.to(torch.float32) * d_skip[None, None, :]
        ys.append(yc.to(u.dtype))
    y = torch.cat(ys, dim=1) if nchunks > 1 else ys[0]
    return y[:, :s], h


def _depthwise_conv(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's ``einsum("bkd,kd->bd")`` over the last K inputs,
    (B, K, di) -> (B, 1, di), as a product and a sum over K: the einsum
    picks its operand layouts by which dims are 1, so at b = 1 the eager
    step and a plan captured with a symbolic b would hand the next product
    differently strided inputs, which round differently."""
    return (window * w).sum(dim=1, keepdim=True)


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, K-1, di) last inputs
    h: torch.Tensor      # (B, di, N) f32


def ssm_apply(params: Dict, cfg: SSMConfig, x: torch.Tensor,
              chunk: Optional[int] = None) -> torch.Tensor:
    """Full-sequence forward (training/prefill). x (B,S,D) -> (B,S,D)."""
    u, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    u = F.silu(_causal_conv(u, params["conv_w"], params["conv_b"]))
    dt, bm, cm = _ssm_params_from_u(params, cfg, u)
    y, _ = selective_scan_chunked(u, dt, params["a_log"], bm, cm,
                                  params["d_skip"].to(torch.float32),
                                  chunk=chunk or cfg.chunk)
    return (y * F.silu(z)) @ params["out_proj"]


def ssm_init_cache(cfg: SSMConfig, batch: int, dtype: torch.dtype,
                   device=None) -> SSMCache:
    return SSMCache(
        conv=torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_inner),
                         dtype=dtype, device=device),
        h=torch.zeros((batch, cfg.d_inner, cfg.d_state),
                      dtype=torch.float32, device=device))


def ssm_decode_step(params: Dict, cfg: SSMConfig, x: torch.Tensor,
                    cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One token: x (B,1,D) -> (B,1,D), O(1) state update."""
    u, z = (x @ params["in_proj"]).chunk(2, dim=-1)        # (B,1,di)
    window = torch.cat([cache.conv, u], dim=1)             # (B,K,di)
    u_conv = _depthwise_conv(window, params["conv_w"]) + params["conv_b"]
    u_conv = F.silu(u_conv)
    dt, bm, cm = _ssm_params_from_u(params, cfg, u_conv)
    a = -torch.exp(params["a_log"].to(torch.float32))
    log_a = dt[:, 0].to(torch.float32)[..., None] * a                # (B,di,N)
    bu = (dt[:, 0] * u_conv[:, 0]).to(torch.float32)[..., None] * \
        bm[:, 0][:, None, :]
    h = torch.exp(log_a) * cache.h + bu
    y = torch.einsum("bdn,bn->bd", h, cm[:, 0].to(torch.float32)) + \
        u_conv[:, 0].to(torch.float32) * params["d_skip"]
    y = (y[:, None, :].to(x.dtype) * F.silu(z)) @ params["out_proj"]
    return y, SSMCache(conv=window[:, 1:], h=h)
