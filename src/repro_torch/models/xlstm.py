"""xLSTM blocks: the chunkwise mLSTM (matrix memory) and the sLSTM (scalar
memory); the port of ``repro/models/xlstm.py``.

The mLSTM's full-sequence forward (``mlstm_chunkwise``) is the stabilised
chunkwise form: within a chunk a (Q x Q) decay-masked score matrix, across
chunks the f32 (hd x hd) matrix memory ``C``, its normaliser ``n`` and the
log-space stabiliser ``m``.  The chunks are walked in a Python loop with
one chunk's state alive at a time, as the reference's ``lax.scan`` over
chunks does (``:141-144``).  Decode (``mlstm_decode_step``) is the O(1)
recurrence over an ``MLSTMCache``.  The sLSTM (``slstm_apply``) is a
recurrence over time in the reference too (a ``lax.scan``, ``:259-271``):
here a Python loop over the steps, its gates computed for the whole
sequence before it, so the loop body is elementwise only.

All of it is plain PyTorch, as the reference is plain jnp, except the
mLSTM's output norm: the reference writes ``rms_norm``'s function inline
there (``:170-173``, ``:220-221``), and the port calls the RMSNorm kernel
op, as it does for every norm.  One rounding differs: in a bf16 model the
reference forms ``1 + out_norm`` in bf16, the op in f32, so the two agree
exactly at ``out_norm``'s zero init and by at most one bf16 ulp of
``1 + out_norm`` a column elsewhere.

Dtypes follow the reference's, with its promotions written out (torch's
``matmul`` does not promote): the gate weights are f32 whatever the model
dtype, and the activations they multiply are cast to f32.  The chunk's
contractions take bf16 operands into an f32 result in the reference
(``preferred_element_type``); here the operands are rounded exactly where
the reference rounds them (P, ``w_intra``, ``kw`` and the carried ``C`` to
the model dtype) and then multiplied as f32, which is exact for bf16
inputs.  The contractions are batched ``matmul``s: a captured ``einsum``
over a size-1 batch takes another path than eager's (see
``ssm.selective_scan_chunked``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import dense_init, rms_norm
from .ssm import _causal_conv, _depthwise_conv

NEG_INF = -1e30   # not -inf: m_p + F - m_t must stay finite


class XLSTMConfig(NamedTuple):
    d_model: int
    n_heads: int = 4
    proj_factor: float = 2.0
    chunk: int = 128
    conv_kernel: int = 4

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


# -- mLSTM ---------------------------------------------------------------------


def mlstm_init(gen: torch.Generator, cfg: XLSTMConfig,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The reference's ``mlstm_init`` leaves, the random ones drawn from
    ``gen`` in its key order; the gate weights and biases are f32 whatever
    ``dtype``."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    dev, f32 = gen.device, torch.float32
    up_proj = dense_init(gen, (d, 2 * di), dtype)
    conv_w = dense_init(gen, (cfg.conv_kernel, di), dtype)
    wq, wk, wv = (dense_init(gen, (di, di), dtype) for _ in range(3))
    w_igate = dense_init(gen, (di, h), f32)
    w_fgate = dense_init(gen, (di, h), f32)
    down_proj = dense_init(gen, (di, d), dtype)
    return {
        "ln": torch.zeros(d, dtype=dtype, device=dev),
        "up_proj": up_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(di, dtype=dtype, device=dev),
        "wq": wq, "wk": wk, "wv": wv,
        "w_igate": w_igate,
        "b_igate": torch.zeros(h, dtype=f32, device=dev),
        "w_fgate": w_fgate,
        "b_fgate": torch.full((h,), 3.0, dtype=f32, device=dev),
        "out_norm": torch.zeros(di, dtype=dtype, device=dev),
        "down_proj": down_proj,
    }


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, di) -> (B, H, S, hd)."""
    b, s, di = x.shape
    return x.reshape(b, s, h, di // h).transpose(1, 2)


def _f32(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and held as f32: a bf16 operand of the
    reference's f32-accumulating contractions."""
    return t.to(dtype).to(torch.float32)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_i: torch.Tensor, log_f: torch.Tensor,
                    state: Optional[Tuple[torch.Tensor, ...]] = None,
                    chunk: int = 128
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Stabilised chunkwise mLSTM.

    q, k, v: (B, H, S, hd); log_i, log_f: (B, H, S) f32.  ``state``:
    (C (B, H, hd, hd), n (B, H, hd), m (B, H)), f32, or None.  Returns h
    (B, H, S, hd) in q's dtype and the final state.

    The chunk split needs a concrete S: a symbolic one (``optimize`` with
    ``s`` dynamic) raises here, where the reference's ``min(chunk, s)``
    stops on an inconclusive comparison (``repro/models/xlstm.py:81``)."""
    b, h, s, hd = q.shape
    if not isinstance(s, int):
        raise ValueError(
            f"mlstm_chunkwise: the sequence length {s} is symbolic; the "
            f"chunk split min({chunk}, s) needs a concrete one")
    dt, f32 = q.dtype, torch.float32
    qc = min(chunk, s)
    nch = -(-s // qc)
    if nch * qc != s:
        pad = nch * qc - s
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, pad), value=NEG_INF)
        log_f = F.pad(log_f, (0, pad))
    if state is None:
        c_p = torch.zeros((b, h, hd, hd), dtype=f32, device=q.device)
        n_p = torch.zeros((b, h, hd), dtype=f32, device=q.device)
        m_p = torch.full((b, h), NEG_INF, dtype=f32, device=q.device)
    else:
        c_p, n_p, m_p = state
    scale = 1.0 / math.sqrt(hd)
    tri = torch.ones((qc, qc), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c in range(nch):
        sl = slice(c * qc, (c + 1) * qc)
        qx, kx, vx = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        lix, lfx = log_i[..., sl], log_f[..., sl]
        qf, kf, vf = qx.to(f32), kx.to(f32), vx.to(f32)
        fc = torch.cumsum(lfx, dim=-1)                      # decay incl. t
        # log decay matrix: D[t, j] = F_t - F_j + li_j (j <= t)
        logd = fc[..., :, None] - fc[..., None, :] + lix[..., None, :]
        logd = torch.where(tri, logd, NEG_INF)
        m_t = torch.maximum(m_p[..., None] + fc, logd.amax(dim=-1))
        w_intra = torch.exp(logd - m_t[..., None])          # (B,H,Q,Q)
        sc = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        num = torch.matmul(_f32(sc * w_intra, dt), vf)
        # the denominator |q . n_t|: n_t the decayed n_p plus sum_j w k_j
        w_inter = torch.exp(m_p[..., None] + fc - m_t)      # (B,H,Q)
        num = num + w_inter[..., None] * torch.matmul(
            qf, _f32(c_p, dt)) * scale
        n_t = w_inter[..., None] * n_p[:, :, None, :] + torch.matmul(
            _f32(w_intra, dt), kf)
        den = torch.abs((qf * scale * n_t).sum(dim=-1))
        hx = num / torch.maximum(den, torch.exp(-m_t))[..., None]
        hs.append(hx.to(dt))
        # the carry
        tot = fc[..., -1]                                   # (B,H)
        m_out = torch.maximum(m_p + tot,
                              (tot[..., None] - fc + lix).amax(dim=-1))
        decay_c = torch.exp(m_p + tot - m_out)
        w_k = torch.exp(tot[..., None] - fc + lix - m_out[..., None])
        kw = kf * w_k[..., None]
        c_p = decay_c[..., None, None] * c_p + torch.matmul(
            _f32(kw, dt).transpose(-1, -2), vf)
        n_p = decay_c[..., None] * n_p + kw.sum(dim=2)
        m_p = m_out
    hx = torch.cat(hs, dim=2) if nch > 1 else hs[0]
    return hx[:, :, :s], (c_p, n_p, m_p)


def mlstm_apply(params: Dict, cfg: XLSTMConfig, x: torch.Tensor,
                impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence mLSTM block: x (B, S, D) -> (B, S, D).  ``impl``
    picks the output norm's implementation (the RMSNorm op's)."""
    b, s, _ = x.shape
    main, z = (x @ params["up_proj"]).chunk(2, dim=-1)     # (B,S,di)
    conv = F.silu(_causal_conv(main, params["conv_w"], params["conv_b"]))
    h = cfg.n_heads
    q = _heads(conv @ params["wq"], h)
    k = _heads(conv @ params["wk"], h)
    v = _heads(main @ params["wv"], h)
    conv32 = conv.to(torch.float32)
    log_i = (conv32 @ params["w_igate"] + params["b_igate"]).transpose(1, 2)
    log_f = F.logsigmoid(conv32 @ params["w_fgate"]
                         + params["b_fgate"]).transpose(1, 2)
    hx, _ = mlstm_chunkwise(q, k, v, log_i, log_f, chunk=cfg.chunk)
    hx = hx.transpose(1, 2).reshape(b, s, cfg.d_inner)
    hx = rms_norm(hx, params["out_norm"], impl=impl)
    return (hx * F.silu(z)) @ params["down_proj"]


class MLSTMCache(NamedTuple):
    conv: torch.Tensor   # (B, K-1, di) last inputs
    c: torch.Tensor      # (B, H, hd, hd) f32
    n: torch.Tensor      # (B, H, hd) f32
    m: torch.Tensor      # (B, H) f32


def mlstm_init_cache(cfg: XLSTMConfig, batch: int, dtype: torch.dtype,
                     device=None) -> MLSTMCache:
    h, hd, f32 = cfg.n_heads, cfg.head_dim, torch.float32
    return MLSTMCache(
        conv=torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_inner),
                         dtype=dtype, device=device),
        c=torch.zeros((batch, h, hd, hd), dtype=f32, device=device),
        n=torch.zeros((batch, h, hd), dtype=f32, device=device),
        m=torch.full((batch, h), NEG_INF, dtype=f32, device=device))


def mlstm_decode_step(params: Dict, cfg: XLSTMConfig, x: torch.Tensor,
                      cache: MLSTMCache) -> Tuple[torch.Tensor, MLSTMCache]:
    """One token: x (B, 1, D) -> (B, 1, D), the O(1) recurrent update.  The
    output norm's input is f32 here (the state's dtype), so it is an f32
    RMSNorm on B rows whatever the model dtype, cast to x's dtype after."""
    f32 = torch.float32
    main, z = (x @ params["up_proj"]).chunk(2, dim=-1)
    # a contiguous copy of the chunk: a plan captured with a symbolic b
    # cannot prove the strided chunk folds into one 2-D product, so it
    # would run ``main @ wv`` as a batched product where the eager step
    # runs it as one, and the two round differently
    main = main.contiguous()
    window = torch.cat([cache.conv, main], dim=1)          # (B,K,di)
    conv = _depthwise_conv(window, params["conv_w"]) + params["conv_b"]
    conv = F.silu(conv)
    h, hd = cfg.n_heads, cfg.head_dim
    q = _heads(conv @ params["wq"], h)[:, :, 0].to(f32)    # (B,H,hd)
    k = _heads(conv @ params["wk"], h)[:, :, 0].to(f32)
    v = _heads(main @ params["wv"], h)[:, :, 0].to(f32)
    conv32 = conv.to(f32)
    li = (conv32 @ params["w_igate"] + params["b_igate"])[:, 0]      # (B,H)
    lf = F.logsigmoid(conv32 @ params["w_fgate"] + params["b_fgate"])[:, 0]
    m_new = torch.maximum(lf + cache.m, li)
    i_s = torch.exp(li - m_new)
    f_s = torch.exp(lf + cache.m - m_new)
    c_new = f_s[..., None, None] * cache.c + i_s[..., None, None] * \
        (k[..., :, None] * v[..., None, :])
    n_new = f_s[..., None] * cache.n + i_s[..., None] * k
    qs = q * (1.0 / math.sqrt(hd))
    num = torch.matmul(qs[..., None, :], c_new)[..., 0, :]
    den = torch.abs((qs * n_new).sum(dim=-1))
    hx = num / torch.maximum(den, torch.exp(-m_new))[..., None]   # (B,H,hd)
    hx = rms_norm(hx.reshape(x.shape[0], 1, cfg.d_inner),
                  params["out_norm"].to(f32)).to(x.dtype)
    out = (hx * F.silu(z)) @ params["down_proj"]
    return out, MLSTMCache(conv=window[:, 1:], c=c_new, n=n_new, m=m_new)


# -- sLSTM ---------------------------------------------------------------------


def slstm_init(gen: torch.Generator, cfg: XLSTMConfig,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The reference's ``slstm_init`` leaves in its key order; ``w_i``,
    ``w_f`` and ``b_f`` are f32 whatever ``dtype``."""
    d, di = cfg.d_model, cfg.d_inner
    dev, f32 = gen.device, torch.float32
    w_z = dense_init(gen, (d, di), dtype)
    w_i = dense_init(gen, (d, di), f32)
    w_f = dense_init(gen, (d, di), f32)
    w_o = dense_init(gen, (d, di), dtype)
    down_proj = dense_init(gen, (di, d), dtype)
    return {
        "ln": torch.zeros(d, dtype=dtype, device=dev),
        "w_z": w_z, "w_i": w_i, "w_f": w_f,
        "b_f": torch.full((di,), 3.0, dtype=f32, device=dev),
        "w_o": w_o,
        "down_proj": down_proj,
    }


class SLSTMCache(NamedTuple):
    c: torch.Tensor      # (B, di) f32
    n: torch.Tensor
    m: torch.Tensor


def _slstm_gates(params: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """z, log i, log f, o in f32 for x (..., D)."""
    x32 = x.to(torch.float32)
    z = torch.tanh(x @ params["w_z"]).to(torch.float32)
    li = x32 @ params["w_i"]
    lf = F.logsigmoid(x32 @ params["w_f"] + params["b_f"])
    o = torch.sigmoid((x @ params["w_o"]).to(torch.float32))
    return z, li, lf, o


def _slstm_cell(zt, lit, lft, ot, c, n, m):
    """One step of the stabilised exponential-gated cell -> (h, c, n, m)."""
    m_new = torch.maximum(lft + m, lit)
    i_s = torch.exp(lit - m_new)
    f_s = torch.exp(lft + m - m_new)
    c_new = f_s * c + i_s * zt
    n_new = f_s * n + i_s
    return ot * c_new / torch.clamp(n_new, min=1e-6), c_new, n_new, m_new


def slstm_init_cache(cfg: XLSTMConfig, batch: int,
                     device=None) -> SLSTMCache:
    di, f32 = cfg.d_inner, torch.float32
    return SLSTMCache(torch.zeros((batch, di), dtype=f32, device=device),
                      torch.zeros((batch, di), dtype=f32, device=device),
                      torch.full((batch, di), NEG_INF, dtype=f32,
                                 device=device))


def slstm_apply(params: Dict, cfg: XLSTMConfig, x: torch.Tensor,
                state: Optional[SLSTMCache] = None) -> torch.Tensor:
    """Scalar-memory LSTM with exponential gating over S: x (B, S, D) ->
    (B, S, D).  The gates for every step first, then a Python loop over
    the steps, as the reference's scan."""
    b, s, _ = x.shape
    z, li, lf, o = _slstm_gates(params, x)
    c, n, m = state if state is not None else \
        slstm_init_cache(cfg, b, device=x.device)
    hs = []
    for t in range(s):
        h, c, n, m = _slstm_cell(z[:, t], li[:, t], lf[:, t], o[:, t],
                                 c, n, m)
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype) @ params["down_proj"]


def slstm_decode_step(params: Dict, cfg: XLSTMConfig, x: torch.Tensor,
                      cache: SLSTMCache) -> Tuple[torch.Tensor, SLSTMCache]:
    """One token: x (B, 1, D) -> (B, 1, D)."""
    z, li, lf, o = _slstm_gates(params, x[:, 0])
    h, c, n, m = _slstm_cell(z, li, lf, o, *cache)
    return (h.to(x.dtype) @ params["down_proj"])[:, None, :], \
        SLSTMCache(c, n, m)
