"""Top-level language model: init / forward / loss / prefill and the
cached decode (dense and MoE families), in the reference's three input
modes (``repro/models/lm.py:54-311``): ``tokens``; ``embeddings``
(musicgen: frame embeddings in, an ``n_codebooks``-way head out, logits
``(B, S, K, V)``); ``vlm`` (internvl2: ``vis_tokens`` patch embeddings
before the text tokens, the loss over the text positions only).  MoE
layers add their aux load-balance loss, summed over the layers
(``forward_aux``), to ``loss_fn`` at 0.01; MLA layers decode over a
latent cache (``MLACache``); hybrid layers (hymba) carry an SSM state
(``SSMCache``) beside their KV cache and a per-layer sliding window
(``layer_windows``) in the forward and the decode.  The xLSTM family
(``block_kind="xlstm"``) has no transformer block: groups of mLSTM
layers, each group closed by an sLSTM layer (``xlstm_meta``), decoding
over an ``MLSTMCache`` / ``SLSTMCache`` a layer (``DecodeState.xlstm``).

Layers are unrolled in Python, as the reference does with
``scan_layers=False`` (``repro/models/lm.py:134-143``): the flat graph is
what the dynamic-shape optimizer schedules and plans.  The reference
scans an xLSTM group's mLSTM layers whatever ``scan_layers`` says
(``:171-175``); the port unrolls those too.  Parameters are a plain dict
of tensors (the reference's pytree layout, with the per-layer stacks
split into lists: ``layers[i]``, or for xLSTM ``mlstm[g][j]`` and
``slstm[g]``), so a step ``fn(params, batch)`` takes its weights as graph
inputs, as the reference's steps do.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.api import resolve_device
from .attention import KVCache
from .blocks import (BlockCache, block_apply, block_decode, block_init,
                     check_family)
from .common import (MetaGenerator, dense_init, embed_init, rms_norm,
                     softmax_cross_entropy)
from .mla import MLACache
from .ssm import ssm_init_cache
from .xlstm import (mlstm_apply, mlstm_decode_step, mlstm_init,
                    mlstm_init_cache, slstm_apply, slstm_decode_step,
                    slstm_init, slstm_init_cache)

MOE_AUX_WEIGHT = 0.01   # the reference's loss_fn (repro/models/lm.py:202)
GLOBAL_WINDOW = 2 ** 30  # a global layer's window: effectively unbounded


def layer_windows(cfg: ModelConfig) -> Optional[List[int]]:
    """hymba-style (``repro/models/lm.py:31-39``): the config's sliding
    window at every layer except {first, middle, last}, which get
    ``GLOBAL_WINDOW``; None without a window."""
    if cfg.window is None:
        return None
    w = [cfg.window] * cfg.n_layers
    for g in {0, cfg.n_layers // 2, cfg.n_layers - 1}:
        w[g] = GLOBAL_WINDOW
    return w


def xlstm_meta(cfg: ModelConfig) -> Dict[str, int]:
    """The xLSTM layer groups (``repro/models/lm.py:42-46``): ``n_s``
    sLSTM layers, one closing each of ``n_groups`` groups of
    ``m_per_group`` mLSTM layers."""
    n_s = cfg.n_layers // cfg.slstm_every if cfg.slstm_every else 0
    n_groups = max(n_s, 1)
    m_per_group = (cfg.n_layers - n_s) // n_groups
    return dict(n_groups=n_groups, m_per_group=m_per_group, n_s=n_s)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Any = None) -> Dict[str, Any]:
    """Random weights drawn from a seeded ``torch.Generator`` on ``device``
    (``cuda`` unless given; ``meta``: shapes and dtypes, nothing
    allocated)."""
    dev = resolve_device(device)
    gen = MetaGenerator() if dev.type == "meta" else \
        torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = cfg.torch_dtype
    vpad = cfg.padded_vocab
    p: Dict[str, Any] = {}
    if cfg.input_mode in ("tokens", "vlm"):
        p["embed"] = embed_init(gen, (vpad, cfg.d_model), dtype)
    if not cfg.tie_embeddings or cfg.input_mode == "embeddings":
        p["lm_head"] = dense_init(
            gen, (cfg.d_model, max(cfg.n_codebooks, 1) * vpad), dtype)
    p["final_norm"] = torch.zeros(cfg.d_model, dtype=dtype, device=dev)
    if cfg.block_kind == "xlstm":
        xc, meta = cfg.xlstm_config(), xlstm_meta(cfg)
        p["mlstm"] = [[mlstm_init(gen, xc, dtype)
                       for _ in range(meta["m_per_group"])]
                      for _ in range(meta["n_groups"])]
        if meta["n_s"]:
            p["slstm"] = [slstm_init(gen, xc, dtype)
                          for _ in range(meta["n_s"])]
        return p
    p["layers"] = [block_init(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    return p


def _mask_pad_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Pad-vocab columns (table padded to a tile boundary) never win."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    col = torch.arange(cfg.padded_vocab, device=logits.device)
    return torch.where(col < cfg.vocab, logits,
                       torch.full((), -1e30, dtype=logits.dtype,
                                  device=logits.device))


def _embed_inputs(cfg: ModelConfig, params: Dict,
                  batch: Dict) -> torch.Tensor:
    """The first hidden state (B, S, D): token embeddings, frame
    embeddings, or the vision prefix ``vis_embed`` (B, vis_tokens, D)
    followed by the text's token embeddings."""
    dtype = cfg.torch_dtype
    if cfg.input_mode == "tokens":
        return F.embedding(batch["tokens"], params["embed"]).to(dtype)
    if cfg.input_mode == "embeddings":
        return batch["frame_embed"].to(dtype)
    if cfg.input_mode == "vlm":
        txt = F.embedding(batch["tokens"], params["embed"]).to(dtype)
        return torch.cat([batch["vis_embed"].to(dtype), txt], dim=1)
    raise ValueError(cfg.input_mode)


def _lm_logits(cfg: ModelConfig, params: Dict, h: torch.Tensor,
               impl: Optional[str]) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], impl=impl)
    if cfg.n_codebooks:
        b, s, _ = h.shape
        logits = (h @ params["lm_head"].to(h.dtype)).reshape(
            b, s, cfg.n_codebooks, cfg.padded_vocab)
        return _mask_pad_vocab(cfg, logits)
    w = params["embed"].t() \
        if cfg.tie_embeddings and cfg.input_mode != "embeddings" \
        else params["lm_head"]
    return _mask_pad_vocab(cfg, h @ w.to(h.dtype))


def _xlstm_forward(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                   impl: Optional[str]) -> torch.Tensor:
    """Each group's mLSTM layers, then its sLSTM layer, each on its own
    pre-norm with a residual (``repro/models/lm.py:164-179``)."""
    xc, meta = cfg.xlstm_config(), xlstm_meta(cfg)
    for g in range(meta["n_groups"]):
        for lp in params["mlstm"][g]:
            x = x + mlstm_apply(lp, xc, rms_norm(x, lp["ln"], impl=impl),
                                impl=impl)
        if meta["n_s"]:
            sp = params["slstm"][g]
            x = x + slstm_apply(sp, xc, rms_norm(x, sp["ln"], impl=impl))
    return x


def _forward(cfg: ModelConfig, params: Dict, batch: Dict,
             impl: Optional[str]
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(logits, the MoE aux summed over the layers, or None if dense or
    xLSTM)."""
    x = _embed_inputs(cfg, params, batch)
    if cfg.block_kind == "xlstm":
        return _lm_logits(cfg, params, _xlstm_forward(cfg, params, x, impl),
                          impl), None
    aux = None
    windows = layer_windows(cfg) or [None] * cfg.n_layers
    for layer_p, w in zip(params["layers"], windows):
        x, a = block_apply(layer_p, cfg, x, window=w, impl=impl)
        if a is not None:
            aux = a if aux is None else aux + a
    return _lm_logits(cfg, params, x, impl), aux


def forward(cfg: ModelConfig, params: Dict, batch: Dict,
            impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence logits (B, S, V), or (B, S, K, V) with ``K =
    n_codebooks``; in ``vlm`` mode S counts the vision prefix too.
    ``impl`` picks the kernel ops' implementation (``None``: by device;
    ``"ref"``: plain PyTorch)."""
    return _forward(cfg, params, batch, impl)[0]


def forward_aux(cfg: ModelConfig, params: Dict, batch: Dict,
                impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``forward``: (logits, the f32 MoE aux loss summed
    over the layers; 0 for a dense or xLSTM model)."""
    logits, aux = _forward(cfg, params, batch, impl)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict,
            impl: Optional[str] = None) -> torch.Tensor:
    """Mean next-token cross entropy against ``batch["labels"]``
    (``repro/models/lm.py:193``), plus 0.01 x the MoE aux loss for an MoE
    model (a dense one adds nothing): over the text positions only in
    ``vlm`` mode, and over (B, S, K) labels with a codebook head (which
    takes no mask, as the reference's)."""
    logits, aux = _forward(cfg, params, batch, impl)
    labels = batch["labels"]
    if cfg.input_mode == "vlm":
        logits = logits[:, -labels.shape[1]:]
    if cfg.n_codebooks:
        loss = softmax_cross_entropy(logits, labels)
    else:
        loss = softmax_cross_entropy(logits, labels, batch.get("mask"))
    return loss if aux is None else loss + MOE_AUX_WEIGHT * aux


def prefill(cfg: ModelConfig, params: Dict, batch: Dict,
            impl: Optional[str] = None) -> torch.Tensor:
    """Forward over the prompt; returns last-position logits (B, V), or
    (B, K, V) with a codebook head."""
    return forward(cfg, params, batch, impl)[:, -1]


# -- serving: single-token decode over a KV cache ----------------------------


class DecodeState(NamedTuple):
    """The running decode state: one ``BlockCache`` per layer (the
    reference stacks them on a leading layer axis for its scan; the port
    unrolls its layers, so it keeps a list); for xLSTM ``caches`` is None
    and ``xlstm`` holds (``MLSTMCache`` lists ``[g][j]``, ``SLSTMCache``
    list ``[g]``)."""
    caches: Optional[List[BlockCache]]
    xlstm: Any = None


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Any = None) -> DecodeState:
    """Zeroed caches of ``max_len`` rows per layer and a length of 0, on
    ``device`` (``cuda`` unless given): K/V (B, Smax, Hkv, hd), or for MLA
    the latent (B, Smax, r_kv) and the RoPE key (B, Smax, qk_rope); in the
    hybrid family also an ``SSMCache`` a layer (the last K-1 conv inputs,
    the f32 state); ``repro/models/lm.py:213-242``.  xLSTM: an
    ``MLSTMCache`` an mLSTM layer (the conv inputs, the f32 C (B, H, hd,
    hd), n, m) and an ``SLSTMCache`` an sLSTM layer; no KV cache, so
    ``max_len`` is unused."""
    check_family(cfg)
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    if cfg.block_kind == "xlstm":
        xc, meta = cfg.xlstm_config(), xlstm_meta(cfg)
        return DecodeState(caches=None, xlstm=(
            [[mlstm_init_cache(xc, batch, dt, device=dev)
              for _ in range(meta["m_per_group"])]
             for _ in range(meta["n_groups"])],
            [slstm_init_cache(xc, batch, device=dev)
             for _ in range(meta["n_s"])]))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def length():
        return torch.zeros((), dtype=torch.int32, device=dev)

    if cfg.attn_kind == "mla":
        return DecodeState(caches=[
            BlockCache(kv=MLACache(c_kv=zeros(batch, max_len, cfg.r_kv),
                                   k_rope=zeros(batch, max_len, cfg.qk_rope),
                                   length=length()))
            for _ in range(cfg.n_layers)])
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)

    def ssm():
        if cfg.family != "hybrid":
            return None
        return ssm_init_cache(cfg.ssm_config(), batch, dt, device=dev)

    return DecodeState(caches=[
        BlockCache(kv=KVCache(k=zeros(*shape), v=zeros(*shape),
                              length=length()), ssm=ssm())
        for _ in range(cfg.n_layers)])


def decode_step(cfg: ModelConfig, params: Dict, state: DecodeState,
                inp: Dict) -> Tuple[torch.Tensor, DecodeState]:
    """One new token ``inp["token"]`` (B,1), or one frame
    ``inp["frame_embed"]`` (B,1,D) in ``embeddings`` mode, against the
    running cache -> (logits (B,1,V) or (B,1,K,V), the new state).  Layers
    unrolled, each with its window (``layer_windows``); each layer's cache
    is written out of place (``attention.kv_cache_update``,
    ``mla.mla_cache_update``; an SSM or xLSTM state is replaced), so the
    step is functional: ``serve`` runs it eagerly or as one ``optimize``
    plan with a symbolic batch.  RMSNorm
    runs its kernel op (the mLSTM's output norm too, in f32); decode
    attention (GQA or absorbed MLA), the SSM and xLSTM steps and the MoE
    are plain PyTorch, as the reference's are plain jnp."""
    if cfg.input_mode in ("tokens", "vlm"):
        x = F.embedding(inp["token"], params["embed"]).to(cfg.torch_dtype)
    else:
        x = inp["frame_embed"].to(cfg.torch_dtype)
    if cfg.block_kind == "xlstm":
        x, xlstm = _xlstm_decode(cfg, params, state, x)
        return _lm_logits(cfg, params, x, None)[:, -1:], \
            DecodeState(caches=None, xlstm=xlstm)
    caches = []
    windows = layer_windows(cfg) or [None] * cfg.n_layers
    for layer_p, cache, w in zip(params["layers"], state.caches, windows):
        x, cache = block_decode(layer_p, cfg, x, cache, window=w)
        caches.append(cache)
    return _lm_logits(cfg, params, x, None)[:, -1:], DecodeState(caches)


def _xlstm_decode(cfg: ModelConfig, params: Dict, state: DecodeState,
                  x: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """One token through every group's mLSTM steps and its sLSTM step
    (``repro/models/lm.py:267-294``) -> (x, the new ``xlstm`` state)."""
    xc, meta = cfg.xlstm_config(), xlstm_meta(cfg)
    m_caches, s_caches = state.xlstm
    new_m, new_s = [], []
    for g in range(meta["n_groups"]):
        group = []
        for lp, cache in zip(params["mlstm"][g], m_caches[g]):
            y, cache = mlstm_decode_step(lp, xc, rms_norm(x, lp["ln"]), cache)
            x = x + y
            group.append(cache)
        new_m.append(group)
        if meta["n_s"]:
            sp = params["slstm"][g]
            y, cache = slstm_decode_step(sp, xc, rms_norm(x, sp["ln"]),
                                         s_caches[g])
            x = x + y
            new_s.append(cache)
    return x, (new_m, new_s)
