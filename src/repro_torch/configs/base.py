"""ModelConfig: the reference's config (``repro/configs/base.py``) for
every family the port runs.

Field names and defaults follow the reference.  Here: the dense family's
three input modes, ``tokens``, ``embeddings`` (musicgen's frame
embeddings, with an ``n_codebooks``-way head) and ``vlm`` (internvl2's
``vis_tokens`` patch embeddings before the text); the MoE FFN
(``n_experts``, ``top_k``, ``n_shared``, ``moe_capacity``);
DeepSeek-style multi-head latent attention (``attn_kind="mla"`` with its
widths, ``mla_config()``); the hybrid family (hymba): a selective SSM
beside the attention in every layer (``ssm_state``, ``ssm_expand``,
``ssm_config()``) and sliding-window attention (``window``; the layers it
applies to come from ``models.lm.layer_windows``); and the xLSTM family
(``block_kind="xlstm"``): runs of mLSTM layers with an sLSTM every
``slstm_every``-th layer, their inner width ``xlstm_proj_factor`` x
d_model (``xlstm_config()``; the groups come from ``models.lm.xlstm_meta``).
``remat_policy`` (``none | block | full``, default ``block``; ``full``
acts as ``block``, as in the reference) and ``scan_layers`` (default
True) are the reference's training knobs with its defaults.  The port
unrolls its layers either way and keeps one parameter layout;
``scan_layers=True`` is the layer stack as the reference's compiled path
runs it, each block recomputed in the backward under ``remat_policy``
(``models.lm``), and ``scan_layers=False`` the flat graph whose remat is
left to ``optimize``, which is how every ``optimize`` caller builds its
train step, as the reference's do.  ``SHAPES``
and ``cells_for`` are the dry-run's (arch x input shape) cells.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | audio | vlm | moe | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    ffn_kind: str = "swiglu"       # swiglu | geglu
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"  # AdamW moments (bfloat16 option)
    # attention: gqa | mla
    attn_kind: str = "gqa"
    window: Optional[int] = None   # sliding-window size (hybrid layers)
    # MLA (deepseek-style): per-head q/k widths without and with RoPE, the
    # value width, the KV latent's and the query latent's ranks (r_q 0:
    # a full-rank query projection)
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128
    r_kv: int = 512
    r_q: int = 1536
    # MoE: routed experts (0: a dense FFN), experts per token, always-on
    # shared experts, per-example capacity factor
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_capacity: float = 1.25
    # SSM / hybrid: the SSM's state size (0 -> 16) and its inner width as
    # a multiple of d_model
    ssm_state: int = 0
    ssm_expand: int = 2
    # xLSTM: transformer | xlstm blocks; every k-th layer an sLSTM; the
    # mLSTM/sLSTM inner width as a multiple of d_model
    block_kind: str = "transformer"
    slstm_every: int = 8
    xlstm_proj_factor: float = 2.0
    # modality frontend (stub): tokens | embeddings | vlm
    input_mode: str = "tokens"
    n_codebooks: int = 0           # musicgen-style multi-head output
    vis_tokens: int = 256          # vlm: stub patch-embedding count
    # training / memory knobs: the backward's recompute of each block
    # (none | block | full) and the layer stack it applies to (False: the
    # flat graph the dynamic-shape optimizer plans and rematerialises)
    remat_policy: str = "block"
    scan_layers: bool = True
    # embedding-table padding to a tile boundary (pad logits masked)
    pad_vocab_to: int = 128

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // self.pad_vocab_to) * self.pad_vocab_to

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def mla_config(self):
        from ..models.mla import MLAConfig
        return MLAConfig(d_model=self.d_model, n_heads=self.n_heads,
                         qk_nope=self.qk_nope, qk_rope=self.qk_rope,
                         v_dim=self.v_dim, r_kv=self.r_kv, r_q=self.r_q,
                         rope_theta=self.rope_theta)

    def ssm_config(self):
        from ..models.ssm import SSMConfig
        return SSMConfig(d_model=self.d_model,
                         d_inner=self.ssm_expand * self.d_model,
                         d_state=self.ssm_state or 16)

    def xlstm_config(self):
        from ..models.xlstm import XLSTMConfig
        return XLSTMConfig(d_model=self.d_model, n_heads=self.n_heads,
                           proj_factor=self.xlstm_proj_factor)

    def param_count(self, active_only: bool = False) -> int:
        """Parameters, or with ``active_only`` those a token runs through
        (``top_k`` of the routed experts)."""
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
        if self.block_kind == "xlstm":
            di = int(self.xlstm_proj_factor * d)
            per_m = d * 2 * di + 3 * di * di + di * d + 2 * di * self.n_heads
            per_s = 4 * d * di + di * d
            n_s = self.n_layers // self.slstm_every if self.slstm_every else 0
            layers = per_m * (self.n_layers - n_s) + per_s * n_s
            return layers + self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.attn_kind == "mla":
            h = self.n_heads
            attn = (d * self.r_q + self.r_q * h * (self.qk_nope + self.qk_rope)
                    + d * self.r_kv + self.r_kv * h * (self.qk_nope + self.v_dim)
                    + d * self.qk_rope + h * self.v_dim * d)
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
        if self.n_experts:
            n_exp = self.top_k if active_only else self.n_experts
            ffn = (n_exp + self.n_shared) * 3 * d * f + d * self.n_experts
        else:
            ffn = 3 * d * f
        if self.family == "hybrid":
            di = self.ssm_expand * d
            r = -(-d // 16)
            ffn += d * 2 * di + di * (r + 2 * (self.ssm_state or 16)) \
                + r * di + di * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.n_codebooks:
            emb += self.n_codebooks * d * self.vocab
        return self.n_layers * (attn + ffn) + emb


# -- input shape sets (``repro/configs/base.py:145-166``) ---------------------

SHAPES: Dict[str, Dict] = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# long_500k requires sub-quadratic attention: only SSM/hybrid run it.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def cells_for(cfg: ModelConfig):
    """The (shape_name, spec) cells this arch runs; skips are recorded."""
    out = []
    for name, spec in SHAPES.items():
        if name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES \
                and cfg.block_kind != "xlstm":
            out.append((name, dict(spec, skip="full-attention arch: no "
                                   "sub-quadratic mechanism at 500k")))
        else:
            out.append((name, dict(spec, skip=None)))
    return out
