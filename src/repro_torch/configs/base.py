"""ModelConfig: the dense and MoE subset of the reference's config.

Field names and defaults follow ``repro/configs/base.py``; the fields of
the SSM, hybrid and xLSTM families arrive with those models.  Here: the
dense family's three input modes, ``tokens``, ``embeddings`` (musicgen's
frame embeddings, with an ``n_codebooks``-way head) and ``vlm``
(internvl2's ``vis_tokens`` patch embeddings before the text); the MoE
FFN (``n_experts``, ``top_k``, ``n_shared``, ``moe_capacity``); and
DeepSeek-style multi-head latent attention (``attn_kind="mla"`` with its
widths, ``mla_config()``).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | audio | vlm | moe
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
    # modality frontend (stub): tokens | embeddings | vlm
    input_mode: str = "tokens"
    n_codebooks: int = 0           # musicgen-style multi-head output
    vis_tokens: int = 256          # vlm: stub patch-embedding count
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

    def param_count(self, active_only: bool = False) -> int:
        """Parameters, or with ``active_only`` those a token runs through
        (``top_k`` of the routed experts)."""
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
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
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.n_codebooks:
            emb += self.n_codebooks * d * self.vocab
        return self.n_layers * (attn + ffn) + emb
