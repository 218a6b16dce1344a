"""ModelConfig: the dense-transformer subset of the reference's config.

Field names and defaults follow ``repro/configs/base.py``; the fields of
the other architecture families (MLA, MoE, SSM, xLSTM) arrive with those
models.  The dense family's three input modes are here: ``tokens``,
``embeddings`` (musicgen's frame embeddings, with an ``n_codebooks``-way
head) and ``vlm`` (internvl2's ``vis_tokens`` patch embeddings before the
text).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | audio | vlm (dense blocks)
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

    def param_count(self) -> int:
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        ffn = 3 * d * f
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.n_codebooks:
            emb += self.n_codebooks * d * self.vocab
        return self.n_layers * (attn + ffn) + emb
