"""Variable-length data pipeline (the paper's dynamic-shape workload).

Synthesizes a CodeAlpaca-20K-like length distribution (samples of ~100–3000
characters ≈ 25–750 tokens, log-uniform) with a fixed seed.  Two batching
modes reproduce the paper's comparison:

  * ``dynamic``  — fixed sample count per batch, sequences packed to the
    batch max length WITHOUT padding buckets: every iteration has a
    different (B, S) — the dynamic-shape regime.
  * ``bucketed`` — static-shape regime: lengths padded up to the nearest
    power of two (largest bucket = dataset max, as in the paper §3).

The pipeline is deterministic and resumable: ``state()`` / ``restore()``
give the exact cursor for checkpoint-restart.

A copy of ``repro/data/pipeline.py``: numpy only, so both packages draw
the same batches from the same seed.  Batches stay numpy arrays; the
trainer moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class PipelineConfig:
    vocab: int
    batch_size: int = 14
    min_tokens: int = 25
    max_tokens: int = 750
    n_samples: int = 20_000
    seed: int = 0
    mode: str = "dynamic"          # dynamic | bucketed
    pad_id: int = 0
    align: int = 8                 # dynamic mode: round max-len up (tile-friendly)


class DataPipeline:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        # log-uniform lengths ~ chars 100..3000 mapped to tokens
        u = rng.uniform(np.log(cfg.min_tokens), np.log(cfg.max_tokens),
                        size=cfg.n_samples)
        self._lengths = np.exp(u).astype(np.int64)
        self._order = rng.permutation(cfg.n_samples)
        self._cursor = 0
        self._epoch = 0
        self._rng_tokens = np.random.RandomState(cfg.seed + 1)

    # -- resumable state ---------------------------------------------------------
    def state(self) -> Dict:
        return {"cursor": int(self._cursor), "epoch": int(self._epoch),
                "seed": self.cfg.seed}

    def restore(self, state: Dict) -> None:
        assert state["seed"] == self.cfg.seed, "seed mismatch on restore"
        self._cursor = state["cursor"]
        self._epoch = state["epoch"]

    # -- batching -------------------------------------------------------------------
    @staticmethod
    def bucket_len(n: int) -> int:
        p = 1
        while p < n:
            p <<= 1
        return p

    def _next_indices(self) -> np.ndarray:
        b = self.cfg.batch_size
        if self._cursor + b > len(self._order):
            self._epoch += 1
            rng = np.random.RandomState(self.cfg.seed + 7 + self._epoch)
            self._order = rng.permutation(self.cfg.n_samples)
            self._cursor = 0
        idx = self._order[self._cursor:self._cursor + b]
        self._cursor += b
        return idx

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        idx = self._next_indices()
        lens = self._lengths[idx]
        maxlen = int(lens.max())
        if cfg.mode == "bucketed":
            maxlen = self.bucket_len(maxlen)
        else:
            a = cfg.align
            maxlen = -(-maxlen // a) * a
        toks = np.full((cfg.batch_size, maxlen), cfg.pad_id, np.int32)
        mask = np.zeros((cfg.batch_size, maxlen), np.float32)
        for r, (i, L) in enumerate(zip(idx, lens)):
            rs = np.random.RandomState(int(self.cfg.seed + 13 + i))
            toks[r, :L] = rs.randint(1, cfg.vocab, size=int(L))
            mask[r, :L] = 1.0
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = cfg.pad_id
        lmask = mask.copy()
        lmask[:, -1] = 0.0
        return {"tokens": toks, "labels": labels, "mask": lmask,
                "lengths": lens.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # -- stats (used by benchmarks) ----------------------------------------------
    def padding_waste(self, n_batches: int = 200) -> Tuple[float, float]:
        """Returns (dynamic_waste, bucketed_waste) as padded-token fractions."""
        saved = self.state()
        dyn = buck = total_d = total_b = 0
        for _ in range(n_batches):
            idx = self._next_indices()
            lens = self._lengths[idx]
            m = int(lens.max())
            a = self.cfg.align
            md = -(-m // a) * a
            mb = self.bucket_len(m)
            dyn += md * len(lens) - lens.sum()
            total_d += md * len(lens)
            buck += mb * len(lens) - lens.sum()
            total_b += mb * len(lens)
        self.restore(saved)
        return dyn / total_d, buck / total_b
