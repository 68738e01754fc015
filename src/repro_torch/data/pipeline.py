"""Own copy of ``src/repro/data/pipeline.py`` (numpy only, no JAX in it;
nothing left out): the batches are equal bit for bit to the reference's.

Deterministic sharded token pipeline.

Design point (matters at 1000+ nodes): batches are a pure function of
``(seed, step, shard)`` — any host can regenerate any step's shard without
coordination, so restarts and elastic re-sharding never need a data-state
checkpoint beyond the step counter.  Backends:

 * ``synthetic`` — Zipfian token stream with local n-gram structure (gives a
   learnable signal so loss curves actually go down in the examples),
 * ``corpus``   — byte-tokenized documents from an in-memory corpus or text
   file, packed into fixed-length rows with EOS separators.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from .tokenizer import EOS, ByteTokenizer


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    backend: str = "synthetic"      # synthetic | corpus
    zipf_a: float = 1.2


class DataPipeline:
    def __init__(self, cfg: DataConfig, corpus: Optional[Sequence[str]] = None,
                 n_shards: int = 1, shard_id: int = 0):
        assert cfg.global_batch % n_shards == 0
        self.cfg = cfg
        self.n_shards = n_shards
        self.shard_id = shard_id
        self._tok = ByteTokenizer()
        self._packed: Optional[np.ndarray] = None
        if cfg.backend == "corpus":
            assert corpus is not None, "corpus backend needs documents"
            ids: list[int] = []
            for doc in corpus:
                ids.extend(self._tok.encode(doc, bos=False) + [EOS])
            n = max(len(ids) // cfg.seq_len, 1)
            ids = (ids * (cfg.seq_len * n // max(len(ids), 1) + 2))[: n * cfg.seq_len]
            self._packed = np.asarray(ids, np.int32).reshape(n, cfg.seq_len)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.shard_id]))

    def batch(self, step: int) -> dict:
        """Shard-local batch for ``step``: {"tokens": (B_local, S) int32}."""
        cfg = self.cfg
        b_local = cfg.global_batch // self.n_shards
        rng = self._rng(step)
        if cfg.backend == "corpus":
            idx = rng.integers(0, self._packed.shape[0], size=b_local)
            return {"tokens": self._packed[idx]}
        # synthetic: Zipf unigram + shift-by-one bigram structure
        base = rng.zipf(cfg.zipf_a, size=(b_local, cfg.seq_len)).astype(np.int64)
        toks = (base % (cfg.vocab_size - 2)) + 1
        # inject predictable continuation: with p=0.5, t[i+1] = t[i] + 1
        copy_mask = rng.random((b_local, cfg.seq_len - 1)) < 0.5
        nxt = (toks[:, :-1] + 1) % cfg.vocab_size
        toks[:, 1:] = np.where(copy_mask, nxt, toks[:, 1:])
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
