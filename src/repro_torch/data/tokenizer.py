"""Own copy of ``src/repro/data/tokenizer.py`` (no JAX in it; nothing left out).

Byte-fallback tokenizer: bytes 0-255 + specials.  Deterministic, offline,
vocab-safe for every assigned arch (all vocabs >= 256 + specials)."""
from __future__ import annotations

PAD, BOS, EOS = 256, 257, 258
N_SPECIAL = 3


class ByteTokenizer:
    vocab_size = 256 + N_SPECIAL

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [BOS] + ids
        if eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    def pad_to(self, ids: list[int], length: int) -> list[int]:
        ids = ids[:length]
        return ids + [PAD] * (length - len(ids))
