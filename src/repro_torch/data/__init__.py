"""Counterpart of ``src/repro/data/``.  Ported: the byte tokenizer.  The
training ``DataPipeline`` comes with the training slice."""
from .tokenizer import BOS, EOS, PAD, ByteTokenizer

__all__ = ["BOS", "EOS", "PAD", "ByteTokenizer"]
