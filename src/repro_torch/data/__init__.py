"""Counterpart of ``src/repro/data/``: the byte tokenizer and the training
``DataPipeline``."""
from .pipeline import DataConfig, DataPipeline
from .tokenizer import BOS, EOS, PAD, ByteTokenizer

__all__ = ["BOS", "EOS", "PAD", "ByteTokenizer", "DataConfig", "DataPipeline"]
