"""Model substrate of the port.  Counterpart of ``src/repro/models/``:
``config``, ``layers``, ``moe``, ``ssm``, ``xlstm``, ``blocks`` (every kind
but ``enc`` / ``xdec``) and ``model``."""
from .config import InputShape, ModelConfig, MoESpec, SHAPES
from .model import LM

__all__ = ["InputShape", "ModelConfig", "MoESpec", "SHAPES", "LM"]
