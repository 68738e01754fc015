"""Model substrate of the port.  Counterpart of ``src/repro/models/``:
``config``, ``layers``, ``blocks`` (kind ``attn``) and ``model`` are ported;
``moe``, ``ssm`` and ``xlstm`` come with the MoE/Hymba/xLSTM blocks slice."""
from .config import InputShape, ModelConfig, MoESpec, SHAPES
from .model import LM

__all__ = ["InputShape", "ModelConfig", "MoESpec", "SHAPES", "LM"]
