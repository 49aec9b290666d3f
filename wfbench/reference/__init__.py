"""The plain reference and the control (NumPy and PyTorch only; nothing of
the program, nor of JAX)."""
from .control import ControlTable
from .kv import KVReference
from .payload import record_bytes

__all__ = ["ControlTable", "KVReference", "record_bytes"]
