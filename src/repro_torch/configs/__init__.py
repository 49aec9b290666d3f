"""The ten architecture configurations (``archs.py``).

The JAX package's per-architecture modules (read only by its ``launch/``)
and its input-shape cells (``repro/configs/shapes.py``) are not ported
yet.
"""
from repro_torch.configs.archs import ARCHS, get_config, smoke_config  # noqa: F401
