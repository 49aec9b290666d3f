"""Assigned architecture config (see archs.py for the table)."""
from repro_torch.configs.archs import MAMBA2_2_7B as CONFIG  # noqa: F401
