"""Assigned architecture config (see archs.py for the table)."""
from repro_torch.configs.archs import GRANITE_MOE_3B_A800M as CONFIG  # noqa: F401
