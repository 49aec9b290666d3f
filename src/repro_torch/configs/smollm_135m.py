"""Assigned architecture config (see archs.py for the table)."""
from repro_torch.configs.archs import SMOLLM_135M as CONFIG  # noqa: F401
