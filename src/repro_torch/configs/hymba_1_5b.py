"""Assigned architecture config (see archs.py for the table)."""
from repro_torch.configs.archs import HYMBA_1_5B as CONFIG  # noqa: F401
