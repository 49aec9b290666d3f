"""Assigned architecture config (see archs.py for the table)."""
from repro_torch.configs.archs import DEEPSEEK_MOE_16B as CONFIG  # noqa: F401
