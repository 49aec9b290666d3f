"""Assigned architecture config (see archs.py for the table)."""
from repro_torch.configs.archs import CODEQWEN1_5_7B as CONFIG  # noqa: F401
