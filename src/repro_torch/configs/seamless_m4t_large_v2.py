"""Assigned architecture config (see archs.py for the table)."""
from repro_torch.configs.archs import SEAMLESS_M4T_LARGE_V2 as CONFIG  # noqa: F401
