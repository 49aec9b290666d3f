"""Assigned architecture config (see archs.py for the table)."""
from repro_torch.configs.archs import INTERNVL2_2B as CONFIG  # noqa: F401
