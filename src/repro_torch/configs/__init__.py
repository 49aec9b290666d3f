"""The ten architecture configurations (``archs.py``, one module per
architecture re-exporting its config as ``CONFIG``, for parity with the JAX
package: nothing in either package imports those) and the input-shape cells
(``shapes.py``) that the dry-run (``repro_torch/launch/dryrun.py``) sweeps.
"""
from repro_torch.configs.archs import ARCHS, get_config, smoke_config  # noqa: F401
from repro_torch.configs.shapes import SHAPES, cell_supported, cells, input_specs  # noqa: F401
