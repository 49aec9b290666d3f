"""CUDA kernels of the table (sources in ``repro_torch/csrc``), their plain
PyTorch versions, and the plan-driven dispatch around them."""
