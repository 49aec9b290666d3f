"""WF-Ext, the wait-free resizable extendible hash table, in PyTorch.

The port of the JAX package ``repro`` to PyTorch and CUDA: the same state
layout, status codes and transaction semantics, with the Pallas TPU kernels
replaced by hand-written CUDA kernels for Hopper (``csrc/``). It imports
neither ``jax`` nor the ``repro`` package. The facade is
:class:`repro_torch.table_api.Table`.
"""
