"""The benchmark of the PyTorch and CUDA port of WF-Ext (see run.py)."""
