"""The decode side of the model stack: configs in ``ModelConfig``,
parameters, the dense decode step (``model.py``) and its layers, MoE and
SSM blocks."""
