"""The model stack: configs in ``ModelConfig``, parameters, the training
and prefill forward, the dense decode step (``model.py``) and its layers,
MoE and SSM blocks."""
