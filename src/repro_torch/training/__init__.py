"""Training: AdamW with fp32 master weights (``optimizer.py``), the train
step with microbatch accumulation (``train_step.py``), the synthetic data
pipeline (``data.py``) and step-atomic checkpoints in the JAX package's
on-disk layout, tables alongside (``checkpoint.py``)."""
