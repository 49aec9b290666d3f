"""The serving tier of the port: the request router over a ``Table``
(:mod:`repro_torch.serving.router`, local placement only) and the paged-KV
serving engine whose page table is a ``Table``
(:mod:`repro_torch.serving.kvcache`, :mod:`repro_torch.serving.engine`).
"""
