"""The serving tier of the port: the request router over a ``Table``.

Local placement only, like the rest of the port. See
:mod:`repro_torch.serving.router`.
"""
