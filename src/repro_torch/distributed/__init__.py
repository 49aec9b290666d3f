"""Collectives across devices: the int8-compressed gradient all-reduce
(``compression.py``)."""
