"""Argument checks shared by the kernel wrappers: a kernel takes raw
pointers, so device, dtype, shape and contiguity are settled here."""
from __future__ import annotations

import torch


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, device,
                 shape=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_i32_vector(name: str, t: torch.Tensor, device, n=None) -> None:
    check_tensor(name, t, torch.int32, device)
    if t.ndim != 1 or (n is not None and t.shape[0] != n):
        raise ValueError(f"{name} must be 1-d"
                         + (f" of length {n}" if n is not None else "")
                         + f", got shape {tuple(t.shape)}")


def check_pools(pool_keys: torch.Tensor, pool_vals: torch.Tensor,
                device) -> None:
    check_tensor("pool_keys", pool_keys, torch.int32, device)
    check_tensor("pool_vals", pool_vals, torch.int32, device,
                 shape=pool_keys.shape)
    if pool_keys.ndim != 2 or pool_keys.shape[0] >= 2 ** 31:
        raise ValueError(f"pools must be [rows < 2**31, B], got "
                         f"{tuple(pool_keys.shape)}")
