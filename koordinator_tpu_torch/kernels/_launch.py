"""Shared checks and ctypes plumbing of the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless `t` has this dtype, shape (None = any extent) and
    device and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != got for s, got in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

