"""Shared checks, ctypes plumbing and row helpers of the kernel
wrappers."""

from __future__ import annotations

import ctypes
from typing import Optional

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



def and_rows(mask: Optional[torch.Tensor], rows_ok: torch.Tensor
             ) -> torch.Tensor:
    """`mask` (bool[P, N]) with rows_ok (bool[rows, N], rows <= P) ANDed
    into its first rows, the rows beyond as they are (the reference's
    and_rows, core.py:291-296); rows_ok itself where mask is None."""
    if mask is None:
        return rows_ok
    rows = rows_ok.shape[0]
    return torch.cat([mask[:rows] & rows_ok, mask[rows:]])
