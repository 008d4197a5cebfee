"""K3 ordered_scatter_add: the deterministic row scatter-add of every
commit in schedule_batch.

Kernel: `csrc/ordered_scatter_add.cu`. Replaces the
`.at[idx].add(rows, mode="drop")` commits of
koordinator_tpu/scheduler/core.py, keeping their order of additions.
"""

from __future__ import annotations

import ctypes

import torch

from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check


def ordered_scatter_add_plain(target: torch.Tensor, idx: torch.Tensor,
                              rows: torch.Tensor) -> torch.Tensor:
    """target with rows[j] added into row idx[j] in ascending j;
    indices outside [0, S) are dropped. torch's CPU index_add_ adds in
    index order, as the reference's CPU scatter does."""
    keep = (idx >= 0) & (idx < target.shape[0])
    return target.clone().index_add_(0, idx[keep].long(), rows[keep])


def ordered_scatter_add(target: torch.Tensor, idx: torch.Tensor,
                        rows: torch.Tensor) -> torch.Tensor:
    """The scatter of `ordered_scatter_add_plain`: the kernel for CUDA
    tensors, the plain version for CPU tensors. target: f32[S, C];
    idx: i32[P]; rows: f32[P, C]. Returns a new tensor."""
    s, c = target.shape
    p = idx.shape[0]
    dev = target.device
    _launch.check_tensor("target", target, torch.float32, (s, c), dev)
    _launch.check_tensor("idx", idx, torch.int32, (p,), dev)
    _launch.check_tensor("rows", rows, torch.float32, (p, c), dev)
    if dev.type == "cpu":
        return ordered_scatter_add_plain(target, idx, rows)
    if dev.type != "cuda":
        raise ValueError(f"ordered_scatter_add: unsupported device {dev}")
    sorted_idx, order = torch.sort(idx, stable=True)
    out = torch.empty_like(target)
    fn = TOOLCHAIN.function("ordered_scatter_add",
                      "koord_ordered_scatter_add",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p, ctypes.c_void_p])
    rc = fn(_launch.ptr(target), _launch.ptr(sorted_idx), _launch.ptr(order),
            _launch.ptr(rows), s, c, p, _launch.ptr(out), _launch.stream(dev))
    check(rc, "ordered_scatter_add")
    ordered_scatter_add.launches += 1
    return out


ordered_scatter_add.launches = 0
