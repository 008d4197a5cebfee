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

MAX_COLUMNS = 32  # one lane a column (csrc/ordered_scatter_add.cu)
# csrc/ordered_scatter_add.cu: the shared memory a launch may use, in
# 4-byte words, and the warps of a block
_SMEM_WORDS = 200 * 1024 // 4
_WARPS = 8


def _target_rows(s: int) -> int:
    """The target rows a warp owns (the kernel's TR)."""
    tr = 1
    while tr < 32 and tr * 1024 < s:
        tr *= 2
    return tr


def levels_per_launch(s: int, c: int, p: int) -> int:
    """How many levels of P indices one launch of the kernel takes into a
    target of S rows and C columns: its shared memory holds each warp's
    tile of target rows, the [P, C] rows where a warp owns one row, and
    the [L, P] indices (the kernel's smem_bytes)."""
    tr = _target_rows(s)
    fixed = _WARPS * tr * c + (p * c if tr == 1 else 0)
    return max((_SMEM_WORDS - fixed) // max(p, 1), 0)


def rows_per_launch(s: int, c: int) -> int:
    """The most rows of one level that one launch takes into a target of
    S rows and C columns (levels_per_launch(s, c, rows) >= 1)."""
    tr = _target_rows(s)
    if tr == 1:
        return (_SMEM_WORDS - _WARPS * c) // (c + 1)
    return _SMEM_WORDS - _WARPS * tr * c


def ordered_scatter_add_plain(target: torch.Tensor, idx: torch.Tensor,
                              rows: torch.Tensor) -> torch.Tensor:
    """target with rows[j] added into row idx[l, j] for each level l in
    turn, in ascending j (idx i32[P] is one level); an index in [-S, 0)
    names row S + idx (numpy's rule, as the reference's `.at[]`), other
    indices outside [0, S) are dropped. torch's CPU index_add_ adds in
    index order, as the reference's CPU scatter does."""
    s = target.shape[0]
    out = target.clone()
    for level in (idx[None] if idx.dim() == 1 else idx):
        level = torch.where(level < 0, level + s, level)
        keep = (level >= 0) & (level < s)
        out.index_add_(0, level[keep].long(), rows[keep])
    return out


def ordered_scatter_add(target: torch.Tensor, idx: torch.Tensor,
                        rows: torch.Tensor) -> torch.Tensor:
    """The scatter of `ordered_scatter_add_plain`: the kernel for CUDA
    tensors, the plain version for CPU tensors. target: f32[S, C];
    idx: i32[P] or i32[L, P] (L scatters of the same rows, applied in
    order: bit-equal to L calls in a row); rows: f32[P, C]. Returns a
    new tensor. One launch takes up to `levels_per_launch(S, C, P)`
    levels; more levels take that many launches, each on the last one's
    result, in order. Where not even one level fits, each level goes in
    pieces of `rows_per_launch(S, C)` rows, a launch a piece, levels
    outer: each target row still takes its adds in ascending (l, j)."""
    s, c = target.shape
    p = rows.shape[0]
    dev = target.device
    _launch.check_tensor("target", target, torch.float32, (s, c), dev)
    _launch.check_tensor("idx", idx, torch.int32,
                         (p,) if idx.dim() == 1 else (None, p), dev)
    _launch.check_tensor("rows", rows, torch.float32, (p, c), dev)
    if dev.type == "cpu":
        return ordered_scatter_add_plain(target, idx, rows)
    if dev.type != "cuda":
        raise ValueError(f"ordered_scatter_add: unsupported device {dev}")
    if c > MAX_COLUMNS:
        raise ValueError(f"ordered_scatter_add: C={c} above {MAX_COLUMNS}")
    if idx.dim() == 1:
        idx = idx[None]
    per = levels_per_launch(s, c, p)
    if per > 0:
        pieces = [(l0, min(l0 + per, idx.shape[0]), 0, p)
                  for l0 in range(0, max(idx.shape[0], 1), per)]
    elif idx.shape[0] == 0:
        return target.clone()
    else:
        q = rows_per_launch(s, c)
        pieces = [(l, l + 1, j0, min(j0 + q, p))
                  for l in range(idx.shape[0]) for j0 in range(0, p, q)]
    fn = TOOLCHAIN.function("ordered_scatter_add",
                            "koord_ordered_scatter_add",
                            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                            + [ctypes.c_void_p, ctypes.c_void_p])
    out = target
    for l0, l1, j0, j1 in pieces:
        # one level's piece of rows: its indices are contiguous
        part = idx[l0:l1, j0:j1]
        src, out = out, torch.empty_like(target)
        rc = fn(_launch.ptr(src), _launch.ptr(part), _launch.ptr(rows[j0:]),
                s, c, j1 - j0, l1 - l0, _launch.ptr(out),
                _launch.stream(dev))
        check(rc, "ordered_scatter_add")
        ordered_scatter_add.launches += 1
    return out


ordered_scatter_add.launches = 0
