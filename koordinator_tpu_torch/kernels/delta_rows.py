"""K16 delta_rows: a snapshot delta's row replacement over every column
it touches.

Kernel: `csrc/delta_rows.cu`. Replaces the `col.at[tgt].set(rows,
mode="drop")` puts of koordinator_tpu/snapshot/delta.py
apply_metric_delta and apply_topology_delta: each column is cloned (a
plain device copy), then delta row k is written into row idx[k] of its
columns for 0 <= idx[k] < N, the last row winning on a repeated index,
as XLA:CPU's scatter leaves it (index_copy_ and index_put_ leave that
order undefined on the card).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check

MAX_COLUMNS = 32  # csrc/delta_rows.cu
MAX_SETS = 2


def last_writer(idx: torch.Tensor, n: int) -> torch.Tensor:
    """bool[K]: the rows of idx i32[K] that land (0 <= idx < n) and that
    no later row with the same index overrides."""
    k = idx.shape[0]
    keep = (idx >= 0) & (idx < n)
    tgt = torch.where(keep, idx, n).long()
    order = torch.arange(k, device=idx.device)
    winner = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    winner.scatter_reduce_(0, tgt, order, reduce="amax")
    return keep & (winner[tgt] == order)


def delta_rows_into_plain(out: Sequence[torch.Tensor],
                          columns: Sequence[Tuple[torch.Tensor,
                                                  torch.Tensor, int]],
                          idx: Sequence[torch.Tensor]) -> None:
    """Put the rows of `last_writer(idx[set], N)` of each (column, rows,
    set) at their indices of the matching `out` column, in place."""
    for new, (col, rows, s) in zip(out, columns):
        keep = last_writer(idx[s], col.shape[0])
        new[idx[s][keep].long()] = rows[keep]


def delta_rows_plain(columns: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                             int]],
                     idx: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each (column [N, ...], rows [K, ...], set) as a new column with
    the rows of `last_writer(idx[set], N)` put at their indices."""
    out = [col.clone() for col, _, _ in columns]
    delta_rows_into_plain(out, columns, idx)
    return out


def _check(columns, idx):
    n = columns[0][0].shape[0]
    k = idx[0].shape[0]
    dev = columns[0][0].device
    if not 1 <= len(idx) <= MAX_SETS:
        raise ValueError(f"delta_rows: {len(idx)} index sets")
    for s, x in enumerate(idx):
        _launch.check_tensor(f"idx[{s}]", x, torch.int32, (k,), dev)
    for i, (col, rows, s) in enumerate(columns):
        _launch.check_tensor(f"column {i}", col, col.dtype,
                             (n,) + tuple(col.shape[1:]), dev)
        _launch.check_tensor(f"rows {i}", rows, col.dtype,
                             (k,) + tuple(col.shape[1:]), dev)
        if not 0 <= s < len(idx):
            raise ValueError(f"delta_rows: column {i} names set {s}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"delta_rows: unsupported device {dev}")
    if dev.type == "cuda" and len(columns) > MAX_COLUMNS:
        raise ValueError(f"delta_rows: {len(columns)} columns, above "
                         f"{MAX_COLUMNS}")
    return n, k, dev


def delta_rows_into(out: Sequence[torch.Tensor],
                    columns: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                            int]],
                    idx: Sequence[torch.Tensor]) -> None:
    """`delta_rows_into_plain`: the kernel for CUDA tensors (two
    launches for all the columns), the plain version for CPU tensors.
    `out` holds one contiguous tensor of each column's dtype and shape,
    written in place; the inputs are not written."""
    if not columns:
        return
    n, k, dev = _check(columns, idx)
    for i, (o, (col, _, _)) in enumerate(zip(out, columns)):
        _launch.check_tensor(f"out {i}", o, col.dtype, tuple(col.shape),
                             dev)
    if dev.type == "cpu":
        delta_rows_into_plain(out, columns, idx)
        return
    if not (k and n):
        return
    winner = torch.full((len(idx), n), -1, dtype=torch.int32, device=dev)
    c = len(columns)
    dst = (ctypes.c_void_p * c)(*(o.data_ptr() for o in out))
    src = (ctypes.c_void_p * c)(*(r.data_ptr() for _, r, _ in columns))
    row_bytes = (ctypes.c_int * c)(*(
        r[0].numel() * r.element_size() for _, r, _ in columns))
    sets = (ctypes.c_int * c)(*(s for _, _, s in columns))
    ptr_idx = (ctypes.c_void_p * len(idx))(*(x.data_ptr() for x in idx))
    fn = TOOLCHAIN.function("delta_rows", "koord_delta_rows",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                     ctypes.c_void_p]
                            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    rc = fn(dst, src, row_bytes, sets, c, ptr_idx, len(idx), k, n,
            _launch.ptr(winner), _launch.stream(dev))
    check(rc, "delta_rows")
    delta_rows.launches += 2


def delta_rows(columns: Sequence[Tuple[torch.Tensor, torch.Tensor, int]],
               idx: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The new columns of `delta_rows_plain`: each column cloned (a
    plain device copy), then `delta_rows_into` on the clones. `columns`
    holds (column [N, ...], rows [K, ...] of the same dtype and trailing
    shape, index set s); `idx` the index sets, i32[K] each (at most 2
    sets, 32 columns). The inputs are not written."""
    if not columns:
        return []
    out = [col.clone() for col, _, _ in columns]
    delta_rows_into(out, columns, idx)
    return out


delta_rows.launches = 0
