"""K3 ordered_scatter_add: the deterministic row scatter-add of every
commit in schedule_batch.

Kernel: `csrc/ordered_scatter_add.cu`. Replaces the
`.at[idx].add(rows, mode="drop")` commits of
koordinator_tpu/scheduler/core.py, keeping their order of additions.
`ordered_scatter_add_many` takes a step's, a round's or a rebuild's
independent commits (distinct targets) in one launch;
`ordered_scatter_add` is its one-group form.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Hashable, List, Sequence, Tuple

import torch

from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check

MAX_GROUPS = 32    # groups a launch (csrc/ordered_scatter_add.cu)
MAX_COLUMNS = 192  # columns a target: the instance commit at I = 64
# the H100's SMs, the most blocks a group takes, and `group_blocks`'
# two shares
_SMS = 132
_MAX_BLOCKS = 2 * _SMS
_ENTRIES_A_BLOCK = 512
_SCAN_PER_COPY = 2

Group = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class _Group(ctypes.Structure):
    _fields_ = [("target", ctypes.c_void_p), ("idx", ctypes.c_void_p),
                ("rows", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("S", ctypes.c_int), ("C", ctypes.c_int), ("P", ctypes.c_int),
                ("L", ctypes.c_int), ("rb", ctypes.c_int),
                ("block0", ctypes.c_int)]


class _Groups(ctypes.Structure):
    """The launch's parameter, passed to the kernel by value."""
    _fields_ = [("n", ctypes.c_int), ("blocks", ctypes.c_int),
                ("g", _Group * MAX_GROUPS)]


def group_blocks(s: int, c: int, levels: int, p: int) -> Tuple[int, int]:
    """(blocks, target rows a block) of one group of S rows, C columns
    and L levels of P indices, from the shapes alone: enough blocks that
    each reads about as many index bytes as it reads and writes of the
    target, and at least one for each _ENTRIES_A_BLOCK indices (a hot
    row's block then shares its list with few other rows), at most
    _MAX_BLOCKS and S. The constants were chosen on the H100 among
    (1, 2, 4) for the first and 256 to 4096 for the second
    (`chip_smoke.py check_k3` and `check_fold`)."""
    if s == 0 or c == 0:
        return 0, 1
    n = levels * p
    want = max(-(-_SCAN_PER_COPY * s * c // max(n, 1)),
               -(-n // _ENTRIES_A_BLOCK), 1)
    rb = -(-s // min(want, s, _MAX_BLOCKS))
    return -(-s // rb), rb


def pack_groups(groups: Sequence[Group],
                outs: Sequence[torch.Tensor]) -> _Groups:
    """The kernel's descriptor of (target, idx, rows) groups (at most
    MAX_GROUPS) and their outputs: pointers, shapes, the rows a block
    owns and each group's first block (the prefix of the groups' block
    counts)."""
    desc = _Groups()
    desc.n = len(groups)
    block0 = 0
    for k, ((target, idx, rows), out) in enumerate(zip(groups, outs)):
        s, c = target.shape
        levels = 1 if idx.dim() == 1 else idx.shape[0]
        p = rows.shape[0]
        blocks, rb = group_blocks(s, c, levels, p)
        desc.g[k] = _Group(target.data_ptr(), idx.data_ptr(),
                           rows.data_ptr(), out.data_ptr(),
                           s if blocks else 0, c, p, levels, rb, block0)
        block0 += blocks
    desc.blocks = block0
    return desc


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


def ordered_scatter_add_many_plain(groups: Sequence[Group]
                                   ) -> List[torch.Tensor]:
    """`ordered_scatter_add_plain` of each group, in order."""
    return [ordered_scatter_add_plain(*g) for g in groups]


def _check(groups: Sequence[Group]) -> torch.device:
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"ordered_scatter_add_many: {len(groups)} groups, "
                         f"at most {MAX_GROUPS} a launch")
    dev = groups[0][0].device
    for target, idx, rows in groups:
        s, c = target.shape
        p = rows.shape[0]
        _launch.check_tensor("target", target, torch.float32, (s, c), dev)
        _launch.check_tensor("idx", idx, torch.int32,
                             (p,) if idx.dim() == 1 else (None, p), dev)
        _launch.check_tensor("rows", rows, torch.float32, (p, c), dev)
        if idx.numel() >= 2 ** 31:
            raise ValueError("ordered_scatter_add: L * P at or above 2^31")
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * 4)
                   for t, _, _ in groups if t.numel())
    for (_, end), (start, _) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError("ordered_scatter_add_many: two targets overlap "
                             "in memory")
    return dev


def ordered_scatter_add_many(groups: Sequence[Group]) -> List[torch.Tensor]:
    """The scatters of `ordered_scatter_add_many_plain`, each into a new
    tensor: one launch of the kernel for CUDA tensors (at most
    MAX_GROUPS groups, C <= MAX_COLUMNS, distinct targets that do not
    overlap in memory; any S, L and P), the plain version for CPU
    tensors. A group is (target f32[S, C], idx i32[P] or i32[L, P],
    rows f32[P, C])."""
    groups = list(groups)
    if not groups:
        return []
    ordered_scatter_add.calls += 1
    dev = _check(groups)
    if dev.type == "cpu":
        return ordered_scatter_add_many_plain(groups)
    if dev.type != "cuda":
        raise ValueError(f"ordered_scatter_add: unsupported device {dev}")
    for target, _, _ in groups:
        if target.shape[1] > MAX_COLUMNS:
            raise ValueError(f"ordered_scatter_add: C={target.shape[1]} "
                             f"above {MAX_COLUMNS}")
    outs = [torch.empty_like(t) for t, _, _ in groups]
    desc = pack_groups(groups, outs)
    if desc.blocks:
        fn = TOOLCHAIN.function("ordered_scatter_add",
                                "koord_ordered_scatter_add_many",
                                [ctypes.c_void_p, ctypes.c_void_p])
        check(fn(ctypes.addressof(desc), _launch.stream(dev)),
              "ordered_scatter_add")
        ordered_scatter_add.launches += 1
    return outs


def ordered_scatter_add_named(commits: Dict[Hashable, Group]
                              ) -> Dict[Hashable, torch.Tensor]:
    """{name: output} of named groups {name: (target, idx, rows)}, in one
    `ordered_scatter_add_many` call."""
    return dict(zip(commits, ordered_scatter_add_many(list(commits.values()))))


def ordered_scatter_add(target: torch.Tensor, idx: torch.Tensor,
                        rows: torch.Tensor) -> torch.Tensor:
    """The one-group form of `ordered_scatter_add_many`. target:
    f32[S, C]; idx: i32[P] or i32[L, P] (L scatters of the same rows,
    applied in order: bit-equal to L calls in a row); rows: f32[P, C].
    Returns a new tensor."""
    return ordered_scatter_add_many([(target, idx, rows)])[0]


# launches: kernel launches (CUDA); calls: grouped calls on any device
ordered_scatter_add.launches = 0
ordered_scatter_add.calls = 0
