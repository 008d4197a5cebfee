"""K2 segment_prefix_ok: the priority-ordered same-segment prefix gate,
chained over the levels of one commit step.

Kernel: `csrc/segment_prefix_ok.cu`. Replaces
koordinator_tpu/scheduler/batching.py segment_prefix_ok (a masked
[P, P] x [P, R] matmul on the TPU), run for node capacity and then for
each quota level in every inner commit step: one launch takes the node
gate and every quota level, with the step's pod topology verdict (K8)
ANDed in between them, where the reference's topology gates sit
(core.py:776-884). Level 0 may read requests of its own (the node
level's amplified CPU, core.py:757-763, against the quota levels' raw
requests). Above 2048 pods the launch walks the rank order a tile of
2048 at a time, each level carrying its segments' sums from tile to
tile.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from koordinator_tpu_torch.api.extension import NUM_RESOURCES
from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check

TILE_PODS = 2048  # a tile: one block of 512 threads, four pods a thread
MAX_LEVELS = 8

# (base f32[S, R], limit f32[S, R], S) of one level
Table = Tuple[torch.Tensor, torch.Tensor, int]


def _check_table(name: str, t: torch.Tensor, rows: int, cols: int,
                 device) -> None:
    """A level's base or limit: f32[rows, cols] on `device`, unit column
    stride, any row stride of at least `cols`."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
    if tuple(t.shape) != (rows, cols):
        raise ValueError(f"{name}: expected shape {(rows, cols)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.stride(1) != 1 or (rows > 1 and t.stride(0) < cols):
        raise ValueError(f"{name}: needs unit column stride and rows "
                         f"apart by at least {cols}")


def _check_req(req: torch.Tensor, levels: int, p: int, r: int,
               device) -> None:
    """The requests: f32[P, R] shared by the levels or f32[L, P, R] one
    a level, on `device`, unit column stride, rows at least R apart
    (any level stride: a zone's columns of a [P, Z, R] take, seen as
    [Z, P, R], are read in place)."""
    if req.dtype != torch.float32:
        raise TypeError(f"req: expected torch.float32, got {req.dtype}")
    shapes = ((p, r), (levels, p, r))
    if tuple(req.shape) not in shapes:
        raise ValueError(f"req: expected shape {shapes[0]} or {shapes[1]}, "
                         f"got {tuple(req.shape)}")
    if req.device != device:
        raise ValueError(f"req: on {req.device}, expected {device}")
    if (r > 1 and req.stride(-1) != 1) or (p > 1 and req.stride(-2) < r) or (
            req.dim() == 3 and req.stride(0) < 0):
        raise ValueError(f"req: needs unit column stride and rows apart by "
                         f"at least {r}")


def segment_prefix_ok_plain(seg: torch.Tensor, rank: torch.Tensor,
                            req: torch.Tensor, base_used: torch.Tensor,
                            limit: torch.Tensor, num_segments: int,
                            eps: float) -> torch.Tensor:
    """bool[P]: base_used[seg] + Σ req of the same-segment pods ranked
    earlier + own req <= limit[seg] + eps on every column; segments
    >= num_segments ("no candidate") pass. The reference's masked
    matmul, exact for the integer-valued sums the scheduler forms."""
    same = seg[:, None] == seg[None, :]
    earlier = rank[None, :] < rank[:, None]
    cum = (same & earlier).to(req.dtype) @ req
    seg_c = seg.clamp(0, num_segments - 1).long()
    ok = torch.all(base_used[seg_c] + cum + req <= limit[seg_c] + eps, dim=-1)
    return ok | (seg >= num_segments)


def segment_prefix_chain_plain(seg: torch.Tensor, rank: torch.Tensor,
                               req: torch.Tensor, active: torch.Tensor,
                               tables: Sequence[Table], eps: float,
                               mask: Optional[torch.Tensor] = None,
                               req0: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """bool[P]: `active`, narrowed level by level: at level l the pods
    still alive are gated by `segment_prefix_ok_plain` on seg[l],
    tables[l] and the level's requests (req0 at level 0 where given,
    else req[l] of a per-level req [L, P, R], else the shared req
    [P, R]); the others sit out (segment out of range, no request).
    `mask` (bool[P]), where given, is ANDed into the alive pods after
    level 0: level 0 charges every active pod, the later levels only
    those that pass both."""
    alive = active
    for l, (level, (base_used, limit, num_segments)) in enumerate(
            zip(seg, tables)):
        seg_l = torch.where(alive, level, num_segments).to(torch.int32)
        req_l = req0 if l == 0 and req0 is not None else (
            req[l] if req.dim() == 3 else req)
        req_l = torch.where(alive[:, None], req_l, 0.0)
        alive = alive & segment_prefix_ok_plain(
            seg_l, rank, req_l, base_used, limit, num_segments, eps)
        if l == 0 and mask is not None:
            alive = alive & mask
    return alive


def segment_prefix_chain(seg: torch.Tensor, rank: torch.Tensor,
                         req: torch.Tensor, active: torch.Tensor,
                         tables: Sequence[Table], eps: float,
                         mask: Optional[torch.Tensor] = None,
                         req0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The chained gate of `segment_prefix_chain_plain`: the kernel for
    CUDA tensors (one launch for all levels; L = 1 is the reference's
    single-level gate), the plain version for CPU tensors. seg:
    i32[L, P]; rank: i32[P]; req: f32[P, R] shared by the levels, or
    f32[L, P, R] one a level; active: bool[P]; tables: L levels of
    (base, limit, S), base and limit f32[S, R] with unit column stride
    and one row stride (a column slice of a wider table is taken as it
    is); req likewise needs only unit column stride; mask: bool[P] or
    None, ANDed in after level 0 (L >= 1); req0: f32[P, R] level 0's
    own requests with req's row stride, or None. Takes any P (above
    2048 the tiled walk), R <= 11, L <= 8.

    rank must be a permutation of [0, P) and every active pod's
    segments >= -1. On the host a call that breaks this raises
    ValueError; on the card the kernel checks it and stops with a
    launch failure, which the next synchronisation raises."""
    p, r = req.shape[-2:]
    levels = len(tables)
    dev = req.device
    _launch.check_tensor("seg", seg, torch.int32, (levels, p), dev)
    _launch.check_tensor("rank", rank, torch.int32, (p,), dev)
    _check_req(req, levels, p, r, dev)
    _launch.check_tensor("active", active, torch.bool, (p,), dev)
    if mask is not None:
        _launch.check_tensor("mask", mask, torch.bool, (p,), dev)
        if not levels:
            raise ValueError("segment_prefix_chain: a mask needs a level")
    if req0 is not None:
        _check_req(req0, 1, p, r, dev)
        if req0.dim() != 2 or (p > 1 and req0.stride(0) != req.stride(-2)):
            raise ValueError("segment_prefix_chain: req0 needs shape "
                             "[P, R] and req's row stride")
        if not levels:
            raise ValueError("segment_prefix_chain: req0 needs a level")
    for l, (base_used, limit, num_segments) in enumerate(tables):
        for name, t in (("base", base_used), ("limit", limit)):
            _check_table(f"{name}[{l}]", t, num_segments, r, dev)
        if base_used.stride(0) != limit.stride(0):
            raise ValueError(f"tables[{l}]: base and limit row strides "
                             f"differ")
    if dev.type == "cpu":
        if p and (rank.min() < 0 or rank.max() >= p or not bool(
                torch.all(torch.bincount(rank, minlength=p) == 1))):
            raise ValueError("segment_prefix_chain: rank is not a "
                             "permutation of [0, P)")
        if bool(torch.any((seg < -1) & active)):
            raise ValueError("segment_prefix_chain: an active pod has a "
                             "segment below -1")
        return segment_prefix_chain_plain(seg, rank, req, active, tables, eps,
                                          mask, req0)
    if dev.type != "cuda":
        raise ValueError(f"segment_prefix_chain: unsupported device {dev}")
    if r > NUM_RESOURCES or levels > MAX_LEVELS:
        raise ValueError(f"segment_prefix_chain: R={r}, L={levels} above "
                         f"its capacity ({NUM_RESOURCES}, {MAX_LEVELS})")
    if any(t[2] <= 0 for t in tables) or r == 0:
        raise ValueError("segment_prefix_chain: empty table")
    out = torch.empty((p,), dtype=torch.bool, device=dev)
    fn = TOOLCHAIN.function("segment_prefix_ok", "koord_segment_prefix_chain",
                            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                            + [ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_float, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p])
    bases = (ctypes.c_void_p * max(levels, 1))(
        *(t[0].data_ptr() for t in tables))
    limits = (ctypes.c_void_p * max(levels, 1))(
        *(t[1].data_ptr() for t in tables))
    nseg = (ctypes.c_int * max(levels, 1))(*(t[2] for t in tables))
    strides = (ctypes.c_int * max(levels, 1))(
        *(t[0].stride(0) for t in tables))
    work = None
    if p > TILE_PODS:
        # the rank order, then a carry a level and segment (and one for
        # the pods of no segment)
        work = torch.empty((p + sum((t[2] + 1) * r for t in tables),),
                           dtype=torch.int32, device=dev)
    rc = fn(_launch.ptr(seg), _launch.ptr(rank), _launch.ptr(req),
            None if req0 is None else _launch.ptr(req0),
            _launch.ptr(active),
            None if mask is None else _launch.ptr(mask),
            ctypes.cast(bases, ctypes.c_void_p),
            ctypes.cast(limits, ctypes.c_void_p),
            ctypes.cast(nseg, ctypes.c_void_p),
            ctypes.cast(strides, ctypes.c_void_p), levels, p, r,
            req.stride(0) if req.dim() == 3 else 0,
            req.stride(-2) if p > 1 else r, eps,
            None if work is None else _launch.ptr(work), _launch.ptr(out),
            _launch.stream(dev))
    check(rc, "segment_prefix_chain")
    segment_prefix_chain.launches += 1
    return out


segment_prefix_chain.launches = 0

