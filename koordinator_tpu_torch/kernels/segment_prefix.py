"""K2 segment_prefix_ok: the priority-ordered same-segment prefix gate,
chained over the levels of one commit step.

Kernel: `csrc/segment_prefix_ok.cu`. Replaces
koordinator_tpu/scheduler/batching.py segment_prefix_ok (a masked
[P, P] x [P, R] matmul on the TPU), run for node capacity and then for
each quota level in every inner commit step: one launch takes the node
gate and every quota level.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from koordinator_tpu_torch.api.extension import NUM_RESOURCES
from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check

MAX_PODS = 2048   # one block of 512 threads, four pods a thread
MAX_LEVELS = 8

# (base f32[S, R], limit f32[S, R], S) of one level
Table = Tuple[torch.Tensor, torch.Tensor, int]


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
                               tables: Sequence[Table],
                               eps: float) -> torch.Tensor:
    """bool[P]: `active`, narrowed level by level: at level l the pods
    still alive are gated by `segment_prefix_ok_plain` on seg[l] and
    tables[l]; the others sit out (segment out of range, no request)."""
    alive = active
    for level, (base_used, limit, num_segments) in zip(seg, tables):
        seg_l = torch.where(alive, level, num_segments).to(torch.int32)
        req_l = torch.where(alive[:, None], req, 0.0)
        alive = alive & segment_prefix_ok_plain(
            seg_l, rank, req_l, base_used, limit, num_segments, eps)
    return alive


def segment_prefix_chain(seg: torch.Tensor, rank: torch.Tensor,
                         req: torch.Tensor, active: torch.Tensor,
                         tables: Sequence[Table], eps: float) -> torch.Tensor:
    """The chained gate of `segment_prefix_chain_plain`: the kernel for
    CUDA tensors (one launch for all levels; L = 1 is the reference's
    single-level gate), the plain version for CPU tensors. seg:
    i32[L, P]; rank: i32[P]; req: f32[P, R]; active: bool[P]; tables: L
    levels of (base, limit, S). Takes P <= 2048, R <= 11, L <= 8.

    rank must be a permutation of [0, P) and every active pod's
    segments >= -1. On the host a call that breaks this raises
    ValueError; on the card the kernel checks it and stops with a
    launch failure, which the next synchronisation raises."""
    p, r = req.shape
    levels = len(tables)
    dev = req.device
    _launch.check_tensor("seg", seg, torch.int32, (levels, p), dev)
    _launch.check_tensor("rank", rank, torch.int32, (p,), dev)
    _launch.check_tensor("req", req, torch.float32, (p, r), dev)
    _launch.check_tensor("active", active, torch.bool, (p,), dev)
    for l, (base_used, limit, num_segments) in enumerate(tables):
        _launch.check_tensor(f"base[{l}]", base_used, torch.float32,
                             (num_segments, r), dev)
        _launch.check_tensor(f"limit[{l}]", limit, torch.float32,
                             (num_segments, r), dev)
    if dev.type == "cpu":
        if p and (rank.min() < 0 or rank.max() >= p or not bool(
                torch.all(torch.bincount(rank, minlength=p) == 1))):
            raise ValueError("segment_prefix_chain: rank is not a "
                             "permutation of [0, P)")
        if bool(torch.any((seg < -1) & active)):
            raise ValueError("segment_prefix_chain: an active pod has a "
                             "segment below -1")
        return segment_prefix_chain_plain(seg, rank, req, active, tables, eps)
    if dev.type != "cuda":
        raise ValueError(f"segment_prefix_chain: unsupported device {dev}")
    if p > MAX_PODS or r > NUM_RESOURCES or levels > MAX_LEVELS:
        raise ValueError(f"segment_prefix_chain: P={p}, R={r}, L={levels} "
                         f"above its capacity ({MAX_PODS}, {NUM_RESOURCES}, "
                         f"{MAX_LEVELS})")
    if any(t[2] <= 0 for t in tables) or r == 0:
        raise ValueError("segment_prefix_chain: empty table")
    out = torch.empty((p,), dtype=torch.bool, device=dev)
    fn = TOOLCHAIN.function("segment_prefix_ok", "koord_segment_prefix_chain",
                            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                            + [ctypes.c_float, ctypes.c_void_p,
                               ctypes.c_void_p])
    bases = (ctypes.c_void_p * max(levels, 1))(
        *(t[0].data_ptr() for t in tables))
    limits = (ctypes.c_void_p * max(levels, 1))(
        *(t[1].data_ptr() for t in tables))
    nseg = (ctypes.c_int * max(levels, 1))(*(t[2] for t in tables))
    rc = fn(_launch.ptr(seg), _launch.ptr(rank), _launch.ptr(req),
            _launch.ptr(active), ctypes.cast(bases, ctypes.c_void_p),
            ctypes.cast(limits, ctypes.c_void_p),
            ctypes.cast(nseg, ctypes.c_void_p), levels, p, r, eps,
            _launch.ptr(out), _launch.stream(dev))
    check(rc, "segment_prefix_chain")
    segment_prefix_chain.launches += 1
    return out


segment_prefix_chain.launches = 0

