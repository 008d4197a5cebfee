"""K2 segment_prefix_ok: the priority-ordered same-segment prefix gate.

Kernel: `csrc/segment_prefix_ok.cu`. Replaces
koordinator_tpu/scheduler/batching.py segment_prefix_ok (a masked
[P, P] x [P, R] matmul on the TPU), run for node capacity and for each
quota level in every inner commit step.
"""

from __future__ import annotations

import ctypes

import torch

from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check



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


def segment_prefix_ok(seg: torch.Tensor, rank: torch.Tensor,
                      req: torch.Tensor, base_used: torch.Tensor,
                      limit: torch.Tensor, num_segments: int,
                      eps: float) -> torch.Tensor:
    """The gate of `segment_prefix_ok_plain`: the kernel for CUDA
    tensors, the plain version for CPU tensors. seg, rank: i32[P];
    req: f32[P, R]; base_used, limit: f32[S, R] with S = num_segments."""
    p, r = req.shape
    dev = req.device
    _launch.check_tensor("seg", seg, torch.int32, (p,), dev)
    _launch.check_tensor("rank", rank, torch.int32, (p,), dev)
    _launch.check_tensor("req", req, torch.float32, (p, r), dev)
    _launch.check_tensor("base_used", base_used, torch.float32,
                         (num_segments, r), dev)
    _launch.check_tensor("limit", limit, torch.float32, (num_segments, r), dev)
    if dev.type == "cpu":
        return segment_prefix_ok_plain(seg, rank, req, base_used, limit,
                                       num_segments, eps)
    if dev.type != "cuda":
        raise ValueError(f"segment_prefix_ok: unsupported device {dev}")
    out = torch.empty((p,), dtype=torch.bool, device=dev)
    fn = TOOLCHAIN.function("segment_prefix_ok",
                      "koord_segment_prefix_ok",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                      + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    rc = fn(_launch.ptr(seg), _launch.ptr(rank), _launch.ptr(req),
            _launch.ptr(base_used), _launch.ptr(limit), p, r, num_segments,
            eps, _launch.ptr(out), _launch.stream(dev))
    check(rc, "segment_prefix_ok")
    segment_prefix_ok.launches += 1
    return out


segment_prefix_ok.launches = 0
