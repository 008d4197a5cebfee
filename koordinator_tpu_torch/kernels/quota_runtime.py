"""K18 quota_runtime: the elastic-quota forest's limited demand and
fair-share runtime in one launch.

Kernel: `csrc/quota_runtime.cu`. Replaces
koordinator_tpu/ops/waterfill.py:48 propagate_demand and :135
compute_runtime (with :74 _redistribute_level's `lax.while_loop`), which
GroupQuotaManager runs over the whole quota forest after the pending
pods' requests are folded into their quotas' demand
(`ops/quota_demand.py`). One block walks the tree: it builds each
parent's children in row order, propagates the demand bottom-up, then
runs every level's rounds on the device, so no round waits for the
host. The plain version is `ops/waterfill.compute_runtime_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check
from koordinator_tpu_torch.snapshot.schema import MAX_QUOTA_DEPTH, QuotaState

# csrc/quota_runtime.cu: the rows one block's shared memory indexes (the
# children table) and the columns
MAX_QUOTAS = 4096
MAX_COLUMNS = 16
# the [Q, R] float arrays the kernel keeps in device memory
_SCRATCH_ARRAYS = 7


@dataclasses.dataclass
class QuotaRuntime:
    runtime: Optional[torch.Tensor]   # f32[Q, R] (None: demand only)
    limited: torch.Tensor             # f32[Q, R] limited demand
    rounds: torch.Tensor              # i32[MAX_QUOTA_DEPTH] rounds a level


def quota_runtime_plain(quotas: QuotaState, cluster_total, max_iters: int = 64,
                        demand_only: bool = False) -> QuotaRuntime:
    """`ops/waterfill.py`'s plain versions, as the kernel returns them."""
    from koordinator_tpu_torch.ops import waterfill
    dev = quotas.min.device
    if demand_only:
        return QuotaRuntime(None, waterfill.propagate_demand_plain(quotas),
                            torch.zeros(MAX_QUOTA_DEPTH, dtype=torch.int32,
                                        device=dev))
    runtime, limited, rounds = waterfill.compute_runtime_plain(
        quotas, cluster_total, max_iters)
    return QuotaRuntime(runtime, limited, torch.tensor(
        rounds, dtype=torch.int32, device=dev))


def quota_runtime(quotas: QuotaState, cluster_total: Optional[torch.Tensor],
                  max_iters: int = 64,
                  demand_only: bool = False) -> QuotaRuntime:
    """The forest's limited demand and runtime of `quota_runtime_plain`:
    the kernel for CUDA tensors, the plain version for CPU tensors.
    quotas: the QuotaState (min, max, shared_weight, demand f32[Q, R],
    parent i32[Q], depth_ancestor i32[Q, 6], allow_lent and valid
    bool[Q]); cluster_total f32[R] (unused with `demand_only`, which
    stops after the limited demand). Q <= 4096, R <= 16; a parent
    outside [0, Q) names no row. `rounds` counts the rounds each level's
    loop ran (level 0 none)."""
    q, r = quotas.min.shape
    dev = quotas.min.device
    for name in ("min", "max", "shared_weight", "demand"):
        _launch.check_tensor(name, getattr(quotas, name), torch.float32,
                             (q, r), dev)
    _launch.check_tensor("parent", quotas.parent, torch.int32, (q,), dev)
    _launch.check_tensor("depth_ancestor", quotas.depth_ancestor,
                         torch.int32, (q, MAX_QUOTA_DEPTH), dev)
    _launch.check_tensor("allow_lent", quotas.allow_lent, torch.bool, (q,),
                         dev)
    _launch.check_tensor("valid", quotas.valid, torch.bool, (q,), dev)
    if not demand_only:
        _launch.check_tensor("cluster_total", cluster_total, torch.float32,
                             (r,), dev)
    if max_iters < 0:
        raise ValueError(f"quota_runtime: max_iters={max_iters}")
    if dev.type == "cpu":
        return quota_runtime_plain(quotas, cluster_total, max_iters,
                                   demand_only)
    if dev.type != "cuda":
        raise ValueError(f"quota_runtime: unsupported device {dev}")
    if not 0 < q <= MAX_QUOTAS or not 0 < r <= MAX_COLUMNS:
        raise ValueError(f"quota_runtime: Q={q}, R={r} outside its capacity "
                         f"(1..{MAX_QUOTAS} rows, 1..{MAX_COLUMNS} columns)")
    limited = torch.empty((q, r), dtype=torch.float32, device=dev)
    runtime = None if demand_only else torch.empty_like(limited)
    rounds = torch.zeros(MAX_QUOTA_DEPTH, dtype=torch.int32, device=dev)
    scratch = torch.empty((_SCRATCH_ARRAYS, q, r), dtype=torch.float32,
                          device=dev)
    adjusting = torch.empty((q, r), dtype=torch.uint8, device=dev)
    total = cluster_total if not demand_only else limited
    fn = TOOLCHAIN.function("quota_runtime", "koord_quota_runtime",
                            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                            + [ctypes.c_void_p] * 7)
    rc = fn(_launch.ptr(quotas.min), _launch.ptr(quotas.max),
            _launch.ptr(quotas.shared_weight), _launch.ptr(quotas.demand),
            _launch.ptr(quotas.parent), _launch.ptr(quotas.depth_ancestor),
            _launch.ptr(quotas.allow_lent), _launch.ptr(quotas.valid),
            q, r, max_iters, int(demand_only), _launch.ptr(total),
            _launch.ptr(limited),
            _launch.ptr(limited if runtime is None else runtime),
            _launch.ptr(rounds), _launch.ptr(scratch),
            _launch.ptr(adjusting), _launch.stream(dev))
    check(rc, "quota_runtime")
    quota_runtime.launches += 1
    return QuotaRuntime(runtime, limited, rounds)


quota_runtime.launches = 0
