"""K19 node_overcommit: the batch and mid allocatable of every node, in
one launch.

Kernel: `csrc/node_overcommit.cu`. Replaces
koordinator_tpu/slo_controller/noderesource.py:166 _batch_allocatable
and :190 _mid_allocatable, which koord-manager's NodeResourceController
runs over the whole cluster each metric sync round
(`slo_controller/noderesource.py`). The plain versions keep XLA's max
and min (`kernels/_xla.py`): NodeMetric values come from outside and
may be NaN or infinite.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels._xla import xla_max, xla_min
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check

CPU, MEM = 0, 1
# mem_policy codes: CalculatePolicy usage, request, maxUsageRequest
MEM_BY_USAGE, MEM_BY_REQUEST, MEM_BY_MAX = 0, 1, 2
COLUMNS = ("capacity", "node_reserved", "system_reserved", "system_used",
           "hp_req", "hp_used", "hp_max")


def batch_allocatable_plain(capacity, node_reserved, system_reserved,
                            system_used, hp_req, hp_used, hp_max,
                            cpu_by_max, mem_policy) -> torch.Tensor:
    """f32[N, 2]: the three-policy batch formula (batchresource
    util.go:38-90); mem_policy 0 usage, 1 request, 2 maxUsageRequest."""
    sys_eff = xla_max(system_used, system_reserved)
    by_usage = xla_max(capacity - node_reserved - sys_eff - hp_used, 0.0)
    by_request = xla_max(
        capacity - node_reserved - system_reserved - hp_req, 0.0)
    by_max = xla_max(capacity - node_reserved - sys_eff - hp_max, 0.0)
    cpu = torch.where(cpu_by_max, by_max[:, CPU], by_usage[:, CPU])
    mem = torch.where(mem_policy == MEM_BY_REQUEST, by_request[:, MEM],
                      torch.where(mem_policy == MEM_BY_MAX, by_max[:, MEM],
                                  by_usage[:, MEM]))
    return torch.stack([cpu, mem], dim=-1)


def mid_allocatable_plain(allocatable, prod_reclaimable,
                          threshold_ratio) -> torch.Tensor:
    """f32[N, 2]: min(ProdReclaimable, Allocatable x ratio), at least 0
    (midresource/plugin.go:130-160)."""
    return xla_max(xla_min(prod_reclaimable, allocatable * threshold_ratio),
                   0.0)


def node_overcommit_plain(capacity, node_reserved, system_reserved,
                          system_used, hp_req, hp_used, hp_max, cpu_by_max,
                          mem_policy, allocatable, prod_reclaimable,
                          threshold_ratio
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(batch f32[N, 2], mid f32[N, 2])."""
    return (batch_allocatable_plain(capacity, node_reserved,
                                    system_reserved, system_used, hp_req,
                                    hp_used, hp_max, cpu_by_max, mem_policy),
            mid_allocatable_plain(allocatable, prod_reclaimable,
                                  threshold_ratio))


def node_overcommit(capacity, node_reserved, system_reserved, system_used,
                    hp_req, hp_used, hp_max, cpu_by_max, mem_policy,
                    allocatable, prod_reclaimable, threshold_ratio
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(batch, mid) of `node_overcommit_plain`: the kernel for CUDA
    tensors, the plain version for CPU tensors. Every column f32[N, 2]
    (cpu millicores, memory MiB); cpu_by_max bool[N]; mem_policy
    i32[N]."""
    n = capacity.shape[0]
    dev = capacity.device
    cols = (capacity, node_reserved, system_reserved, system_used, hp_req,
            hp_used, hp_max, allocatable, prod_reclaimable, threshold_ratio)
    for name, t in zip(COLUMNS + ("allocatable", "prod_reclaimable",
                                  "threshold_ratio"), cols):
        _launch.check_tensor(name, t, torch.float32, (n, 2), dev)
    _launch.check_tensor("cpu_by_max", cpu_by_max, torch.bool, (n,), dev)
    _launch.check_tensor("mem_policy", mem_policy, torch.int32, (n,), dev)
    if dev.type == "cpu":
        return node_overcommit_plain(capacity, node_reserved,
                                     system_reserved, system_used, hp_req,
                                     hp_used, hp_max, cpu_by_max, mem_policy,
                                     allocatable, prod_reclaimable,
                                     threshold_ratio)
    if dev.type != "cuda":
        raise ValueError(f"node_overcommit: unsupported device {dev}")
    batch = torch.empty((n, 2), dtype=torch.float32, device=dev)
    mid = torch.empty_like(batch)
    if not n:
        return batch, mid
    fn = TOOLCHAIN.function("node_overcommit", "koord_node_overcommit",
                            [ctypes.c_void_p] * 12 + [ctypes.c_int]
                            + [ctypes.c_void_p] * 3)
    rc = fn(*(_launch.ptr(t) for t in cols[:7]), _launch.ptr(cpu_by_max),
            _launch.ptr(mem_policy), *(_launch.ptr(t) for t in cols[7:]), n,
            _launch.ptr(batch), _launch.ptr(mid), _launch.stream(dev))
    check(rc, "node_overcommit")
    node_overcommit.launches += 1
    return batch, mid


node_overcommit.launches = 0
