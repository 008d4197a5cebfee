"""DeviceShare: GPU instance fit, scores and choosers in plain PyTorch.

Counterpart of `koordinator_tpu/scheduler/plugins/deviceshare.py`
(plugins/deviceshare): the per-instance request of a GPU pod on a node
(`per_instance_at`), the batch-start prefilter and pool score
(`prefilter`, `score_matrix`; kernel K6 `kernels/device_terms.py` is
held against them), the fitting instances per NUMA zone that feed the
topology manager's DeviceShare hint provider (`gpu_zone_counts`; in
kernel K5), and the inner-step choosers (`choose_gpu_instance` for
shared pods, `full_fit_instances` for multi-GPU pods; kernel K7
`kernels/gpu_instances.py`). `poolless_term` is the prefilter's part
for the kinds a snapshot has no instance of, one bool a pod. The aux
(RDMA/FPGA) pools, one instance serving a whole request
(devicehandler_default.go): their part of the prefilter
(`aux_prefilter`, in kernel K6) and the inner-step chooser
`choose_aux_instance` (kernel K17 `kernels/aux_instances.py`).

Float note: XLA compiles the reference's divisions by the constant 100
as multiplications by float32(0.01), and this module does the same
(`PCT`); the other divisions are IEEE divisions. The pool sums run in
instance order and the score's sum over the three device dims from 0 in
dim order, as XLA:CPU's reduction loops run them; on the scheduler's
integer-valued instance state every pool sum is exact anyway.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.api.extension import AUX_KINDS, ResourceKind
from koordinator_tpu_torch.scheduler.batching import EPS, MAX_NODE_SCORE
from koordinator_tpu_torch.snapshot.schema import DeviceState, PodBatch

GPU_CORE = int(ResourceKind.GPU_CORE)
GPU_MEMORY = int(ResourceKind.GPU_MEMORY)
DEV_CORE, DEV_MEM, DEV_RATIO = 0, 1, 2
STRATEGIES = ("least", "most")
# x / 100 as the reference's compiler rounds it: x * float32(0.01)
PCT = float(np.float32(0.01))


def has_gpu_request(requests: torch.Tensor,
                    gpu_ratio: torch.Tensor) -> torch.Tensor:
    """bool[...]: the pod asks for any GPU resource."""
    return ((requests[..., GPU_CORE] > 0) | (requests[..., GPU_MEMORY] > 0)
            | (gpu_ratio > 0))


def has_device_request(requests: torch.Tensor,
                       gpu_ratio: torch.Tensor) -> torch.Tensor:
    """bool[...]: the pod asks for any device resource (GPU or aux)."""
    out = has_gpu_request(requests, gpu_ratio)
    for kind in AUX_KINDS:
        out = out | (requests[..., kind] > 0)
    return out


def gpu_request(requests: torch.Tensor,
                gpu_ratio: torch.Tensor) -> torch.Tensor:
    """f32[..., 3]: each pod's GPU core, GPU memory and memory-ratio
    request, the columns the per-instance request reads."""
    return torch.stack([requests[..., GPU_CORE], requests[..., GPU_MEMORY],
                        gpu_ratio], dim=-1)


def _per_instance(total_mem: torch.Tensor, gpu_req: torch.Tensor):
    """(count i32[...], per_inst f32[..., 3]): instances a GPU request
    (`gpu_request` columns) takes on nodes whose per-GPU memory is
    total_mem, and the request per instance (devicehandler_gpu.go:54-90,
    integer floors); count 0 and a zero row for pods without a GPU
    request."""
    core, mem, gpu_ratio = gpu_req.unbind(-1)
    mem_specified = mem > 0
    safe_total = torch.clamp_min(total_mem, 1.0)
    ratio_eff = torch.where(mem_specified,
                            torch.floor(mem / safe_total * 100.0), gpu_ratio)
    mem_eff = torch.where(mem_specified, mem,
                          torch.floor(gpu_ratio * total_mem * PCT))
    multi = (ratio_eff > 100.0) & (torch.fmod(ratio_eff, 100.0) == 0.0)
    count = torch.where(multi, ratio_eff * PCT, 1.0)
    per_inst = torch.stack([torch.floor(core / count),
                            torch.floor(mem_eff / count),
                            torch.floor(ratio_eff / count)], dim=-1)
    gpu = (core > 0) | (mem > 0) | (gpu_ratio > 0)
    shape = torch.broadcast_shapes(count.shape, gpu.shape)
    gpu = gpu.expand(shape)
    count = torch.where(gpu, count, 0.0).to(torch.int32)
    return count, per_inst * gpu[..., None]


def per_instance_at(devices: DeviceState, gpu_req: torch.Tensor,
                    node_idx: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(count i32[P], per_inst f32[P, 3]) of each pod's GPU request
    gpu_req f32[P, 3] at its node (node_idx clamped into [0, N): an
    index out of range means "no node")."""
    n = devices.gpu_total.shape[0]
    nc = node_idx.clamp(0, n - 1).long()
    return _per_instance(devices.gpu_total[nc, DEV_MEM], gpu_req)


def _fits(free: torch.Tensor, per_inst: torch.Tensor,
          valid: torch.Tensor) -> torch.Tensor:
    """bool[..., I]: valid instances whose free covers the per-instance
    request on every device dim (free [..., I, 3], per_inst [..., 3])."""
    return torch.all(free + EPS >= per_inst[..., None, :], dim=-1) & valid


def gpu_prefilter(devices: DeviceState, gpu_req: torch.Tensor
                  ) -> torch.Tensor:
    """bool[P, N]: the GPU part of `prefilter` for requests gpu_req
    f32[P, 3]: the node has >= count instances that each fit the
    per-instance request; pods without a GPU request pass everywhere."""
    total_mem = devices.gpu_total[None, :, DEV_MEM]              # [1, N]
    count, per_inst = _per_instance(total_mem, gpu_req[:, None, :])
    fits = _fits(devices.gpu_free[None], per_inst,
                 devices.gpu_valid[None])                        # [P, N, I]
    return ~(gpu_req > 0).any(dim=-1)[:, None] | (fits.sum(dim=-1) >= count)


def aux_request(requests: torch.Tensor) -> torch.Tensor:
    """f32[..., 2]: each pod's RDMA and FPGA request, in pool order."""
    return torch.stack([requests[..., kind] for kind in AUX_KINDS], dim=-1)


def aux_prefilter(devices: DeviceState, aux_req: torch.Tensor
                  ) -> torch.Tensor:
    """bool[P, N]: the aux part of `prefilter` for requests aux_req
    f32[P, 2]: for every pool the pod asks for, the node has a valid
    instance whose free covers the request."""
    ok = torch.ones((aux_req.shape[0], devices.aux_free.shape[0]),
                    dtype=torch.bool, device=aux_req.device)
    for t in range(aux_req.shape[1]):
        req = aux_req[:, t]
        aux_ok = torch.any(
            (devices.aux_free[None, :, t, :] + EPS >= req[:, None, None])
            & devices.aux_valid[None, :, t, :], dim=-1)
        ok = ok & ((req <= 0)[:, None] | aux_ok)
    return ok


def prefilter(devices: DeviceState, pods: PodBatch) -> torch.Tensor:
    """bool[P, N]: the node has >= count instances that each fit the
    per-instance request, and a fitting instance in every aux pool the
    pod asks for; pods without device requests pass everywhere. An
    upper bound: free only shrinks in a batch, and the exact gates run
    in the inner step on the chosen node."""
    return (gpu_prefilter(devices, gpu_request(pods.requests, pods.gpu_ratio))
            & aux_prefilter(devices, aux_request(pods.requests)))


def pool_terms(devices: DeviceState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pool_total f32[N, 3], pool_free f32[N, 3]): each node's GPU pool,
    the per-GPU total times its valid instances and the valid
    instances' free summed in instance order."""
    valid = devices.gpu_valid
    pool_total = devices.gpu_total * valid.sum(dim=-1)[:, None].to(
        torch.float32)
    pool_free = torch.zeros_like(devices.gpu_total)
    for i in range(valid.shape[1]):
        pool_free = pool_free + devices.gpu_free[:, i] * valid[:, i, None]
    return pool_total, pool_free


def gpu_score(devices: DeviceState, gpu_req: torch.Tensor,
              strategy: str = "least") -> torch.Tensor:
    """f32[P, N] in [0, 100]: the least- (or most-) allocated score of the
    node's GPU pool after the allocation of requests gpu_req f32[P, 3],
    averaged over the device dims the pod asks for (scoring.go
    resourceAllocationScorer); 0 for pods without a GPU request."""
    if strategy not in STRATEGIES:
        raise ValueError(f"device strategy {strategy!r}")
    total_mem = devices.gpu_total[None, :, DEV_MEM]
    count, per_inst = _per_instance(total_mem, gpu_req[:, None, :])
    pool_total, pool_free = pool_terms(devices)
    alloc = per_inst * count[..., None]                          # [P, N, 3]
    used_after = (pool_total - pool_free)[None] + alloc
    frac = used_after / torch.clamp_min(pool_total[None], 1e-9)
    w = (per_inst > 0).to(torch.float32)
    wsum = torch.clamp_min(w[..., 0] + w[..., 1] + w[..., 2], 1.0)
    term = frac if strategy == "most" else 1.0 - frac
    s = torch.zeros_like(wsum)
    for d in range(3):
        s = s + term[..., d] * w[..., d]
    score = torch.clamp(s / wsum, 0.0, 1.0) * MAX_NODE_SCORE
    return torch.where((gpu_req > 0).any(dim=-1)[:, None], score, 0.0)


def score_matrix(devices: DeviceState, pods: PodBatch,
                 strategy: str = "least") -> torch.Tensor:
    """`gpu_score` of the batch's pods (the reference's score_matrix)."""
    return gpu_score(devices, gpu_request(pods.requests, pods.gpu_ratio),
                     strategy)


def gpu_zone_counts(gpu_free: torch.Tensor, devices: DeviceState,
                    node_idx: torch.Tensor, per_inst: torch.Tensor,
                    n_zones: int) -> torch.Tensor:
    """i32[P, Z]: the chosen node's instances that fit the per-instance
    request, per NUMA zone (instances of zone -1 or >= Z count in none):
    the input of the DeviceShare hint provider
    (topologymanager.count_hints)."""
    n = gpu_free.shape[0]
    nc = node_idx.clamp(0, n - 1).long()
    fits = _fits(gpu_free[nc], per_inst, devices.gpu_valid[nc])  # [P, I]
    zid = devices.gpu_numa[nc]
    zones = torch.arange(n_zones, dtype=zid.dtype, device=zid.device)
    onehot = zid[:, :, None] == zones[None, None, :]
    return (fits[:, :, None] & onehot).sum(dim=1).to(torch.int32)


def _zone_allowed(devices: DeviceState, nc: torch.Tensor,
                  zone_mask: torch.Tensor,
                  engaged: torch.Tensor) -> torch.Tensor:
    """bool[P, I]: the instance lies inside the pod's NUMA affinity
    zone_mask bool[P, Z'] (an instance of zone -1 lies outside every
    affinity; zones above Z' - 1 read the last column). Pods the
    topology manager does not engage take any instance."""
    zid = devices.gpu_numa[nc]                                   # [P, I]
    in_mask = zone_mask.gather(
        1, zid.clamp(0, zone_mask.shape[1] - 1).long())
    return ~engaged[:, None] | (in_mask & (zid >= 0))


def choose_gpu_instance(gpu_free: torch.Tensor, devices: DeviceState,
                        node_idx: torch.Tensor, per_inst: torch.Tensor,
                        shared: torch.Tensor, zone_mask: torch.Tensor,
                        engaged: torch.Tensor, strategy: str = "least"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inst i32[P], ok bool[P]): each pod's instance on its chosen node
    from the live free, among the valid instances inside its affinity
    that fit: the most free core for "least" (spread), the least for
    "most" (pack), the first index among ties; instance 0 where none
    fits. ok is False only for a shared pod with no fitting instance."""
    n = gpu_free.shape[0]
    nc = node_idx.clamp(0, n - 1).long()
    free = gpu_free[nc]                                          # [P, I, 3]
    fits = _fits(free, per_inst, devices.gpu_valid[nc])
    fits = fits & _zone_allowed(devices, nc, zone_mask, engaged)
    key = free[..., DEV_CORE]
    if strategy == "most":
        inst = torch.argmin(torch.where(fits, key, torch.inf), dim=-1)
    else:
        inst = torch.argmax(torch.where(fits, key, -torch.inf), dim=-1)
    return inst.to(torch.int32), torch.any(fits, dim=-1) | ~shared


def full_fit_instances(gpu_free: torch.Tensor, devices: DeviceState,
                       node_idx: torch.Tensor, per_inst: torch.Tensor,
                       count: torch.Tensor, zone_mask: torch.Tensor,
                       engaged: torch.Tensor,
                       exclude: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(take bool[P, I], enough bool[P]) for multi-GPU pods: the lowest
    index `count` instances of the chosen node that fit, lie inside the
    pod's affinity and are not in `exclude` bool[P, I], and whether
    there are `count` of them."""
    n = gpu_free.shape[0]
    nc = node_idx.clamp(0, n - 1).long()
    fits = _fits(gpu_free[nc], per_inst, devices.gpu_valid[nc])
    if exclude is not None:
        fits = fits & ~exclude
    fits = fits & _zone_allowed(devices, nc, zone_mask, engaged)
    enough = fits.sum(dim=-1) >= count
    cum = torch.cumsum(fits.to(torch.int32), dim=-1)
    return fits & (cum <= count[:, None]), enough


def choose_aux_instance(aux_free: torch.Tensor, devices: DeviceState,
                        node_idx: torch.Tensor, pool: int, req: torch.Tensor,
                        strategy: str = "least"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inst i32[P], ok bool[P]): each pod's instance of aux pool `pool`
    on its chosen node (node_idx clamped into [0, N)) from the live free
    aux_free f32[N, 2, J], among the batch-start valid instances whose
    free covers req f32[P]: the most free for "least", the least free
    for "most", the first index among ties (instance 0 where none
    fits). ok: some instance fits, or the pod asks for nothing."""
    n = aux_free.shape[0]
    nc = node_idx.clamp(0, n - 1).long()
    free = aux_free[nc, pool]                                    # [P, J]
    fits = (free + EPS >= req[:, None]) & devices.aux_valid[nc, pool]
    if strategy == "most":
        inst = torch.argmin(torch.where(fits, free, torch.inf), dim=-1)
    else:
        inst = torch.argmax(torch.where(fits, free, -torch.inf), dim=-1)
    return inst.to(torch.int32), torch.any(fits, dim=-1) | (req <= 0)


def aux_segments(node: torch.Tensor, inst: torch.Tensor,
                 take: torch.Tensor, n_aux: int, drop: int) -> torch.Tensor:
    """i32[P, 2]: the flat (node, pool, instance) row of each pod's aux
    instance in an [N, 2, J] pool, (node * 2 + pool) * J + inst, where
    `take` (bool[P, 2]), else `drop` (the rows the reference's segment
    gates and scatters give its "no instance": N * 2 * J)."""
    pools = torch.arange(inst.shape[1], dtype=torch.int32, device=inst.device)
    return torch.where(take, (node[:, None] * inst.shape[1] + pools) * n_aux
                       + inst, drop).to(torch.int32)


def poolless_term(devices: DeviceState, pods: PodBatch) -> torch.Tensor:
    """bool[P]: the part of `prefilter`'s row that is one bool a pod:
    without GPU instances a pod asking for a GPU resource passes
    nowhere, without aux instances one asking for RDMA or FPGA passes
    nowhere. The kinds the snapshot has instances of pass here: their
    part is pairwise (kernel K6, kernels/device_terms.py)."""
    ok = torch.ones_like(pods.valid)
    if not devices.gpu_free.shape[1]:
        ok = ok & ~has_gpu_request(pods.requests, pods.gpu_ratio)
    if not devices.aux_free.shape[2]:
        ok = ok & ~(aux_request(pods.requests) > 0).any(dim=-1)
    return ok
