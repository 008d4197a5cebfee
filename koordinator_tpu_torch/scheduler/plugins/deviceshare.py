"""The DeviceShare batch-start prefilter in plain PyTorch.

Counterpart of `koordinator_tpu/scheduler/plugins/deviceshare.py`
has_gpu_request and prefilter (plugins/deviceshare): the slim path runs
the prefilter with zero GPU and aux instances, where it rejects every
device-requesting pod and passes the rest; `zero_instance_term` gives
that as one bool a pod, without the [P, N] form. The instance gates,
scores and choosers of the full-gate path are not ported yet.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.api.extension import AUX_KINDS, ResourceKind
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.snapshot.schema import DeviceState, PodBatch

GPU_CORE = int(ResourceKind.GPU_CORE)
GPU_MEMORY = int(ResourceKind.GPU_MEMORY)
DEV_MEM = 1


def has_gpu_request(requests: torch.Tensor,
                    gpu_ratio: torch.Tensor) -> torch.Tensor:
    """bool[...]: the pod asks for any GPU resource."""
    return ((requests[..., GPU_CORE] > 0) | (requests[..., GPU_MEMORY] > 0)
            | (gpu_ratio > 0))


def _per_instance(total_mem: torch.Tensor, requests: torch.Tensor,
                  gpu_ratio: torch.Tensor):
    """(count, per_inst[..., 3]): instances a GPU request takes on nodes
    whose per-GPU memory is total_mem, and the request per instance
    (devicehandler_gpu.go:54-90, integer floors)."""
    core = requests[..., GPU_CORE]
    mem = requests[..., GPU_MEMORY]
    mem_specified = mem > 0
    safe_total = torch.clamp_min(total_mem, 1.0)
    ratio_eff = torch.where(mem_specified,
                            torch.floor(mem / safe_total * 100.0), gpu_ratio)
    mem_eff = torch.where(mem_specified, mem,
                          torch.floor(gpu_ratio * total_mem / 100.0))
    multi = (ratio_eff > 100.0) & (torch.fmod(ratio_eff, 100.0) == 0.0)
    count = torch.where(multi, ratio_eff / 100.0, 1.0)
    per_inst = torch.stack([torch.floor(core / count),
                            torch.floor(mem_eff / count),
                            torch.floor(ratio_eff / count)], dim=-1)
    gpu = has_gpu_request(requests, gpu_ratio)
    count = torch.where(gpu, count, 0.0).to(torch.int32)
    return count, per_inst * gpu[..., None]


def prefilter(devices: DeviceState, pods: PodBatch) -> torch.Tensor:
    """bool[P, N]: the node has >= count instances that each fit the
    per-instance request, and a fitting instance in every aux pool the
    pod asks for; pods without device requests pass everywhere."""
    total_mem = devices.gpu_total[None, :, DEV_MEM]              # [1, N]
    count, per_inst = _per_instance(
        total_mem, pods.requests[:, None, :], pods.gpu_ratio[:, None])
    fits = torch.all(devices.gpu_free[None] + EPS >= per_inst[:, :, None, :],
                     dim=-1) & devices.gpu_valid[None]          # [P, N, I]
    n_fit = fits.sum(dim=-1)
    ok = ~has_gpu_request(pods.requests, pods.gpu_ratio)[:, None] \
        | (n_fit >= count)
    for t, kind in enumerate(AUX_KINDS):
        req = pods.requests[:, kind]
        aux_ok = torch.any(
            (devices.aux_free[None, :, t, :] + EPS >= req[:, None, None])
            & devices.aux_valid[None, :, t, :], dim=-1)
        ok = ok & ((req <= 0)[:, None] | aux_ok)
    return ok


def zero_instance_term(devices: DeviceState, pods: PodBatch) -> torch.Tensor:
    """bool[P]: `prefilter`'s row of each pod when the snapshot holds no
    GPU and no aux instance (every node the same): the pod asks for no
    GPU resource and for no aux resource. Raises NotImplementedError on
    a snapshot with instances, whose prefilter is pairwise."""
    if devices.gpu_free.shape[1] or devices.aux_free.shape[2]:
        raise NotImplementedError(
            "the device prefilter with GPU instances or aux pools is not "
            "ported yet (ROADMAP queue A item 6)")
    ok = ~has_gpu_request(pods.requests, pods.gpu_ratio)
    for kind in AUX_KINDS:
        ok = ok & (pods.requests[:, kind] <= 0)
    return ok
