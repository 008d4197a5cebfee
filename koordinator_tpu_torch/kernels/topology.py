"""K5 topology_admit: the topology manager of one inner commit step, one
thread a pod.

Kernel: `csrc/topology_admit.cu`. Replaces the block at
koordinator_tpu/scheduler/core.py:907-948 (and the reported zone of
:1068): for each trying pod, the chosen node's live zone free, the
effective policy, the CPU+memory provider's hints
(topologymanager.py:67 capacity_hints), on the DeviceShare path the GPU
provider's (core.py:930-940: deviceshare.py:111 per_instance_at, :184
gpu_zone_counts on the live instance free, topologymanager.py:97
count_hints), their merge (:119 merge_hints), the policy outcome (:130
resolve) and the greedy zone take (:197 greedy_take). On the TPU these
are a few dozen small fused ops a step; here they are one launch, a
warp a pod.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from koordinator_tpu_torch.api.extension import (
    NUMA_POLICY_NONE,
    NUMA_POLICY_SINGLE_NUMA_NODE,
)
from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.scheduler import topologymanager as tm
from koordinator_tpu_torch.scheduler.plugins import deviceshare
from koordinator_tpu_torch.snapshot.schema import DeviceState

MAX_ZONES = 8
STRATEGIES = ("most", "least")


class Admission(NamedTuple):
    affinity: torch.Tensor   # bool[P, Z] the resolved NUMA affinity
    engaged: torch.Tensor    # bool[P] a policy constrains the pod
    admit: torch.Tensor      # bool[P] policy admits, and the take fills
                             # the request where engaged
    take: torch.Tensor       # f32[P, Z, 2] the pod's take per zone (zero
                             # rows where not engaged)
    zone1: torch.Tensor      # i32[P] the first zone of the affinity, 0
                             # where it has none


def topology_admit_plain(choice: torch.Tensor, trying: torch.Tensor,
                         numa_single: torch.Tensor, demand: torch.Tensor,
                         numa_cap: torch.Tensor, numa_used: torch.Tensor,
                         numa_valid: torch.Tensor, numa_policy: torch.Tensor,
                         strategy: str, gpu_req: Optional[torch.Tensor] = None,
                         devices: Optional[DeviceState] = None) -> Admission:
    """The step's topology manager, composed of the plain functions of
    `scheduler/topologymanager.py` as the reference composes its own:
    each trying pod on its chosen node (`choice` clamped into [0, S)),
    the single-numa-node policy for NUMA-bound pods and the node's own
    for the others, the CPU+memory provider and, given `devices` (the
    live instance pool) and `gpu_req`, the DeviceShare provider."""
    s = numa_cap.shape[0]
    nc = choice.clamp(0, s - 1).long()
    policy = torch.where(numa_single, NUMA_POLICY_SINGLE_NUMA_NODE,
                         numa_policy[nc])
    policy = torch.where(trying, policy, 0).to(torch.int32)
    engaged = policy > NUMA_POLICY_NONE
    free_z = torch.clamp_min(numa_cap[nc] - numa_used[nc], 0.0)
    valid = numa_valid[nc]
    req = demand * engaged[:, None]
    hints = [tm.capacity_hints(free_z, req, valid)]
    if devices is not None:
        count, per_inst = deviceshare.per_instance_at(devices, gpu_req,
                                                      choice)
        zone_counts = deviceshare.gpu_zone_counts(
            devices.gpu_free, devices, choice, per_inst, numa_cap.shape[1])
        hints.append(tm.count_hints(zone_counts, count * engaged))
    fit, pref = tm.merge_hints(hints)
    affinity, admit, _ = tm.resolve(fit, pref, policy, free_z[..., 0], valid,
                                    strategy)
    take, filled = tm.greedy_take(free_z, req, affinity, strategy)
    zone1 = torch.argmax(affinity.to(torch.int32), dim=-1).to(torch.int32)
    return Admission(affinity, engaged, admit & (~engaged | filled), take,
                     zone1)


def topology_admit(choice: torch.Tensor, trying: torch.Tensor,
                   numa_single: torch.Tensor, demand: torch.Tensor,
                   numa_cap: torch.Tensor, numa_used: torch.Tensor,
                   numa_valid: torch.Tensor, numa_policy: torch.Tensor,
                   strategy: str, gpu_req: Optional[torch.Tensor] = None,
                   devices: Optional[DeviceState] = None) -> Admission:
    """The step of `topology_admit_plain`: the kernel for CUDA tensors,
    the plain version for CPU tensors. choice i32[P] (values >= S or < 0
    are clamped into the table, as the reference's gather); trying,
    numa_single bool[P]; demand f32[P, 2]; numa_cap, numa_used
    f32[S, Z, 2]; numa_valid bool[S, Z]; numa_policy i32[S]; strategy
    "most" or "least"; with the DeviceShare provider, gpu_req f32[P, 3]
    (each pod's GPU core, memory and memory ratio,
    `deviceshare.gpu_request`) and `devices` with its live gpu_free
    (gpu_total f32[S, 3], gpu_free f32[S, I, 3], gpu_valid bool[S, I],
    gpu_numa i32[S, I]). Takes any P (a warp a pod, a grid of
    blocks), Z <= 8 and any I."""
    p = choice.shape[0]
    s, z, _ = numa_cap.shape
    dev = choice.device
    if (gpu_req is None) != (devices is None):
        raise ValueError("topology_admit: gpu_req and devices go together")
    checks = [
        ("choice", choice, torch.int32, (p,)),
        ("trying", trying, torch.bool, (p,)),
        ("numa_single", numa_single, torch.bool, (p,)),
        ("demand", demand, torch.float32, (p, 2)),
        ("numa_cap", numa_cap, torch.float32, (s, z, 2)),
        ("numa_used", numa_used, torch.float32, (s, z, 2)),
        ("numa_valid", numa_valid, torch.bool, (s, z)),
        ("numa_policy", numa_policy, torch.int32, (s,))]
    n_inst = 0
    if devices is not None:
        n_inst = devices.gpu_free.shape[1]
        checks += [
            ("gpu_req", gpu_req, torch.float32, (p, 3)),
            ("gpu_total", devices.gpu_total, torch.float32, (s, 3)),
            ("gpu_free", devices.gpu_free, torch.float32, (s, n_inst, 3)),
            ("gpu_valid", devices.gpu_valid, torch.bool, (s, n_inst)),
            ("gpu_numa", devices.gpu_numa, torch.int32, (s, n_inst))]
    for name, t, dt, shape in checks:
        _launch.check_tensor(name, t, dt, shape, dev)
    if strategy not in STRATEGIES:
        raise ValueError(f"topology_admit: strategy {strategy!r}")
    if s == 0 or z == 0:
        raise ValueError("topology_admit: empty zone table")
    if dev.type == "cpu":
        return topology_admit_plain(choice, trying, numa_single, demand,
                                    numa_cap, numa_used, numa_valid,
                                    numa_policy, strategy, gpu_req, devices)
    if dev.type != "cuda":
        raise ValueError(f"topology_admit: unsupported device {dev}")
    if z > MAX_ZONES:
        raise ValueError(f"topology_admit: Z={z} above its capacity "
                         f"({MAX_ZONES})")
    out = Admission(
        affinity=torch.empty((p, z), dtype=torch.bool, device=dev),
        engaged=torch.empty((p,), dtype=torch.bool, device=dev),
        admit=torch.empty((p,), dtype=torch.bool, device=dev),
        take=torch.empty((p, z, 2), dtype=torch.float32, device=dev),
        zone1=torch.empty((p,), dtype=torch.int32, device=dev))
    gpu = ((gpu_req, devices.gpu_total, devices.gpu_free, devices.gpu_valid,
            devices.gpu_numa) if devices is not None else (None,) * 5)
    tensors = (choice, trying, numa_single, demand, numa_cap, numa_used,
               numa_valid, numa_policy) + tuple(out) + gpu
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    fn = TOOLCHAIN.function("topology_admit", "koord_topology_admit",
                            [ctypes.c_void_p] + [ctypes.c_int] * 5
                            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    rc = fn(ptrs, p, s, z, n_inst, STRATEGIES.index(strategy), EPS,
            1.0 + EPS, _launch.stream(dev))
    check(rc, "topology_admit")
    topology_admit.launches += 1
    return out


topology_admit.launches = 0
