"""K7 gpu_instance_pick: the GPU instance gates of one inner commit step.

Kernel: `csrc/gpu_instances.cu`. Replaces the GPU block of
koordinator_tpu/scheduler/core.py schedule_batch (:898-906, :962-1016):
plugins/deviceshare.py:111 per_instance_at, :212 choose_gpu_instance
and :246 full_fit_instances, and the one-multi-GPU-pod-a-node rule. A
step launches it twice around one K2 launch:

1. choose (`chosen` None): each pod's count and per-instance request at
   its chosen node, a shared pod's instance, and the operands of the K2
   launch (`GpuChoice.gate_active`, `.seg`, `.req`): level 0 gates the
   shared pods over (node, instance) segments against the live instance
   free; level 1 admits the first multi-GPU pod of each node in priority
   order (a request of one against a capacity of one);
2. take (`chosen` the first launch's result, `active` what K2 left
   alive): the final accept of the step and each pod's instances, the
   multi-GPU pods taking whole instances that this step's shared pods
   did not take.

On the card the take is one launch: it marks the shared pods' instances
in a 64-bit word a node (`GpuChoice.taken`, whose chosen nodes' words
the choose launch zeroed) and takes the multi-GPU pods' instances after
a grid barrier.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.scheduler.plugins import deviceshare
from koordinator_tpu_torch.snapshot.schema import DeviceState

MAX_INSTANCES = 64


class GpuChoice(NamedTuple):
    count: torch.Tensor        # i32[P] instances the pod takes, 0 = none
    per_inst: torch.Tensor     # f32[P, 3] its request per instance
    inst: torch.Tensor         # i32[P] a shared pod's instance
    gate_active: torch.Tensor  # bool[P] the pods K2's gate starts from
    seg: torch.Tensor          # i32[2, P] K2's segments: (node, instance)
                               # of shared pods, node of multi-GPU pods
    req: torch.Tensor          # f32[2, P, 3] K2's per-level requests
    taken: Optional[torch.Tensor] = None
                               # the card's take words, i64[N] (a bit an
                               # instance; the chosen nodes' zeroed), for
                               # the take launch; None on the host


class GpuTake(NamedTuple):
    accept: torch.Tensor       # bool[P] the step's final accept
    take: torch.Tensor         # bool[P, I] the instances each pod took


def _zone_terms(p: int, affinity, engaged, dev):
    """(zone_mask, engaged) as the reference feeds its choosers: with
    the topology manager off, one open zone and no pod engaged."""
    if affinity is None:
        return (torch.ones((p, 1), dtype=torch.bool, device=dev),
                torch.zeros((p,), dtype=torch.bool, device=dev))
    return affinity, engaged


def gpu_choose_plain(choice: torch.Tensor, active: torch.Tensor,
                     gpu_req: torch.Tensor, devices: DeviceState,
                     affinity: Optional[torch.Tensor],
                     engaged: Optional[torch.Tensor],
                     strategy: str) -> GpuChoice:
    """The choose launch by the plain functions of
    `scheduler/plugins/deviceshare.py`, as the reference composes them."""
    n, i = devices.gpu_valid.shape
    p = choice.shape[0]
    zone_mask, eng = _zone_terms(p, affinity, engaged, choice.device)
    count, per_inst = deviceshare.per_instance_at(devices, gpu_req, choice)
    shared, multi = count == 1, count > 1
    inst, inst_ok = deviceshare.choose_gpu_instance(
        devices.gpu_free, devices, choice, per_inst, shared, zone_mask, eng,
        strategy)
    gate = active & inst_ok
    seg = torch.stack([torch.where(gate & shared, choice * i + inst, n * i),
                       torch.where(gate & multi, choice, n)]).to(torch.int32)
    one = torch.zeros_like(per_inst)
    one[:, 0] = 1.0
    return GpuChoice(count, per_inst, inst, gate, seg,
                     torch.stack([per_inst, one]))


def gpu_take_plain(choice: torch.Tensor, alive: torch.Tensor,
                   chosen: GpuChoice, devices: DeviceState,
                   affinity: Optional[torch.Tensor],
                   engaged: Optional[torch.Tensor]) -> GpuTake:
    """The take launch by the plain functions of
    `scheduler/plugins/deviceshare.py`: the shared pods' takes of the
    step marked on the (node, instance) table and excluded from the
    multi-GPU pods' whole-instance takes."""
    n, i = devices.gpu_valid.shape
    p = choice.shape[0]
    zone_mask, eng = _zone_terms(p, affinity, engaged, choice.device)
    shared, multi = chosen.count == 1, chosen.count > 1
    took_shared = alive & shared
    taken = torch.zeros((n * i + 1,), dtype=torch.bool, device=choice.device)
    taken[torch.where(took_shared, choice * i + chosen.inst, n * i).long()] \
        = True
    nc = choice.clamp(0, n - 1).long()
    take, enough = deviceshare.full_fit_instances(
        devices.gpu_free, devices, choice, chosen.per_inst, chosen.count,
        zone_mask, eng, exclude=taken[:-1].view(n, i)[nc])
    accept = torch.where(multi, alive & enough, alive)
    onehot = (torch.arange(i, device=choice.device)[None, :]
              == chosen.inst[:, None])
    return GpuTake(accept, (onehot & took_shared[:, None])
                   | (take & (accept & multi)[:, None]))


def gpu_instance_pick(choice: torch.Tensor, active: torch.Tensor,
                      gpu_req: torch.Tensor, devices: DeviceState,
                      affinity: Optional[torch.Tensor],
                      engaged: Optional[torch.Tensor], strategy: str,
                      chosen: Optional[GpuChoice] = None):
    """One of the step's two launches: the choose launch (`chosen` None,
    `active` the pods the earlier gates admitted) returns a `GpuChoice`;
    the take launch (`chosen` that result, `active` what K2 left alive)
    returns a `GpuTake`. The kernel for CUDA tensors, the plain version
    for CPU tensors. choice i32[P] (clamped into [0, N) where it is read;
    an admitted pod's is in range); gpu_req f32[P, 3]
    (`deviceshare.gpu_request`); `devices` the live instance pool
    (gpu_total f32[N, 3], gpu_free f32[N, I, 3], gpu_valid bool[N, I],
    gpu_numa i32[N, I]); affinity bool[P, Z] and engaged bool[P] from
    the topology manager, or both None when it is off; strategy "least"
    or "most". Takes 1 <= I <= 64 and any P. On the card the take
    launch reads the words of `chosen` (this step's choose launch on the
    same `choice`)."""
    p = choice.shape[0]
    n, i, _ = devices.gpu_free.shape
    dev = choice.device
    if (affinity is None) != (engaged is None):
        raise ValueError("gpu_instance_pick: affinity and engaged go "
                         "together")
    checks = [("choice", choice, torch.int32, (p,)),
              ("active", active, torch.bool, (p,)),
              ("gpu_req", gpu_req, torch.float32, (p, 3)),
              ("gpu_total", devices.gpu_total, torch.float32, (n, 3)),
              ("gpu_free", devices.gpu_free, torch.float32, (n, i, 3)),
              ("gpu_valid", devices.gpu_valid, torch.bool, (n, i)),
              ("gpu_numa", devices.gpu_numa, torch.int32, (n, i))]
    z = 1
    if affinity is not None:
        z = affinity.shape[1]
        checks += [("affinity", affinity, torch.bool, (p, z)),
                   ("engaged", engaged, torch.bool, (p,))]
    if chosen is not None:
        checks += [("count", chosen.count, torch.int32, (p,)),
                   ("per_inst", chosen.per_inst, torch.float32, (p, 3)),
                   ("inst", chosen.inst, torch.int32, (p,))]
    for name, t, dt, shape in checks:
        _launch.check_tensor(name, t, dt, shape, dev)
    if strategy not in deviceshare.STRATEGIES:
        raise ValueError(f"gpu_instance_pick: strategy {strategy!r}")
    if n == 0 or i == 0 or z == 0:
        raise ValueError("gpu_instance_pick: empty instance or zone table")
    if dev.type == "cpu":
        if chosen is None:
            return gpu_choose_plain(choice, active, gpu_req, devices,
                                    affinity, engaged, strategy)
        return gpu_take_plain(choice, active, chosen, devices, affinity,
                              engaged)
    if dev.type != "cuda":
        raise ValueError(f"gpu_instance_pick: unsupported device {dev}")
    if i > MAX_INSTANCES:
        raise ValueError(f"gpu_instance_pick: I={i} above its capacity "
                         f"({MAX_INSTANCES})")
    if chosen is not None and chosen.taken is None:
        raise ValueError("gpu_instance_pick: the take launch needs the "
                         "card's choose result (chosen.taken)")
    pool = (devices.gpu_total, devices.gpu_free, devices.gpu_valid,
            devices.gpu_numa)
    stream = _launch.stream(dev)
    if chosen is None:
        out = GpuChoice(
            count=torch.empty((p,), dtype=torch.int32, device=dev),
            per_inst=torch.empty((p, 3), dtype=torch.float32, device=dev),
            inst=torch.empty((p,), dtype=torch.int32, device=dev),
            gate_active=torch.empty((p,), dtype=torch.bool, device=dev),
            seg=torch.empty((2, p), dtype=torch.int32, device=dev),
            req=torch.empty((2, p, 3), dtype=torch.float32, device=dev),
            taken=torch.empty((n,), dtype=torch.int64, device=dev))
        tensors = pool + (choice, active, gpu_req, affinity, engaged) \
            + tuple(out)
        fn = TOOLCHAIN.function("gpu_instances", "koord_gpu_choose",
                                [ctypes.c_void_p] + [ctypes.c_int] * 5
                                + [ctypes.c_float, ctypes.c_void_p])
        args = (p, n, i, z, int(strategy == "least"), EPS, stream)
    else:
        out = GpuTake(
            accept=torch.empty((p,), dtype=torch.bool, device=dev),
            take=torch.empty((p, i), dtype=torch.bool, device=dev))
        tensors = pool + (choice, active, chosen.count, chosen.per_inst,
                          chosen.inst, affinity, engaged) + tuple(out) \
            + (chosen.taken,)
        fn = TOOLCHAIN.function("gpu_instances", "koord_gpu_take",
                                [ctypes.c_void_p] + [ctypes.c_int] * 4
                                + [ctypes.c_float, ctypes.c_void_p])
        args = (p, n, i, z, EPS, stream)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    check(fn(ptrs, *args), "gpu_instance_pick")
    gpu_instance_pick.launches += 1
    return out


gpu_instance_pick.launches = 0
