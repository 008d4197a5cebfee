"""K17 aux_instance_pick: each pod's aux (RDMA/FPGA) instance on its
chosen node, both pools in one launch.

Kernel: `csrc/aux_instances.cu`. Replaces
koordinator_tpu/scheduler/plugins/deviceshare.py:274 choose_aux_instance,
which schedule_batch calls once a pool in every inner commit step
(core.py:1020-1039). The step's K2 launch then gates the chosen (node,
pool, instance) segments and K3 commits them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from koordinator_tpu_torch.api.extension import NUM_AUX_TYPES
from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.scheduler.plugins import deviceshare
from koordinator_tpu_torch.snapshot.schema import DeviceState

MAX_AUX_INSTANCES = 64


def aux_instance_pick_plain(choice: torch.Tensor, req: torch.Tensor,
                            aux_free: torch.Tensor, devices: DeviceState,
                            strategy: str
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inst i32[P, 2], ok bool[P, 2]): `deviceshare.choose_aux_instance`
    for each pool t on req[:, t], stacked in pool order."""
    picks = [deviceshare.choose_aux_instance(aux_free, devices, choice, t,
                                             req[:, t], strategy)
             for t in range(NUM_AUX_TYPES)]
    return (torch.stack([x[0] for x in picks], dim=1),
            torch.stack([x[1] for x in picks], dim=1))


def aux_instance_pick(choice: torch.Tensor, req: torch.Tensor,
                      aux_free: torch.Tensor, devices: DeviceState,
                      strategy: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The choice of `aux_instance_pick_plain`: the kernel for CUDA
    tensors, the plain version for CPU tensors. choice i32[P] (the
    pod's chosen node; any value, clamped into [0, N)); req f32[P, 2]
    (the RDMA and FPGA requests, `deviceshare.aux_request`); aux_free
    f32[N, 2, J] the step's live free; devices.aux_valid bool[N, 2, J]
    the batch-start valid bits; strategy "least" or "most". Takes any
    P and 1 <= J <= 64."""
    p = choice.shape[0]
    n, _, j = aux_free.shape
    dev = choice.device
    for name, t, dt, shape in (
            ("choice", choice, torch.int32, (p,)),
            ("req", req, torch.float32, (p, NUM_AUX_TYPES)),
            ("aux_free", aux_free, torch.float32, (n, NUM_AUX_TYPES, j)),
            ("aux_valid", devices.aux_valid, torch.bool,
             (n, NUM_AUX_TYPES, j))):
        _launch.check_tensor(name, t, dt, shape, dev)
    if strategy not in deviceshare.STRATEGIES:
        raise ValueError(f"aux_instance_pick: strategy {strategy!r}")
    if not n or not j:
        raise ValueError(f"aux_instance_pick: N={n}, J={j}: no instance")
    if dev.type == "cpu":
        return aux_instance_pick_plain(choice, req, aux_free, devices,
                                       strategy)
    if dev.type != "cuda":
        raise ValueError(f"aux_instance_pick: unsupported device {dev}")
    if j > MAX_AUX_INSTANCES:
        raise ValueError(f"aux_instance_pick: J={j} above its capacity "
                         f"({MAX_AUX_INSTANCES})")
    inst = torch.empty((p, NUM_AUX_TYPES), dtype=torch.int32, device=dev)
    ok = torch.empty((p, NUM_AUX_TYPES), dtype=torch.bool, device=dev)
    if not p:
        return inst, ok
    fn = TOOLCHAIN.function("aux_instances", "koord_aux_instance_pick",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                            + [ctypes.c_float] + [ctypes.c_void_p] * 3)
    rc = fn(_launch.ptr(choice), _launch.ptr(req), _launch.ptr(aux_free),
            _launch.ptr(devices.aux_valid), p, n, j,
            int(strategy == "least"), EPS, _launch.ptr(inst), _launch.ptr(ok),
            _launch.stream(dev))
    check(rc, "aux_instance_pick")
    aux_instance_pick.launches += 1
    return inst, ok


aux_instance_pick.launches = 0
