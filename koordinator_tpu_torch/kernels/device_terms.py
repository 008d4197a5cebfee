"""K6 device_pair_terms: the batch-start DeviceShare gate and pool score
of every (pod, node) pair.

Kernel: `csrc/device_terms.cu`. Replaces the device part of the static
gates of koordinator_tpu/scheduler/core.py schedule_batch (:305-329):
plugins/deviceshare.py:124 prefilter (its GPU part) and :152
score_matrix over [P, N, I, 3], and the prefilter's aux part (:123-133)
on a snapshot with aux (RDMA/FPGA) pools. It writes what the reference
ANDs into
its static mask (here into K4's pair mask, in place, when there is one)
and adds to its scores; K1 reads both. Under the cascade's stage 2
(core.py:304-327) it runs on the batch's first `rows` pods (the gpu
prefix) and ANDs them into the first rows of the pair mask; the rows
beyond pass and score 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.scheduler.plugins import deviceshare
from koordinator_tpu_torch.snapshot.schema import DeviceState

MAX_INSTANCES = 64


def device_pair_terms_plain(gpu_req: torch.Tensor, devices: DeviceState,
                            strategy: str,
                            pair_ok: Optional[torch.Tensor] = None,
                            aux_req: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(pair_ok, pair_score f32[rows, N]) of the first `rows` pods (the
    rows of gpu_req): the GPU prefilter where the snapshot has GPU
    instances, ANDed with the aux prefilter where aux_req is given
    (bool[rows, N], or a given pair_ok bool[P, N] with its first rows
    ANDed), and the pool score (None without GPU instances), by the
    plain functions of `scheduler/plugins/deviceshare.py`."""
    gpu = devices.gpu_free.shape[1] > 0
    ok = (deviceshare.gpu_prefilter(devices, gpu_req) if gpu else
          torch.ones((gpu_req.shape[0], devices.gpu_free.shape[0]),
                     dtype=torch.bool, device=gpu_req.device))
    if aux_req is not None:
        ok = ok & deviceshare.aux_prefilter(devices, aux_req)
    return (_launch.and_rows(pair_ok, ok),
            deviceshare.gpu_score(devices, gpu_req, strategy) if gpu
            else None)


def device_pair_terms(gpu_req: torch.Tensor, devices: DeviceState,
                      strategy: str, pair_ok: Optional[torch.Tensor] = None,
                      aux_req: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The pair terms of `device_pair_terms_plain`: the kernel for CUDA
    tensors, the plain version for CPU tensors. gpu_req f32[rows, 3] (the
    GPU core, memory and memory ratio of the batch's first rows pods,
    `deviceshare.gpu_request`); `devices` gpu_total f32[N, 3], gpu_free
    f32[N, I, 3], gpu_valid bool[N, I] and, with aux_req f32[rows, 2]
    (`deviceshare.aux_request`), aux_free f32[N, 2, J] and aux_valid
    bool[N, 2, J]; strategy "least" or "most"; pair_ok bool[P, N]
    (P >= rows) or None. On the card a given pair_ok has its first rows
    ANDed in place and is returned. Takes I <= 64 and J <= 64, with
    I >= 1 or an aux part (J >= 1); rows and N unlimited (rows = 0
    launches nothing). The score is None where I = 0."""
    p = gpu_req.shape[0]
    n, i, _ = devices.gpu_free.shape
    j = devices.aux_free.shape[2]
    dev = gpu_req.device
    checks = [("gpu_req", gpu_req, torch.float32, (p, 3)),
              ("gpu_total", devices.gpu_total, torch.float32, (n, 3)),
              ("gpu_free", devices.gpu_free, torch.float32, (n, i, 3)),
              ("gpu_valid", devices.gpu_valid, torch.bool, (n, i))]
    if aux_req is not None:
        checks += [("aux_req", aux_req, torch.float32, (p, 2)),
                   ("aux_free", devices.aux_free, torch.float32, (n, 2, j)),
                   ("aux_valid", devices.aux_valid, torch.bool, (n, 2, j))]
    if pair_ok is not None:
        checks.append(("pair_ok", pair_ok, torch.bool, (None, n)))
        if pair_ok.shape[0] < p:
            raise ValueError(f"device_pair_terms: pair_ok has "
                             f"{pair_ok.shape[0]} rows, fewer than {p}")
    for name, t, dt, shape in checks:
        _launch.check_tensor(name, t, dt, shape, dev)
    if strategy not in deviceshare.STRATEGIES:
        raise ValueError(f"device_pair_terms: strategy {strategy!r}")
    if not i and aux_req is None:
        raise ValueError("device_pair_terms: no GPU instance and no aux "
                         "part: nothing to gate")
    if dev.type == "cpu":
        return device_pair_terms_plain(gpu_req, devices, strategy, pair_ok,
                                       aux_req)
    if dev.type != "cuda":
        raise ValueError(f"device_pair_terms: unsupported device {dev}")
    if aux_req is None:
        j = 0
    if i > MAX_INSTANCES or j > MAX_INSTANCES or (aux_req is not None
                                                  and not j):
        raise ValueError(f"device_pair_terms: I={i}, J={j} outside [0, "
                         f"{MAX_INSTANCES}] (J >= 1 with an aux part)")
    ok = (pair_ok if pair_ok is not None
          else torch.empty((p, n), dtype=torch.bool, device=dev))
    score = (torch.empty((p, n), dtype=torch.float32, device=dev) if i
             else None)
    if not (p and n):
        return ok, score
    tensors = (gpu_req, devices.gpu_total, devices.gpu_free,
               devices.gpu_valid, pair_ok, ok, score, aux_req,
               devices.aux_free if j else None,
               devices.aux_valid if j else None)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    fn = TOOLCHAIN.function("device_terms", "koord_device_pair_terms",
                            [ctypes.c_void_p] + [ctypes.c_int] * 5
                            + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(ptrs, p, n, i, j, int(strategy == "least"), EPS,
            _launch.stream(dev))
    check(rc, "device_pair_terms")
    device_pair_terms.launches += 1
    return ok, score


device_pair_terms.launches = 0
