"""K6 device_pair_terms: the batch-start DeviceShare gate and pool score
of every (pod, node) pair.

Kernel: `csrc/device_terms.cu`. Replaces the device part of the static
gates of koordinator_tpu/scheduler/core.py schedule_batch (:305-329):
plugins/deviceshare.py:124 prefilter (its GPU part) and :152
score_matrix over [P, N, I, 3]. It writes what the reference ANDs into
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

MAX_INSTANCES = 16


def device_pair_terms_plain(gpu_req: torch.Tensor, devices: DeviceState,
                            strategy: str,
                            pair_ok: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pair_ok, pair_score f32[rows, N]) of the first `rows` pods (the
    rows of gpu_req): the GPU prefilter (bool[rows, N], or a given
    pair_ok bool[P, N] with its first rows ANDed) and the pool score, by
    the plain functions of `scheduler/plugins/deviceshare.py`."""
    ok = deviceshare.gpu_prefilter(devices, gpu_req)
    return (_launch.and_rows(pair_ok, ok),
            deviceshare.gpu_score(devices, gpu_req, strategy))


def device_pair_terms(gpu_req: torch.Tensor, devices: DeviceState,
                      strategy: str, pair_ok: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pair terms of `device_pair_terms_plain`: the kernel for CUDA
    tensors, the plain version for CPU tensors. gpu_req f32[rows, 3] (the
    GPU core, memory and memory ratio of the batch's first rows pods,
    `deviceshare.gpu_request`); `devices` gpu_total f32[N, 3], gpu_free
    f32[N, I, 3], gpu_valid bool[N, I]; strategy "least" or "most";
    pair_ok bool[P, N] (P >= rows) or None. On the card a given pair_ok
    has its first rows ANDed in place and is returned. Takes
    1 <= I <= 16; rows and N unlimited (rows = 0 launches nothing)."""
    p = gpu_req.shape[0]
    n, i, _ = devices.gpu_free.shape
    dev = gpu_req.device
    checks = [("gpu_req", gpu_req, torch.float32, (p, 3)),
              ("gpu_total", devices.gpu_total, torch.float32, (n, 3)),
              ("gpu_free", devices.gpu_free, torch.float32, (n, i, 3)),
              ("gpu_valid", devices.gpu_valid, torch.bool, (n, i))]
    if pair_ok is not None:
        checks.append(("pair_ok", pair_ok, torch.bool, (None, n)))
        if pair_ok.shape[0] < p:
            raise ValueError(f"device_pair_terms: pair_ok has "
                             f"{pair_ok.shape[0]} rows, fewer than {p}")
    for name, t, dt, shape in checks:
        _launch.check_tensor(name, t, dt, shape, dev)
    if strategy not in deviceshare.STRATEGIES:
        raise ValueError(f"device_pair_terms: strategy {strategy!r}")
    if dev.type == "cpu":
        return device_pair_terms_plain(gpu_req, devices, strategy, pair_ok)
    if dev.type != "cuda":
        raise ValueError(f"device_pair_terms: unsupported device {dev}")
    if not 0 < i <= MAX_INSTANCES:
        raise ValueError(f"device_pair_terms: I={i} outside [1, "
                         f"{MAX_INSTANCES}]")
    ok = (pair_ok if pair_ok is not None
          else torch.empty((p, n), dtype=torch.bool, device=dev))
    score = torch.empty((p, n), dtype=torch.float32, device=dev)
    if not (p and n):
        return ok, score
    tensors = (gpu_req, devices.gpu_total, devices.gpu_free,
               devices.gpu_valid, pair_ok, ok, score)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    fn = TOOLCHAIN.function("device_terms", "koord_device_pair_terms",
                            [ctypes.c_void_p] + [ctypes.c_int] * 4
                            + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(ptrs, p, n, i, int(strategy == "least"), EPS,
            _launch.stream(dev))
    check(rc, "device_pair_terms")
    device_pair_terms.launches += 1
    return ok, score


device_pair_terms.launches = 0
