"""K4 numa_pair_terms: the batch-start NUMA gates and zone score of every
(pod, node) pair.

Kernel: `csrc/numa_terms.cu`. Replaces the NUMA part of the static
gates of koordinator_tpu/scheduler/core.py schedule_batch (:329-370):
plugins/numaaware.py:54 zone_prefilter and :70 numa_score_matrix over
[P, N, Z, 2], and the policy node's combined-fit prefilter. It writes
what the reference ANDs into its static mask and adds to its scores;
K1 reads both.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.scheduler.plugins import numaaware

MAX_ZONES = 4
STRATEGIES = ("most", "least")


def numa_pair_terms_plain(demand: torch.Tensor, numa_single: torch.Tensor,
                          numa_cap: torch.Tensor, numa_free: torch.Tensor,
                          numa_valid: torch.Tensor, numa_policy: torch.Tensor,
                          strategy: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pair_ok bool[P, N], pair_score f32[P, N]): the zone prefilter of
    the NUMA-bound pods AND the policy nodes' combined fit, and the zone
    score of the NUMA-bound pods (0 elsewhere), by the plain [P, N]
    functions of `scheduler/plugins/numaaware.py`."""
    req2 = demand * numa_single[:, None]
    ok = (numaaware.zone_prefilter_terms(req2, numa_single, numa_free,
                                         numa_valid)
          & numaaware.policy_fit_terms(demand, numa_free, numa_valid,
                                       numa_policy))
    score = numaaware.numa_score_terms(req2, numa_single, numa_cap,
                                       numa_free, numa_valid, strategy)
    return ok, score


def numa_pair_terms(demand: torch.Tensor, numa_single: torch.Tensor,
                    numa_cap: torch.Tensor, numa_free: torch.Tensor,
                    numa_valid: torch.Tensor, numa_policy: torch.Tensor,
                    strategy: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pair terms of `numa_pair_terms_plain`: the kernel for CUDA
    tensors, the plain version for CPU tensors. demand f32[P, 2] (every
    pod's cpu and memory request); numa_single bool[P]; numa_cap,
    numa_free f32[N, Z, 2]; numa_valid bool[N, Z]; numa_policy i32[N];
    strategy "most" or "least". Takes Z <= 4; P and N unlimited."""
    p = demand.shape[0]
    n, z, _ = numa_cap.shape
    dev = demand.device
    for name, t, dt, shape in (
            ("demand", demand, torch.float32, (p, 2)),
            ("numa_single", numa_single, torch.bool, (p,)),
            ("numa_cap", numa_cap, torch.float32, (n, z, 2)),
            ("numa_free", numa_free, torch.float32, (n, z, 2)),
            ("numa_valid", numa_valid, torch.bool, (n, z)),
            ("numa_policy", numa_policy, torch.int32, (n,))):
        _launch.check_tensor(name, t, dt, shape, dev)
    if strategy not in STRATEGIES:
        raise ValueError(f"numa_pair_terms: strategy {strategy!r}")
    if dev.type == "cpu":
        return numa_pair_terms_plain(demand, numa_single, numa_cap,
                                     numa_free, numa_valid, numa_policy,
                                     strategy)
    if dev.type != "cuda":
        raise ValueError(f"numa_pair_terms: unsupported device {dev}")
    if z > MAX_ZONES:
        raise ValueError(f"numa_pair_terms: Z={z} above {MAX_ZONES}")
    ok = torch.empty((p, n), dtype=torch.bool, device=dev)
    score = torch.empty((p, n), dtype=torch.float32, device=dev)
    tensors = (demand, numa_single, numa_cap, numa_free, numa_valid,
               numa_policy, ok, score)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    fn = TOOLCHAIN.function("numa_terms", "koord_numa_pair_terms",
                            [ctypes.c_void_p] + [ctypes.c_int] * 4
                            + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(ptrs, p, n, z, STRATEGIES.index(strategy), EPS,
            _launch.stream(dev))
    check(rc, "numa_pair_terms")
    numa_pair_terms.launches += 1
    return ok, score


numa_pair_terms.launches = 0
