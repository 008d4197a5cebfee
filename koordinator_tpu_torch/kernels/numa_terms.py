"""K4 numa_pair_terms: the batch-start NUMA gates and zone score of every
(pod, node) pair.

Kernel: `csrc/numa_terms.cu`. Replaces the NUMA part of the static
gates of koordinator_tpu/scheduler/core.py schedule_batch (:329-370):
plugins/numaaware.py:54 zone_prefilter and :70 numa_score_matrix over
[P, N, Z, 2], and the policy node's combined-fit prefilter. It writes
what the reference ANDs into its static mask and adds to its scores;
K1 reads both. Under the cascade's stage 2 (core.py:330-367) it runs on
the batch's first `rows` pods (the numa prefix) and ANDs them into the
first rows of the stage-1 mask; the rows beyond pass and score 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.scheduler.plugins import numaaware

MAX_ZONES = 8
STRATEGIES = ("most", "least")


def numa_pair_terms_plain(demand: torch.Tensor, numa_single: torch.Tensor,
                          numa_cap: torch.Tensor, numa_free: torch.Tensor,
                          numa_valid: torch.Tensor, numa_policy: torch.Tensor,
                          strategy: str, pair_ok: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pair_ok, pair_score f32[rows, N]) of the first `rows` pods (the
    rows of `demand`): the zone prefilter of the NUMA-bound pods AND the
    policy nodes' combined fit (bool[rows, N], or a given pair_ok
    bool[P, N] with its first rows ANDed), and the zone score of the
    NUMA-bound pods (0 elsewhere), by the plain [P, N] functions of
    `scheduler/plugins/numaaware.py`."""
    req2 = demand * numa_single[:, None]
    ok = (numaaware.zone_prefilter_terms(req2, numa_single, numa_free,
                                         numa_valid)
          & numaaware.policy_fit_terms(demand, numa_free, numa_valid,
                                       numa_policy))
    score = numaaware.numa_score_terms(req2, numa_single, numa_cap,
                                       numa_free, numa_valid, strategy)
    return _launch.and_rows(pair_ok, ok), score


def numa_pair_terms(demand: torch.Tensor, numa_single: torch.Tensor,
                    numa_cap: torch.Tensor, numa_free: torch.Tensor,
                    numa_valid: torch.Tensor, numa_policy: torch.Tensor,
                    strategy: str, pair_ok: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pair terms of `numa_pair_terms_plain`: the kernel for CUDA
    tensors, the plain version for CPU tensors. demand f32[rows, 2] (the
    cpu and memory requests of the batch's first rows pods);
    numa_single bool[rows]; numa_cap, numa_free f32[N, Z, 2];
    numa_valid bool[N, Z]; numa_policy i32[N]; strategy "most" or
    "least"; pair_ok bool[P, N] (P >= rows) or None. On the card a given
    pair_ok has its first rows ANDed in place and is returned. Takes
    Z <= 8; rows and N unlimited (rows = 0 launches nothing)."""
    rows = demand.shape[0]
    n, z, _ = numa_cap.shape
    dev = demand.device
    checks = [("demand", demand, torch.float32, (rows, 2)),
              ("numa_single", numa_single, torch.bool, (rows,)),
              ("numa_cap", numa_cap, torch.float32, (n, z, 2)),
              ("numa_free", numa_free, torch.float32, (n, z, 2)),
              ("numa_valid", numa_valid, torch.bool, (n, z)),
              ("numa_policy", numa_policy, torch.int32, (n,))]
    if pair_ok is not None:
        checks.append(("pair_ok", pair_ok, torch.bool, (None, n)))
        if pair_ok.shape[0] < rows:
            raise ValueError(f"numa_pair_terms: pair_ok has "
                             f"{pair_ok.shape[0]} rows, fewer than {rows}")
    for name, t, dt, shape in checks:
        _launch.check_tensor(name, t, dt, shape, dev)
    if strategy not in STRATEGIES:
        raise ValueError(f"numa_pair_terms: strategy {strategy!r}")
    if dev.type == "cpu":
        return numa_pair_terms_plain(demand, numa_single, numa_cap,
                                     numa_free, numa_valid, numa_policy,
                                     strategy, pair_ok)
    if dev.type != "cuda":
        raise ValueError(f"numa_pair_terms: unsupported device {dev}")
    if z > MAX_ZONES:
        raise ValueError(f"numa_pair_terms: Z={z} above {MAX_ZONES}")
    ok = (pair_ok if pair_ok is not None
          else torch.empty((rows, n), dtype=torch.bool, device=dev))
    score = torch.empty((rows, n), dtype=torch.float32, device=dev)
    if not (rows and n):
        return ok, score
    tensors = (demand, numa_single, numa_cap, numa_free, numa_valid,
               numa_policy, pair_ok, ok, score)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    fn = TOOLCHAIN.function("numa_terms", "koord_numa_pair_terms",
                            [ctypes.c_void_p] + [ctypes.c_int] * 4
                            + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(ptrs, rows, n, z, STRATEGIES.index(strategy), EPS,
            _launch.stream(dev))
    check(rc, "numa_pair_terms")
    numa_pair_terms.launches += 1
    return ok, score


numa_pair_terms.launches = 0
