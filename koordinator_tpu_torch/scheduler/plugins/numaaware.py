"""NodeNUMAResource: the batch-start zone fit and zone score, in plain
PyTorch.

Counterpart of `koordinator_tpu/scheduler/plugins/numaaware.py`
(pod_zone_requests, zone_prefilter, numa_score_matrix) and of the
policy node's combined-fit prefilter of schedule_batch
(`koordinator_tpu/scheduler/core.py:355-370`). Zone state lives as
[N, Z, 2] (cpu milli, memory MiB) columns. These [P, N] forms are the
plain version of kernel K4 (`kernels/numa_terms.py`); the scheduler
calls K4, whose plain version composes the `*_terms` forms.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.api.extension import (
    NUMA_POLICY_NONE,
    ResourceKind,
)
from koordinator_tpu_torch.scheduler.batching import EPS, MAX_NODE_SCORE
from koordinator_tpu_torch.snapshot.schema import NodeState, PodBatch

CPU = int(ResourceKind.CPU)
MEM = int(ResourceKind.MEMORY)


def zone_demand(pods: PodBatch) -> torch.Tensor:
    """f32[P, 2]: every pod's (cpu, memory) request, the demand it puts
    on a zone when a topology policy engages it."""
    return torch.stack([pods.requests[:, CPU], pods.requests[:, MEM]],
                       dim=-1).contiguous()


def pod_zone_requests(pods: PodBatch) -> torch.Tensor:
    """f32[P, 2]: the (cpu, memory) a NUMA-bound pod takes from its zone;
    zero rows for unbound pods."""
    return zone_demand(pods) * pods.numa_single[:, None]


def _zone_fits(req2, numa_free, numa_valid) -> torch.Tensor:
    """bool[P, N, Z]: the request fits the zone's free in both dims."""
    fits = torch.all(numa_free[None] + EPS >= req2[:, None, None, :], dim=-1)
    return fits & numa_valid[None]


def zone_prefilter_terms(req2, numa_single, numa_free,
                         numa_valid) -> torch.Tensor:
    """bool[P, N]: a NUMA-bound pod (request req2, zero rows elsewhere)
    fits some valid zone of the node whole; unbound pods pass."""
    ok = torch.any(_zone_fits(req2, numa_free, numa_valid), dim=-1)
    return ok | ~numa_single[:, None]


def zone_prefilter(nodes: NodeState, pods: PodBatch) -> torch.Tensor:
    """bool[P, N]: the single-NUMA upper-bound fit against the
    batch-start zone state (free only shrinks during a batch; the exact
    gate runs in the inner commit). Unbound pods pass everywhere."""
    return zone_prefilter_terms(pod_zone_requests(pods), pods.numa_single,
                                nodes.numa_free, nodes.numa_valid)


def numa_score_terms(req2, numa_single, numa_cap, numa_free, numa_valid,
                     strategy: str) -> torch.Tensor:
    """f32[P, N] in [0, 100]: the allocation score of the best zone the
    pod fits (scoring.go least/most allocated over the zone's cpu and
    memory after the pod), 0 for unbound pods."""
    fits = _zone_fits(req2, numa_free, numa_valid)
    used_after = (numa_cap - numa_free)[None] + req2[:, None, None, :]
    frac = used_after / torch.clamp_min(numa_cap, 1e-9)[None]
    if strategy != "most":
        frac = 1.0 - frac
    zone_score = (frac[..., 0] + frac[..., 1]) / 2.0
    zone_score = torch.where(fits, zone_score, -1.0)
    best = zone_score.max(dim=-1).values
    score = torch.clamp(best, 0.0, 1.0) * MAX_NODE_SCORE
    return torch.where(numa_single[:, None], score, 0.0)


def numa_score_matrix(nodes: NodeState, pods: PodBatch,
                      strategy: str = "most") -> torch.Tensor:
    """f32[P, N]: `numa_score_terms` of the batch against the node
    snapshot."""
    return numa_score_terms(pod_zone_requests(pods), pods.numa_single,
                            nodes.numa_cap, nodes.numa_free,
                            nodes.numa_valid, strategy)


def policy_fit_terms(demand, numa_free, numa_valid,
                     numa_policy) -> torch.Tensor:
    """bool[P, N]: a node with a topology policy admits only pods whose
    (cpu, memory) demand fits the total free of its valid zones; nodes
    without a policy pass."""
    total = torch.zeros_like(numa_free[:, 0])
    for z in range(numa_free.shape[1]):
        total = total + numa_free[:, z] * numa_valid[:, z, None]
    fits = torch.all(total[None] + EPS >= demand[:, None, :], dim=-1)
    return (numa_policy == NUMA_POLICY_NONE)[None] | fits
