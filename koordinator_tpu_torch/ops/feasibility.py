"""Batch-start feasibility: the cheap checks of stage 1 of the
Filter->Score gate cascade.

Counterpart of `koordinator_tpu/ops/feasibility.py`: the resource fit
against each node's batch-start headroom (noderesources.Fit) and the
elastic-quota ceiling of each pod's ancestor chain (ElasticQuota
PreFilter). Both read only batch-start state, which only grows within a
batch (node `requested`, quota `used`), so a pair that fails here fails
in every commit round (`scheduler/cascade.py` stage1_mask). Plain
torch; kernel K9 (`kernels/stage1.py`) computes the same on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.snapshot.schema import (
    MAX_QUOTA_DEPTH,
    PodBatch,
    QuotaState,
)


def _dims(x: torch.Tensor, fit_dims: Optional[tuple]) -> torch.Tensor:
    """x restricted to the checked resource dims (None = all), the rule
    of core.schedule_batch's fit_dims."""
    return x if fit_dims is None else x[..., list(fit_dims)]


def resource_fit(allocatable: torch.Tensor, requested: torch.Tensor,
                 requests: torch.Tensor,
                 fit_dims: Optional[tuple] = None) -> torch.Tensor:
    """bool[P, N]: fl(request + requested) <= fl(allocatable + EPS) on
    every checked dim: the first commit round's fit, exactly."""
    return torch.all(
        _dims(requests, fit_dims)[:, None, :]
        + _dims(requested, fit_dims)[None]
        <= _dims(allocatable, fit_dims)[None] + EPS, dim=-1)


def pod_ancestors(quotas: QuotaState, pods: PodBatch) -> torch.Tensor:
    """i32[P, D]: each pod's quota-tree ancestor per depth, -1 = none (a
    quota-less pod gets an all -1 row; a quota id beyond the table reads
    its last row, as the reference's gather clamps)."""
    last = max(quotas.depth_ancestor.shape[0] - 1, 0)
    return torch.where(
        pods.quota_id[:, None] >= 0,
        quotas.depth_ancestor[pods.quota_id.clamp(0, last).long()],
        -1).to(torch.int32)


def quota_ceiling_terms(pod_anc: torch.Tensor, used: torch.Tensor,
                        runtime: torch.Tensor, requests: torch.Tensor,
                        quota_depth: int, eps: float = EPS) -> torch.Tensor:
    """bool[P]: fl(used + request) <= fl(runtime + eps) on every column
    at each of the first quota_depth levels of the pod's chain (a level
    without an ancestor passes); `used`, `runtime` and `requests` are
    already restricted to the checked dims."""
    ok = torch.ones((pod_anc.shape[0],), dtype=torch.bool,
                    device=pod_anc.device)
    for d in range(quota_depth):
        anc = pod_anc[:, d]
        a = anc.clamp_min(0).long()
        level_ok = torch.all(used[a] + requests <= runtime[a] + eps, dim=-1)
        ok = ok & ((anc < 0) | level_ok)
    return ok


def quota_ceiling_ok(quotas: QuotaState, pods: PodBatch,
                     quota_depth: int = MAX_QUOTA_DEPTH,
                     fit_dims: Optional[tuple] = None) -> torch.Tensor:
    """bool[P]: batch-start elastic-quota admission, used + request <=
    runtime at every level of the pod's chain. A False row kills the
    pod's whole node row in the cascade mask."""
    return quota_ceiling_terms(
        pod_ancestors(quotas, pods), _dims(quotas.used, fit_dims),
        _dims(quotas.runtime, fit_dims), _dims(pods.requests, fit_dims),
        quota_depth)
