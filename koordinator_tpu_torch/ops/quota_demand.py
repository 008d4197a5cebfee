"""Quota demand accounting: fold a pending pod batch into the quota
tree's DIRECT demand column before the water-fill.

Counterpart of `koordinator_tpu/ops/quota_demand.py`
(GroupQuotaManager.updatePodRequest: a pending pod's request charges its
own quota; the ancestors' share comes from `ops/waterfill.py`'s
propagation with its per-level clamp). The adds run on K3
(`kernels/scatter.py ordered_scatter_add`), in pod index order into each
quota row, as the reference's `.at[].add` adds on XLA:CPU.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch.kernels.scatter import ordered_scatter_add
from koordinator_tpu_torch.snapshot.schema import PodBatch, QuotaState


def add_pending_demand(quotas: QuotaState, pods: PodBatch) -> QuotaState:
    """`quotas` with each pod's `requests * valid` added into its quota's
    demand row; a quota-less pod (quota_id < 0) charges the drop row Q
    and is dropped, as is a quota id beyond the table."""
    q = quotas.min.shape[0]
    req = pods.requests * pods.valid[:, None]
    tgt = torch.where(pods.quota_id >= 0, pods.quota_id, q).to(torch.int32)
    return quotas.replace(demand=ordered_scatter_add(quotas.demand, tgt, req))
