"""Priority ranking and the segment prefix gate of the batched commit.

Counterpart of `koordinator_tpu/scheduler/batching.py`. The prefix gate
is kernel K2 (`kernels/segment_prefix.py`); it takes each pod's `rank`
rather than the reference's [P, P] `earlier` matrix.
"""

from __future__ import annotations

import torch

# K2; re-exported as this module's segment_prefix_ok
from koordinator_tpu_torch.kernels.segment_prefix import (  # noqa: F401
    segment_prefix_ok,
)

EPS = 0.5  # comparison tolerance in canonical units (millicores / MiB)
MAX_NODE_SCORE = 100.0  # framework.MaxNodeScore


def stable_rank(key: torch.Tensor) -> torch.Tensor:
    """i32[P]: each element's position in the stable ascending sort of
    `key` (ties keep index order)."""
    order = torch.sort(key, stable=True).indices
    rank = torch.empty_like(order, dtype=torch.int32)
    rank[order] = torch.arange(key.shape[0], dtype=torch.int32,
                               device=key.device)
    return rank


def rank_by_priority(pods) -> torch.Tensor:
    """i32[P]: position in scheduling order — priority desc, index asc."""
    return stable_rank(-pods.priority)
