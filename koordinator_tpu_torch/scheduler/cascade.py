"""The round-invariant node gates of a batch (stage 1's static part).

Counterpart of `koordinator_tpu/scheduler/cascade.py` static_gates:
nodeSelector, the LoadAware filter, `schedulable` and the taint
forbids/penalty, as one bool[P, N] mask. The cascade's stage-1 fit and
quota-ceiling mask (`stage1_mask`) is not ported: the slim path runs
with the cascade off.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from koordinator_tpu_torch.scheduler.batching import MAX_NODE_SCORE
from koordinator_tpu_torch.scheduler.plugins import loadaware
from koordinator_tpu_torch.snapshot.schema import NodeState, PodBatch


def static_gates(nodes: NodeState, pods: PodBatch,
                 cfg: loadaware.LoadAwareConfig
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(static_ok bool[P, N], taint_penalty f32[P, N] or None)."""
    sel = pods.selector_id.clamp_min(0).long()
    label = nodes.label_group.long()
    sel_ok = (pods.selector_id[:, None] < 0) | \
        pods.selector_match[sel][:, label]
    la_ok = loadaware.filter_mask(nodes, pods, cfg)
    static_ok = la_ok & sel_ok & nodes.schedulable[None, :]
    taint_penalty = None
    if pods.has_taints:
        tol = pods.toleration_id.clamp_min(0).long()
        taint = nodes.taint_group.long()
        static_ok = static_ok & ~pods.tol_forbid[tol][:, taint]
        prefer_cnt = pods.tol_prefer[tol][:, taint]
        taint_penalty = prefer_cnt / torch.clamp_min(
            torch.max(pods.tol_prefer), 1.0) * MAX_NODE_SCORE
    return static_ok, taint_penalty
