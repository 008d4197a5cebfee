"""Device health guards: the defect scans of the node columns and of a
pod batch, a packed health word, quarantine, and the guarded batch.

Counterpart of `koordinator_tpu/scheduler/guards.py`. A resident
service will see a NaN metric column, a negative allocatable or an
out-of-range domain index, and one poisoned row can corrupt every
placement of a batch; so the batch scans its own inputs first:

- `snapshot_health(snap)`: non-finite metric values, invalid
  allocatable or requested, requested > allocatable + 1 on a dim, and
  inconsistent NUMA pools on a valid zone (kernel K14 `guard_nodes`);
- `batch_health(snap, pods)`: non-finite or negative requests,
  estimates or GPU ratio, gang, quota, selector or toleration ids out of
  range, and domain maps holding entries outside [-1, D) (kernel K15
  `guard_pods`, two launches: the bad groups, then the pod rows);
- `apply_quarantine`: bad nodes unschedulable with their float rows
  scrubbed (NaN and +-inf to 0, negatives to 0, requested within
  allocatable, numa_free within cap), bad pods invalid with their rows
  scrubbed, and a bad domain group's row set to -1 (its carriers are
  bad pods, so no clean pod is gated by it).

`guarded_schedule_batch` runs K14 and K15, then `core.schedule_batch`
on the quarantined snapshot and batch, with no host readback; the
caller reads `health` once, later. `health` is i32[3] = [word, bad
nodes, bad pods]: the reference's u32[3] held as int32 (torch's uint32
supports few operations; the word uses bits 0-11, the counts fit).
On healthy inputs every scrubbed row is a copy, so the placements are
the unguarded program's.

Word layout (bit set = the defect class is present somewhere):
  bit 0  NODE_METRIC_NONFINITE   NaN/Inf in a metric-derived column
  bit 1  NODE_BAD_ALLOCATABLE    negative/non-finite allocatable
  bit 2  NODE_BAD_REQUESTED      negative/non-finite requested
  bit 3  NODE_OVERCOMMIT         requested > allocatable + tol
  bit 4  NODE_NUMA_INVALID       numa_free < 0 / > cap / non-finite
  bit 8  POD_NONFINITE           NaN/Inf in requests/estimated
  bit 9  POD_NEGATIVE            negative requests/estimated
  bit 10 POD_ID_RANGE            gang/quota/selector/toleration id OOB
  bit 11 POD_DOMAIN_RANGE        domain-matrix entry outside [-1, D)
"""

from __future__ import annotations

from typing import Tuple

import torch

from koordinator_tpu_torch.kernels.guard import (
    NODE_BAD_ALLOCATABLE,
    NODE_BAD_REQUESTED,
    NODE_METRIC_NONFINITE,
    NODE_NUMA_INVALID,
    NODE_OVERCOMMIT,
    OVERCOMMIT_TOL,
    POD_DOMAIN_RANGE,
    POD_ID_RANGE,
    POD_NEGATIVE,
    POD_NONFINITE,
    guard_nodes,
    guard_pods,
)
from koordinator_tpu_torch.scheduler import core
from koordinator_tpu_torch.scheduler.plugins import loadaware
from koordinator_tpu_torch.snapshot.schema import (
    MAX_QUOTA_DEPTH,
    ClusterSnapshot,
    PodBatch,
)

HEALTH_OK = 0

# bit -> stable defect name (metric labels, chaos assertions, logs)
DEFECT_NAMES = {
    NODE_METRIC_NONFINITE: "node_metric_nonfinite",
    NODE_BAD_ALLOCATABLE: "node_bad_allocatable",
    NODE_BAD_REQUESTED: "node_bad_requested",
    NODE_OVERCOMMIT: "node_overcommit",
    NODE_NUMA_INVALID: "node_numa_invalid",
    POD_NONFINITE: "pod_nonfinite",
    POD_NEGATIVE: "pod_negative",
    POD_ID_RANGE: "pod_id_range",
    POD_DOMAIN_RANGE: "pod_domain_range",
}


def decode_health_word(word: int) -> Tuple[str, ...]:
    """Host-side: the defect-class names set in a packed health word."""
    return tuple(name for bit, name in sorted(DEFECT_NAMES.items())
                 if int(word) & bit)


def _table_sizes(snap: ClusterSnapshot) -> Tuple[int, int]:
    return snap.gangs.min_member.shape[0], snap.quotas.parent.shape[0]


def snapshot_health(snap: ClusterSnapshot
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(word i32[], node_bad bool[N]) of the node scan (K14)."""
    _, node_bad, health = guard_nodes(snap.nodes)
    return health[0], node_bad


def batch_health(snap: ClusterSnapshot, pods: PodBatch
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(word i32[], pod_bad bool[P]) of the batch scan (K15); ids are
    checked against the snapshot's gang and quota tables and the batch's
    selector and toleration tables."""
    _, pod_bad, health = guard_pods(pods, *_table_sizes(snap))
    return health[0], pod_bad


def apply_quarantine(snap: ClusterSnapshot, pods: PodBatch,
                     node_bad: torch.Tensor, pod_bad: torch.Tensor
                     ) -> Tuple[ClusterSnapshot, PodBatch]:
    """The snapshot and batch with the masked rows neutralised: bad
    nodes unschedulable and scrubbed, bad pods invalid and scrubbed, bad
    domain groups set to -1 (K14 and K15 with the given masks). All-false
    masks give bit-equal copies."""
    nodes, _, _ = guard_nodes(snap.nodes, force=node_bad)
    q_pods, _, _ = guard_pods(pods, *_table_sizes(snap), force=pod_bad)
    return snap.replace(nodes=nodes), q_pods


def guarded_schedule_batch(snap: ClusterSnapshot, pods: PodBatch,
                           cfg: loadaware.LoadAwareConfig,
                           num_rounds: int = 4, k_choices: int = 8,
                           score_dims: tuple = None,
                           approx_topk: bool = False,
                           tie_break: bool = False,
                           enable_numa: bool = True,
                           numa_strategy: str = "most",
                           enable_devices: bool = True,
                           device_strategy: str = "least",
                           quota_depth: int = MAX_QUOTA_DEPTH,
                           fit_dims: tuple = None,
                           enable_amplification: bool = False,
                           topo_prefix: int = None,
                           dom_classes: tuple = None,
                           numa_prefix: int = None,
                           gpu_prefix: int = None,
                           cascade: bool = False):
    """The health guards, the quarantine and `core.schedule_batch` (same
    knobs, same placements on healthy inputs) with no host readback.
    Returns (result, health i32[3] = [word, bad nodes, bad pods],
    node_bad bool[N], pod_bad bool[P])."""
    health = torch.zeros(3, dtype=torch.int32,
                         device=snap.nodes.allocatable.device)
    g_nodes, node_bad, _ = guard_nodes(snap.nodes, health=health)
    g_pods, pod_bad, _ = guard_pods(pods, *_table_sizes(snap),
                                    health=health)
    result = core.schedule_batch(
        snap.replace(nodes=g_nodes), g_pods, cfg, num_rounds=num_rounds,
        k_choices=k_choices, score_dims=score_dims, approx_topk=approx_topk,
        tie_break=tie_break, enable_numa=enable_numa,
        numa_strategy=numa_strategy, enable_devices=enable_devices,
        device_strategy=device_strategy, quota_depth=quota_depth,
        fit_dims=fit_dims, enable_amplification=enable_amplification,
        topo_prefix=topo_prefix, dom_classes=dom_classes,
        numa_prefix=numa_prefix, gpu_prefix=gpu_prefix, cascade=cascade)
    return result, health, node_bad, pod_bad
