"""The round-invariant node gates of a batch (stage 1's static part).

Counterpart of `koordinator_tpu/scheduler/cascade.py` static_gates:
nodeSelector, the LoadAware filter, `schedulable` and the taint
forbids/penalty, as one bool[P, N] mask. `static_gate_terms` gives the
same gates, with the device prefilter's per-pod part, in factored form:
a few values per pod, a few per node, the selector table and, for a
batch with tolerations, the forbid and penalty tables over (toleration
set, taint group), which kernel K1 combines pair by pair, so no path
builds the [P, N] mask (`expand_gates` and `taint_penalty` build the
[P, N] forms for K1's plain version; `expand_gates` also evaluates the
gates at a few given nodes, the reservation slots' hosts).

`stage1_mask` is the cascade's stage-1 candidate mask (cascade.py:117):
the static gates AND the batch-start fit AND the quota ceiling, as one
bool[P, N] from kernel K9 (`kernels/stage1.py`); `candidate_counts`
(:145) counts each pod's surviving nodes. Within a batch node
`requested` and quota `used` only grow, so a pair the mask drops fails
every commit round: `schedule_batch(cascade=True)` places exactly as
with the cascade off. The mask is never applied to the reservation
slot columns (a consumer draws from the slot's own hold).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from koordinator_tpu_torch.scheduler.batching import EPS, MAX_NODE_SCORE
from koordinator_tpu_torch.scheduler.plugins import deviceshare, loadaware
from koordinator_tpu_torch.snapshot.schema import (
    MAX_QUOTA_DEPTH,
    ClusterSnapshot,
    DeviceState,
    NodeState,
    PodBatch,
    Struct,
)


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
        t, groups = pods.tol_forbid.shape
        tol = _table_index(pods.toleration_id.clamp_min(0), t)
        taint = _table_index(nodes.taint_group, groups)
        static_ok = static_ok & ~pods.tol_forbid[tol][:, taint]
        prefer_cnt = pods.tol_prefer[tol][:, taint]
        taint_penalty = prefer_cnt / torch.clamp_min(
            torch.max(pods.tol_prefer), 1.0) * MAX_NODE_SCORE
    return static_ok, taint_penalty


@dataclasses.dataclass
class GateTerms(Struct):
    """The static gates of a batch in factored form. A pair (p, n)
    passes when device_ok[p] and schedulable[n], the selector matches
    (selector_id[p] < 0 or selector_match[selector_id[p],
    label_group[n]]), the LoadAware filter passes (daemonset[p], or
    not metric_fresh[n], or prod_node_ok[n] if prod_gate[p] else
    node_ok[n]), and, for a batch with tolerations, the taint does not
    forbid it (not tol_forbid[toleration_id[p], taint_group[n]]); such
    a pair's score loses tol_penalty[toleration_id[p], taint_group[n]],
    floored at 0. Table indices follow the reference's rule
    (`_table_index`; a negative toleration id reads row 0)."""

    selector_id: torch.Tensor     # i32[P], -1 = match all
    prod_gate: torch.Tensor       # bool[P] held to the prod-usage gate
    daemonset: torch.Tensor       # bool[P]
    device_ok: torch.Tensor       # bool[P] the device prefilter's row
    label_group: torch.Tensor     # i32[N]
    node_ok: torch.Tensor         # bool[N] under the usage thresholds
    prod_node_ok: torch.Tensor    # bool[N] under the prod thresholds
    metric_fresh: torch.Tensor    # bool[N]
    schedulable: torch.Tensor     # bool[N]
    selector_match: torch.Tensor  # bool[S, L]
    # the taint gate and penalty; None for a batch without tolerations
    toleration_id: Optional[torch.Tensor] = None  # i32[P]
    taint_group: Optional[torch.Tensor] = None    # i32[N]
    tol_forbid: Optional[torch.Tensor] = None     # bool[T, G]
    tol_penalty: Optional[torch.Tensor] = None    # f32[T, G]


def static_gate_terms(nodes: NodeState, pods: PodBatch,
                      cfg: loadaware.LoadAwareConfig,
                      devices: Optional[DeviceState]) -> GateTerms:
    """The gates of `static_gates(...)[0] & deviceshare.prefilter(...)`
    as `GateTerms`; `devices` None leaves the device prefilter out (every
    pod passes it). On a snapshot with GPU instances the GPU part of the
    prefilter is pairwise and left to kernel K6 (`device_pair_terms`);
    `device_ok` keeps its aux part (no aux pool: a pod asking for an aux
    resource passes nowhere). A batch with tolerations (`has_taints`)
    adds the forbid table and the penalty table
    `tol_prefer / max(max(tol_prefer), 1) * MAX_NODE_SCORE`, the
    reference's per-pair arithmetic (elementwise, in its order) done
    once a table entry."""
    taints = {}
    if pods.has_taints:
        taints = dict(
            toleration_id=pods.toleration_id, taint_group=nodes.taint_group,
            tol_forbid=pods.tol_forbid,
            tol_penalty=pods.tol_prefer / torch.clamp_min(
                torch.max(pods.tol_prefer), 1.0) * MAX_NODE_SCORE)
    device_ok = (torch.ones_like(pods.valid) if devices is None
                 else deviceshare.poolless_term(devices, pods))
    node_ok, prod_node_ok = loadaware.filter_terms(nodes, cfg)
    return GateTerms(
        selector_id=pods.selector_id, prod_gate=loadaware.prod_gate(pods, cfg),
        daemonset=pods.daemonset, device_ok=device_ok,
        label_group=nodes.label_group, node_ok=node_ok,
        prod_node_ok=prod_node_ok, metric_fresh=nodes.metric_fresh,
        schedulable=nodes.schedulable, selector_match=pods.selector_match,
        **taints)


def _table_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """idx as the reference indexes a table of `size` rows: a negative
    index counts from the end, and one out of range is clamped to it."""
    idx = idx.long()
    return torch.where(idx < 0, idx + size, idx).clamp(0, max(size - 1, 0))


def _taint_cells(g: GateTerms, cols):
    """(toleration row i64[P, 1], taint column i64[1, C]) of each pair,
    by the reference's index rule, for the nodes `cols` (all if None)."""
    t, groups = g.tol_forbid.shape
    taint = g.taint_group if cols is None else g.taint_group[cols]
    return (_table_index(g.toleration_id.clamp_min(0), t)[:, None],
            _table_index(taint, groups)[None, :])


def expand_gates(g: GateTerms, cols: Optional[torch.Tensor] = None,
                 device_term: bool = True) -> torch.Tensor:
    """bool[P, C]: the pair gates that `g` factors, at the nodes `cols`
    (i64[C]; all N nodes if None). Selector ids, label groups,
    toleration ids and taint groups index their tables by the
    reference's rule (`_table_index`); a negative selector id matches
    all. `device_term` False leaves the device prefilter's row out (the
    reservation slots' gates)."""
    def at(x):
        return x if cols is None else x[cols]

    s, labels = g.selector_match.shape
    sel = _table_index(g.selector_id.clamp_min(0), s)
    sel_ok = (g.selector_id[:, None] < 0) | \
        g.selector_match[sel][:, _table_index(at(g.label_group), labels)]
    la_ok = torch.where(g.prod_gate[:, None], at(g.prod_node_ok)[None, :],
                        at(g.node_ok)[None, :])
    la_ok = la_ok | ~at(g.metric_fresh)[None, :] | g.daemonset[:, None]
    ok = sel_ok & la_ok & at(g.schedulable)[None, :]
    if device_term:
        ok = ok & g.device_ok[:, None]
    if g.tol_forbid is not None:
        row, col = _taint_cells(g, cols)
        ok = ok & ~g.tol_forbid[row, col]
    return ok


def taint_penalty(g: GateTerms) -> Optional[torch.Tensor]:
    """f32[P, N]: each pair's taint score penalty, None for a batch
    without tolerations."""
    if g.tol_penalty is None:
        return None
    row, col = _taint_cells(g, None)
    return g.tol_penalty[row, col]


def stage1_mask(snap: ClusterSnapshot, pods: PodBatch, gates: GateTerms,
                fit_dims: Optional[tuple] = None,
                quota_depth: int = MAX_QUOTA_DEPTH) -> torch.Tensor:
    """bool[P, N]: the stage-1 candidate mask, the pairs that pass
    `gates` (`static_gate_terms` of the batch), fit the nodes'
    batch-start headroom on the checked dims (`fit_dims`, None = all)
    and whose pod passes its quota ceiling at the first quota_depth
    levels. Kernel K9 on the card, its plain version on the host."""
    # the kernel module reads GateTerms from this one
    from koordinator_tpu_torch.kernels import stage1
    from koordinator_tpu_torch.ops import feasibility

    def dims(x):
        return (x if fit_dims is None else x[..., list(fit_dims)]).contiguous()

    nodes, quotas = snap.nodes, snap.quotas
    return stage1.stage1_mask(
        gates, dims(pods.requests), dims(nodes.requested),
        dims(nodes.allocatable), feasibility.pod_ancestors(quotas, pods),
        dims(quotas.used), dims(quotas.runtime), quota_depth, EPS)


def candidate_counts(mask: torch.Tensor) -> torch.Tensor:
    """i32[P]: each pod's surviving candidate nodes in a stage-1 mask (a
    zero row is a pod stage 1 already proved unschedulable)."""
    return mask.sum(dim=1, dtype=torch.int32)
