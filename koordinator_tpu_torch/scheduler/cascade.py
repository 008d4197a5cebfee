"""The round-invariant node gates of a batch (stage 1's static part).

Counterpart of `koordinator_tpu/scheduler/cascade.py` static_gates:
nodeSelector, the LoadAware filter, `schedulable` and the taint
forbids/penalty, as one bool[P, N] mask. `static_gate_terms` gives the
same gates, with the device prefilter's per-pod part, in factored form:
a few values per pod, a few per node and the selector table, which
kernel K1 combines pair by pair, so the slim path never builds the
[P, N] mask (`expand_gates` builds it for K1's plain version). The
cascade's stage-1 fit and quota-ceiling mask (`stage1_mask`) is not
ported: the slim path runs with the cascade off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from koordinator_tpu_torch.scheduler.batching import MAX_NODE_SCORE
from koordinator_tpu_torch.scheduler.plugins import deviceshare, loadaware
from koordinator_tpu_torch.snapshot.schema import (
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
        tol = pods.toleration_id.clamp_min(0).long()
        taint = nodes.taint_group.long()
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
    label_group[n]]), and the LoadAware filter passes (daemonset[p], or
    not metric_fresh[n], or prod_node_ok[n] if prod_gate[p] else
    node_ok[n])."""

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


def static_gate_terms(nodes: NodeState, pods: PodBatch,
                      cfg: loadaware.LoadAwareConfig,
                      devices: Optional[DeviceState]) -> GateTerms:
    """The gates of `static_gates(...)[0] & deviceshare.prefilter(...)`
    as `GateTerms`; `devices` None leaves the device prefilter out (every
    pod passes it). On a snapshot with GPU instances the GPU part of the
    prefilter is pairwise and left to kernel K6 (`device_pair_terms`);
    `device_ok` keeps its aux part (no aux pool: a pod asking for an aux
    resource passes nowhere). Raises NotImplementedError where a gate
    does not factor: taints (the taint penalty belongs to the full-gate
    form) and aux pools."""
    if pods.has_taints:
        raise NotImplementedError(
            "the taint gate and score penalty (pods.has_taints) are not "
            "ported yet (ROADMAP queue A item 6)")
    if devices is None:
        device_ok = torch.ones_like(pods.valid)
    elif devices.gpu_free.shape[1]:
        device_ok = deviceshare.no_aux_term(devices, pods)
    else:
        device_ok = deviceshare.zero_instance_term(devices, pods)
    node_ok, prod_node_ok = loadaware.filter_terms(nodes, cfg)
    return GateTerms(
        selector_id=pods.selector_id, prod_gate=loadaware.prod_gate(pods, cfg),
        daemonset=pods.daemonset, device_ok=device_ok,
        label_group=nodes.label_group, node_ok=node_ok,
        prod_node_ok=prod_node_ok, metric_fresh=nodes.metric_fresh,
        schedulable=nodes.schedulable, selector_match=pods.selector_match)


def _table_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """idx as the reference indexes a table of `size` rows: a negative
    index counts from the end, and one out of range is clamped to it."""
    idx = idx.long()
    return torch.where(idx < 0, idx + size, idx).clamp(0, max(size - 1, 0))


def expand_gates(g: GateTerms) -> torch.Tensor:
    """bool[P, N]: the pair gates that `g` factors. Selector ids and
    label groups index the selector table by the reference's rule
    (`_table_index`); a negative selector id matches all."""
    s, labels = g.selector_match.shape
    sel = _table_index(g.selector_id.clamp_min(0), s)
    sel_ok = (g.selector_id[:, None] < 0) | \
        g.selector_match[sel][:, _table_index(g.label_group, labels)]
    la_ok = torch.where(g.prod_gate[:, None], g.prod_node_ok[None, :],
                        g.node_ok[None, :])
    la_ok = la_ok | ~g.metric_fresh[None, :] | g.daemonset[:, None]
    return (sel_ok & la_ok & g.schedulable[None, :]
            & g.device_ok[:, None])
