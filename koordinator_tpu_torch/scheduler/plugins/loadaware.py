"""LoadAwareScheduling filter and score in plain PyTorch.

Counterpart of `koordinator_tpu/scheduler/plugins/loadaware.py`
(plugins/loadaware/load_aware.go): a node is filtered out when its
usage percentage meets a threshold, and scored by weighted
least-requested on estimated usage, with Go's integer-division floors
reproduced in float32. The round's score is fused into kernel K1
(`kernels/score_topk.py`); `score_matrix` here is the plain [P, N] form
that K1's plain version shares.

Rounding follows the reference's compiled program, which contracts a
multiply followed by an add into one fused multiply-add: `fma_f32`
computes a*b+c with one rounding (exact in float64 first, for the
operands these formulas see: an integer of at most 10 bits, or a
quotient, times a float32, plus a float32 of similar magnitude).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.api.extension import (
    NUM_RESOURCES,
    PriorityClass,
    ResourceKind,
)
from koordinator_tpu_torch.scheduler.batching import MAX_NODE_SCORE
from koordinator_tpu_torch.snapshot.schema import (
    AGG_TYPES,
    NodeState,
    PodBatch,
    Struct,
)


@dataclasses.dataclass
class LoadAwareConfig(Struct):
    """LoadAwareSchedulingArgs. Vectors are indexed by ResourceKind and
    0 disables a resource; the aggregation rows and the prod-usage switch
    are host values (the reference keeps them as device scalars)."""

    resource_weights: torch.Tensor       # f32[R]
    usage_thresholds: torch.Tensor       # f32[R] percent
    prod_usage_thresholds: torch.Tensor  # f32[R] percent, all 0 = off
    agg_usage_thresholds: torch.Tensor   # f32[R] percent
    filter_agg_idx: int = -1             # row of AGG_TYPES, -1 = instant
    score_agg_idx: int = -1
    score_according_prod_usage: bool = False

    @staticmethod
    def make(resource_weights: Optional[Mapping[ResourceKind, float]] = None,
             usage_thresholds: Optional[Mapping[ResourceKind, float]] = None,
             prod_usage_thresholds: Optional[Mapping[ResourceKind, float]] = None,
             agg_usage_thresholds: Optional[Mapping[ResourceKind, float]] = None,
             filter_agg_type: str = "",
             score_agg_type: str = "",
             score_according_prod_usage: bool = False,
             device="cuda") -> "LoadAwareConfig":
        dev = resolve_device(device)

        def vec(m, default):
            out = np.zeros((NUM_RESOURCES,), np.float32)
            for k, v in (default if m is None else m).items():
                out[int(k)] = v
            return torch.from_numpy(out).to(dev)

        return LoadAwareConfig(
            resource_weights=vec(resource_weights, {ResourceKind.CPU: 1.0,
                                                    ResourceKind.MEMORY: 1.0}),
            usage_thresholds=vec(usage_thresholds, {ResourceKind.CPU: 65.0,
                                                    ResourceKind.MEMORY: 95.0}),
            prod_usage_thresholds=vec(prod_usage_thresholds, {}),
            agg_usage_thresholds=vec(agg_usage_thresholds, {}),
            filter_agg_idx=AGG_TYPES.index(filter_agg_type)
            if filter_agg_type else -1,
            score_agg_idx=AGG_TYPES.index(score_agg_type)
            if score_agg_type else -1,
            score_according_prod_usage=bool(score_according_prod_usage))


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a*b + c rounded once, as a fused multiply-add."""
    b = b.double() if isinstance(b, torch.Tensor) else float(b)
    c = c.double() if isinstance(c, torch.Tensor) else float(c)
    return (a.double() * b + c).float()


def _usage_percent(used: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """math.Round(used/total*100) (half away from zero; values >= 0),
    0 where total == 0."""
    q = used / torch.clamp_min(total, 1e-9)
    return torch.where(total > 0, torch.floor(fma_f32(q, 100.0, 0.5)), 0.0)


def filter_mask(nodes: NodeState, pods: PodBatch,
                cfg: LoadAwareConfig) -> torch.Tensor:
    """bool[P, N]: True = node passes the LoadAware filter for the pod
    (load_aware.go:123-254). Nodes without fresh metrics pass, and so do
    DaemonSet pods."""
    alloc = nodes.allocatable
    if cfg.filter_agg_idx >= 0:
        used = torch.where(nodes.has_agg[:, None],
                           nodes.agg_usage[:, cfg.filter_agg_idx], 0.0)
        thresholds = cfg.agg_usage_thresholds
    else:
        used = nodes.usage
        thresholds = cfg.usage_thresholds
    pct = _usage_percent(used, alloc)
    over = (thresholds[None, :] > 0) & (alloc > 0) & (pct >= thresholds[None, :])
    node_ok = ~torch.any(over, dim=-1)

    prod_thr = cfg.prod_usage_thresholds
    prod_pct = _usage_percent(nodes.prod_usage, alloc)
    prod_over = (prod_thr[None, :] > 0) & (alloc > 0) & (prod_pct >= prod_thr[None, :])
    prod_node_ok = ~torch.any(prod_over, dim=-1)

    is_prod = pods.priority_class == int(PriorityClass.PROD)
    use_prod_gate = torch.any(prod_thr > 0) & is_prod
    ok = torch.where(use_prod_gate[:, None], prod_node_ok[None, :],
                     node_ok[None, :])
    return ok | ~nodes.metric_fresh[None, :] | pods.daemonset[:, None]


def score_terms(nodes: NodeState, cfg: LoadAwareConfig,
                score_dims: Optional[tuple] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """The per-node inputs of the score over the score dims D:
    (node_term f32[N, D], prod_term f32[N, D], alloc f32[N, D],
    weights f32[D]) (load_aware.go:269-335). node_term is the estimated
    usage of recently assigned pods plus the node usage source less
    their reported usage (guarded), prod_term the prod-tier variant."""
    dims = list(score_dims) if score_dims is not None else list(range(NUM_RESOURCES))

    def cols(x):
        return x[..., dims].contiguous()

    if cfg.score_agg_idx >= 0:
        usage_src = torch.where(nodes.has_agg[:, None],
                                cols(nodes.agg_usage[:, cfg.score_agg_idx]), 0.0)
    else:
        usage_src = cols(nodes.usage)
    corr = cols(nodes.assigned_correction)
    node_term = cols(nodes.assigned_estimated) + (
        usage_src - torch.where(usage_src >= corr, corr, 0.0))
    prod_term = cols(nodes.prod_assigned_estimated) + torch.clamp_min(
        cols(nodes.prod_usage) - cols(nodes.prod_assigned_correction), 0.0)
    return (node_term.contiguous(), prod_term.contiguous(),
            cols(nodes.allocatable), cols(cfg.resource_weights))


def prod_scored(pods: PodBatch, cfg: LoadAwareConfig) -> torch.Tensor:
    """bool[P]: the pod is scored on prod-tier usage."""
    is_prod = pods.priority_class == int(PriorityClass.PROD)
    return is_prod & bool(cfg.score_according_prod_usage)


def least_requested_score(est: torch.Tensor, is_prod_scored: torch.Tensor,
                          node_term: torch.Tensor, prod_term: torch.Tensor,
                          alloc: torch.Tensor, fresh: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """f32[P, N]: floor'd weighted least-requested (load_aware.go:378-397)
    of each pod's estimate est f32[P, D] on each node; 0 on nodes
    without a fresh NodeMetric."""
    base = torch.where(is_prod_scored[:, None, None], prod_term[None],
                       node_term[None])                          # [P, N, D]
    used = est[:, None, :] + base
    cap = alloc[None]
    least = torch.floor((cap - used) * MAX_NODE_SCORE
                        / torch.clamp_min(cap, 1e-9))
    least = torch.where((cap > 0) & (used <= cap), least, 0.0)
    acc = torch.zeros(least.shape[:2], dtype=torch.float32,
                      device=least.device)
    for d in range(least.shape[-1]):
        acc = fma_f32(least[..., d], weights[d], acc)
    weight_sum = torch.clamp_min(weights.sum(), 1e-9)
    score = torch.floor(acc / weight_sum)
    return torch.where(fresh[None, :], score, 0.0)


def score_matrix(nodes: NodeState, pods: PodBatch, cfg: LoadAwareConfig,
                 score_dims: Optional[tuple] = None) -> torch.Tensor:
    """f32[P, N] in [0, 100]: the LoadAware score of every pair."""
    node_term, prod_term, alloc, weights = score_terms(nodes, cfg, score_dims)
    dims = list(score_dims) if score_dims is not None else list(range(NUM_RESOURCES))
    return least_requested_score(
        pods.estimated[:, dims].contiguous(), prod_scored(pods, cfg),
        node_term, prod_term, alloc, nodes.metric_fresh, weights)
