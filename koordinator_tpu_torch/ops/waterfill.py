"""Hierarchical elastic-quota runtime: the fair-share water-fill of the
quota forest.

Counterpart of `koordinator_tpu/ops/waterfill.py`
(elasticquota/core/runtime_quota_calculator.go:111-168 applied level by
level, GroupQuotaManager semantics): `propagate_demand` walks the tree
bottom-up into each quota's limited demand, and `compute_runtime`
partitions each parent's runtime among its children top-down, in
rounds of `delta = floor(w * remaining / total_w + 0.5)` where only the
excess returned by children that reach their demand is re-partitioned.

The plain versions here keep XLA:CPU's semantics step by step: every
segment sum adds a parent's children in ascending row index, starting
from +0 (`_seg_sum`, the reference's `.at[].add`); `delta` rounds the
product, then divides (IEEE), then adds 0.5, then floors; max and min
are XLA's (`kernels/_xla.py`). The rounds' `while` loop runs while any
parent row of the level has remaining > 0.5 and adjusting weight, up to
`max_iters`, all sibling groups stepping together. `propagate_demand`
and `compute_runtime` run kernel K18 (`kernels/quota_runtime.py`) on a
card and the plain versions on the host.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from koordinator_tpu_torch.kernels._xla import xla_max, xla_min
from koordinator_tpu_torch.snapshot.schema import MAX_QUOTA_DEPTH, QuotaState


def children(parent: torch.Tensor, q: int) -> torch.Tensor:
    """int64[Q, F]: row p lists the rows whose parent is p in ascending
    row index, padded with q (the index of the zero row `_seg_sum`
    appends); F is the largest fan-out (at least 1). A parent outside
    [0, Q) names no row: such rows go to the reference's dump row."""
    seg = parent.long()
    rows = torch.nonzero((seg >= 0) & (seg < q)).flatten()
    segs = seg[rows]
    order = torch.sort(segs, stable=True).indices
    rows, segs = rows[order], segs[order]
    counts = torch.bincount(segs, minlength=q)
    f = max(int(counts.max()) if counts.numel() else 0, 1)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(rows.numel(), device=parent.device) - start[segs]
    kids = torch.full((q, f), q, dtype=torch.long, device=parent.device)
    kids[segs, rank] = rows
    return kids


def _seg_sum(values: torch.Tensor, kids: torch.Tensor) -> torch.Tensor:
    """f32[Q, R]: row p the sum of its children's rows of `values`, added
    one by one in ascending row index from +0 (the reference's
    `.at[seg].add` on XLA:CPU); a row without children is +0. The zero
    row that pads `kids` adds +0, which changes no sum (a sum from +0
    is never -0)."""
    ext = torch.cat([values, values.new_zeros((1, values.shape[1]))])
    acc = torch.zeros_like(values)
    for f in range(kids.shape[1]):
        acc = acc + ext[kids[:, f]]
    return acc


def quota_depth(quotas: QuotaState) -> torch.Tensor:
    """i64[Q]: each quota's depth, the count of its chain's ancestors
    less one (-1 for a row with none)."""
    return (quotas.depth_ancestor >= 0).sum(dim=-1) - 1


def _clamp(quotas: QuotaState, subtree: torch.Tensor) -> torch.Tensor:
    """min(max, allow_lent ? s : max(s, min)) (getLimitRequestNoLock)."""
    floored = torch.where(quotas.allow_lent[:, None], subtree,
                          xla_max(subtree, quotas.min))
    return xla_min(floored, quotas.max)


def propagate_demand_plain(quotas: QuotaState,
                           kids: torch.Tensor = None) -> torch.Tensor:
    """f32[Q, R]: each quota's limited demand from its own (DIRECT)
    demand, bottom-up: at each depth 5 .. 1 the level's clamped subtree
    demand is segment-summed into its parents, then every row adds its
    sum; the result clamped once more."""
    kids = children(quotas.parent, quotas.min.shape[0]) if kids is None \
        else kids
    depth = quota_depth(quotas)
    subtree = quotas.demand
    for d in range(MAX_QUOTA_DEPTH - 1, 0, -1):
        at_d = (depth == d)[:, None]
        subtree = subtree + _seg_sum(
            torch.where(at_d, _clamp(quotas, subtree), 0.0), kids)
    return _clamp(quotas, subtree)


def _redistribute_level(level_mask: torch.Tensor, parent: torch.Tensor,
                        parent_total: torch.Tensor, demand: torch.Tensor,
                        min_eff: torch.Tensor, weight: torch.Tensor,
                        allow_lent: torch.Tensor, kids: torch.Tensor,
                        max_iters: int) -> Tuple[torch.Tensor, int]:
    """(runtime f32[Q, R], rounds): the runtime of one level's quotas
    (0 on other rows) and the rounds its loop ran; the reference's
    `_redistribute_level`, every sibling group and column at once."""
    q = demand.shape[0]
    m = level_mask[:, None]
    adjusting = m & (demand > min_eff)
    runtime = torch.where(
        adjusting, min_eff,
        torch.where(allow_lent[:, None], xla_min(demand, min_eff), min_eff))
    runtime = torch.where(m, runtime, 0.0)
    remaining = xla_max(parent_total - _seg_sum(runtime, kids), 0.0)
    # jnp.take of a row beyond the table fills NaN
    pp = parent.long().clamp_min(0)
    inside = (pp < q)[:, None]
    pp = pp.clamp_max(q - 1)

    def take(x):
        return torch.where(inside, x[pp], float("nan"))

    it = 0
    while True:
        w = torch.where(adjusting, weight, 0.0)
        total_w = _seg_sum(w, kids)
        group_live = (remaining > 0.5) & (total_w > 0)
        if not (it < max_iters and bool(group_live.any())):
            break
        tw, rem = take(total_w), take(remaining)
        live = adjusting & (tw > 0) & (rem > 0.5)
        delta = torch.where(live, torch.floor(w * rem / xla_max(tw, 1e-9)
                                              + 0.5), 0.0)
        new_runtime = runtime + delta
        over = live & (new_runtime >= demand)
        excess = torch.where(over, new_runtime - demand, 0.0)
        runtime = torch.where(over, demand, new_runtime)
        remaining = torch.where(group_live, _seg_sum(excess, kids),
                                remaining)
        adjusting = adjusting & ~over
        it += 1
    return torch.where(m, runtime, 0.0), it


def shared_weights(quotas: QuotaState) -> torch.Tensor:
    """f32[Q, R]: sharedWeight where set (> 0), else max; 1 where that is
    not finite (quota_info.go)."""
    weight = torch.where(quotas.shared_weight > 0, quotas.shared_weight,
                         quotas.max)
    return torch.where(torch.isfinite(weight), weight, 1.0)


def compute_runtime_plain(quotas: QuotaState, cluster_total: torch.Tensor,
                          max_iters: int = 64
                          ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """(runtime f32[Q, R], limited demand f32[Q, R], rounds a level):
    the roots get min(max, cluster_total); each lower level partitions
    its parents' runtime (`_redistribute_level`); then min(runtime, max),
    and +inf on invalid rows."""
    kids = children(quotas.parent, quotas.min.shape[0])
    demand = propagate_demand_plain(quotas, kids)
    weight = shared_weights(quotas)
    depth = quota_depth(quotas)
    runtime = torch.zeros_like(quotas.min)
    rounds = [0]
    for d in range(MAX_QUOTA_DEPTH):
        level = quotas.valid & (depth == d)
        if d == 0:
            rt = xla_min(quotas.max, cluster_total[None, :])
        else:
            rt, n = _redistribute_level(level, quotas.parent, runtime,
                                        demand, quotas.min, weight,
                                        quotas.allow_lent, kids, max_iters)
            rounds.append(n)
        runtime = torch.where(level[:, None], rt, runtime)
    runtime = xla_min(runtime, quotas.max)
    return (torch.where(quotas.valid[:, None], runtime, float("inf")),
            demand, rounds)


def propagate_demand(quotas: QuotaState) -> torch.Tensor:
    """f32[Q, R]: the limited demand of `propagate_demand_plain`; on a
    card one K18 launch stopped after the demand."""
    from koordinator_tpu_torch.kernels.quota_runtime import quota_runtime
    return quota_runtime(quotas, None, demand_only=True).limited


def compute_runtime(quotas: QuotaState, cluster_total: torch.Tensor,
                    max_iters: int = 64) -> torch.Tensor:
    """f32[Q, R]: the runtime of `compute_runtime_plain`; on a card one
    K18 launch solves the whole forest."""
    from koordinator_tpu_torch.kernels.quota_runtime import quota_runtime
    return quota_runtime(quotas, cluster_total, max_iters).runtime
