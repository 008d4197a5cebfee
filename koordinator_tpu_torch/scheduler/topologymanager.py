"""Topology-manager hint merge: the four NUMA policies as batched mask
reductions, in plain PyTorch.

Counterpart of `koordinator_tpu/scheduler/topologymanager.py`
(frameworkext/topologymanager: policy none / best-effort / restricted /
single-numa-node). Every affinity candidate is one row of a fixed
[M, Z] mask table (M = 2^Z); a provider's hints are two bool [P, M]
tensors, `fit` (the request fits the mask's combined free) and `pref`
(the mask is minimal for the provider). These functions are the plain
version that kernel K5 (`kernels/topology.py`) is held against; the
scheduler's inner step calls K5. Two providers: the CPU+memory one
(`capacity_hints`) and DeviceShare's (`count_hints`, GPU instances per
zone), merged in that order.

Float note: the sums over zones run in zone order. The scheduler's
zone free and requests are integer-valued (milli-CPU, MiB), so every
partial sum is exact and the order cannot change a result.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.api.extension import (  # noqa: F401
    NUMA_POLICY_BEST_EFFORT as POLICY_BEST_EFFORT,
    NUMA_POLICY_NONE as POLICY_NONE,
    NUMA_POLICY_RESTRICTED as POLICY_RESTRICTED,
    NUMA_POLICY_SINGLE_NUMA_NODE as POLICY_SINGLE_NUMA_NODE,
)
from koordinator_tpu_torch.scheduler.batching import EPS

Hints = Tuple[torch.Tensor, torch.Tensor]


@functools.lru_cache(maxsize=None)
def mask_table(n_zones: int) -> Tuple[np.ndarray, np.ndarray]:
    """(masks bool[M, Z], popcount i32[M]) for M = 2^Z candidate
    affinities; row id == bitmask value, row 0 is the empty mask."""
    m = 1 << n_zones
    ids = np.arange(m, dtype=np.uint32)
    masks = (ids[:, None] >> np.arange(n_zones, dtype=np.uint32)) & 1
    masks = masks.astype(bool)
    return masks, masks.sum(axis=1).astype(np.int32)


def _table(n_zones: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    masks, popcnt = mask_table(n_zones)
    return (torch.from_numpy(masks).to(device),
            torch.from_numpy(popcnt).to(device))


def _mask_sums(x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """[P, M, ...]: the sum of x[:, z, ...] over each mask's zones, in
    zone order (the reference's einsum over the 0/1 mask table)."""
    mf = masks.to(x.dtype)                                   # [M, Z]
    shape = (1, mf.shape[0]) + (1,) * (x.dim() - 2)
    acc = torch.zeros((x.shape[0], mf.shape[0]) + tuple(x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    for z in range(x.shape[1]):
        acc = acc + x[:, z][:, None] * mf[:, z].reshape(shape)
    return acc


def capacity_hints(free_z: torch.Tensor, req: torch.Tensor,
                   valid: torch.Tensor) -> Hints:
    """The CPU+memory provider (NodeNUMAResource GetPodTopologyHints):
    free_z f32[P, Z, D], req f32[P, D], valid bool[P, Z] -> (fit, pref)
    bool[P, M]. A mask fits when it uses only valid zones and its
    combined free covers every dim; a pod with no request fits and
    prefers every mask."""
    z = free_z.shape[1]
    masks, popcnt = _table(z, free_z.device)
    avail = _mask_sums(free_z * valid[:, :, None], masks)     # [P, M, D]
    fit = torch.all(avail + EPS >= req[:, None, :], dim=-1)
    inside = ~torch.any(masks[None] & ~valid[:, None, :], dim=-1)
    fit = fit & inside & (popcnt > 0)[None]
    min_cnt = torch.where(fit, popcnt[None], z + 1).min(dim=-1).values
    pref = fit & (popcnt[None] == min_cnt[:, None])
    no_request = torch.all(req <= EPS, dim=-1)[:, None]
    return fit | no_request, pref | no_request


def count_hints(zone_counts: torch.Tensor, need: torch.Tensor) -> Hints:
    """The DeviceShare provider (deviceshare topology hints): zone_counts
    i32[P, Z] fitting instances per zone of the chosen node, need i32[P]
    instances -> (fit, pref) bool[P, M]. A mask fits when its zones hold
    `need` instances; pods with need <= 0 fit and prefer every mask."""
    z = zone_counts.shape[1]
    masks, popcnt = _table(z, zone_counts.device)
    have = torch.zeros((zone_counts.shape[0], masks.shape[0]),
                       dtype=torch.int32, device=zone_counts.device)
    for zz in range(z):
        have = have + zone_counts[:, zz, None] * masks[None, :, zz]
    fit = (have >= need[:, None]) & (popcnt > 0)[None]
    min_cnt = torch.where(fit, popcnt[None], z + 1).min(dim=-1).values
    pref = fit & (popcnt[None] == min_cnt[:, None])
    none = (need <= 0)[:, None]
    return fit | none, pref | none


def merge_hints(hints: List[Hints]) -> Hints:
    """AND across providers: affinity is the bitwise AND, preferred only
    when every provider prefers it."""
    fit, pref = hints[0]
    for f, p in hints[1:]:
        fit = fit & f
        pref = pref & p
    return fit, pref & fit


def resolve(fit: torch.Tensor, pref: torch.Tensor, policy: torch.Tensor,
            free_cpu_z: torch.Tensor, valid: torch.Tensor,
            strategy: str = "most"
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-pod policy outcome: (affinity bool[P, Z], admit bool[P],
    engaged bool[P]) from the merged hints, the effective policy code
    i32[P], the live free CPU per zone f32[P, Z] and valid bool[P, Z].
    Best-effort always admits; restricted needs a preferred hint and
    single-numa-node a preferred single-zone one, unless no mask fits at
    all (then the capacity gates reject). The affinity is the best
    hint's zones, or every valid zone for policy none or when nothing
    qualifies."""
    m = fit.shape[1]
    z = free_cpu_z.shape[1]
    masks, popcnt = _table(z, fit.device)
    single = (popcnt == 1)[None]
    cand = {POLICY_BEST_EFFORT: fit,
            POLICY_RESTRICTED: fit & pref,
            POLICY_SINGLE_NUMA_NODE: fit & pref & single}
    # the hint order, minimised: not preferred, then popcount, then the
    # allocation strategy over the mask's free CPU (most-allocated prefers
    # the least-free mask), then mask id (policy.go mergeFilteredHints)
    mask_free = _mask_sums(free_cpu_z, masks)                 # [P, M]
    denom = torch.clamp_min(mask_free.max(dim=-1, keepdim=True).values, 1.0)
    strat = mask_free / (denom * (1.0 + EPS))
    if strategy != "most":
        strat = 1.0 - strat
    ids = torch.arange(m, device=fit.device, dtype=torch.float32)
    base_key = ((~pref).to(torch.float32) * (4.0 * m * (z + 2))
                + popcnt[None].to(torch.float32) * (4.0 * m)
                + strat * (2.0 * m) + ids[None] * (1.0 / m))
    engaged = policy > POLICY_NONE
    any_fit = torch.any(fit, dim=-1)
    admit = torch.ones_like(engaged)
    best_mask = valid
    for code, c in cand.items():
        key = torch.where(c, base_key, torch.inf)
        idx = torch.argmin(key, dim=-1)   # the first minimum
        chosen = torch.where(torch.any(c, dim=-1)[:, None], masks[idx], valid)
        is_pol = policy == code
        best_mask = torch.where(is_pol[:, None], chosen, best_mask)
        if code != POLICY_BEST_EFFORT:
            admit = admit & (~is_pol | torch.any(c, dim=-1) | ~any_fit)
    affinity = torch.where(engaged[:, None], best_mask, valid)
    return affinity, admit, engaged


def greedy_take(free_z: torch.Tensor, req: torch.Tensor,
                affinity: torch.Tensor, strategy: str = "most"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split req f32[P, D] across the affinity's zones greedily, fullest
    zone first for "most" (freest first otherwise), each dim on its own:
    (take f32[P, Z, D], filled bool[P]); filled is False where the
    affinity's combined free cannot cover the request."""
    avail = torch.where(affinity[:, :, None], free_z, 0.0)
    most = strategy == "most"
    key = torch.where(affinity, free_z[..., 0],
                      torch.inf if most else -torch.inf)
    order = torch.sort(key, dim=-1, stable=True).indices
    if not most:
        order = order.flip(-1)
    sorted_avail = avail.gather(1, order[:, :, None].expand_as(avail))
    cum = torch.zeros_like(sorted_avail[:, 0])
    sorted_take = torch.empty_like(sorted_avail)
    for j in range(sorted_avail.shape[1]):
        cum = cum + sorted_avail[:, j]
        before = cum - sorted_avail[:, j]
        want = torch.clamp_min(req - before, 0.0)
        sorted_take[:, j] = torch.minimum(want, sorted_avail[:, j])
    take = torch.zeros_like(sorted_take).scatter(
        1, order[:, :, None].expand_as(sorted_take), sorted_take)
    total = torch.zeros_like(req)
    for j in range(take.shape[1]):
        total = total + take[:, j]
    filled = torch.all(total + EPS >= req, dim=-1)
    return take, filled
