"""Synthetic cluster and pod queue for the slim flagship, in numpy.

A copy of the parts of `koordinator_tpu/utils/synthetic.py` that the
slim flagship needs: the same generator calls in the same order, so a
seed gives the same arrays as the reference (tests/test_torch_schema.py
holds the two equal). The arrays are built on the host and moved to
`device` once. GPU nodes and reservation slots belong to the full-gate
workload and are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.api.extension import (
    NUM_AUX_TYPES,
    NUM_RESOURCES,
    PriorityClass,
    QoSClass,
    ResourceKind,
)
from koordinator_tpu_torch.bridge import from_reference
from koordinator_tpu_torch.snapshot.schema import (
    MAX_QUOTA_DEPTH,
    NUM_AGG,
    NUM_DEV_DIMS,
    PER_POD_FIELDS,
    ClusterSnapshot,
    PodBatch,
)

R = NUM_RESOURCES
CPU, MEM = int(ResourceKind.CPU), int(ResourceKind.MEMORY)
BCPU, BMEM = int(ResourceKind.BATCH_CPU), int(ResourceKind.BATCH_MEMORY)


def estimate_vectorized(requests: np.ndarray, limits: np.ndarray,
                        priority_class: np.ndarray,
                        cpu_factor: float = 85.0,
                        mem_factor: float = 70.0) -> np.ndarray:
    """DefaultEstimator (estimator/default_estimator.go:62-110) over
    [P, R] request/limit columns for the cpu/memory weight dims."""
    p = requests.shape[0]
    out = np.zeros((p, R), np.float32)
    is_batch = priority_class == int(PriorityClass.BATCH)
    is_mid = priority_class == int(PriorityClass.MID)
    for kind, factor, default in ((CPU, cpu_factor, 250.0),
                                  (MEM, mem_factor, 200.0)):
        tier_dim = np.where(
            is_batch, kind + 2, np.where(is_mid, kind + 4, kind))
        req = np.take_along_axis(requests, tier_dim[:, None], 1)[:, 0]
        lim = np.take_along_axis(limits, tier_dim[:, None], 1)[:, 0]
        use_lim = lim > req
        qty = np.where(use_lim, lim, req)
        f = np.where(use_lim, 100.0, factor)
        est = np.floor(qty.astype(np.float64) * f / 100.0 + 0.5)
        est = np.where(lim > 0, np.minimum(est, lim), est)
        est = np.where(qty == 0, default, est)
        out[:, kind] = est.astype(np.float32)
    return out


def synthetic_cluster(num_nodes: int, seed: int = 0,
                      max_quotas: int = 64, max_gangs: int = 64,
                      num_quotas: int = 0, num_gangs: int = 0,
                      gang_min_member: int = 8,
                      batch_overcommit_ratio: float = 0.5,
                      usage_cpu_frac: Tuple[float, float] = (0.0, 0.6),
                      now_version: int = 0,
                      device="cuda") -> ClusterSnapshot:
    """Heterogeneous nodes with fresh NodeMetrics, batch-tier overcommit
    resources, a two-level quota tree (root + num_quotas - 1 children)
    and gangs; no GPU pools and no reservation slots."""
    rng = np.random.default_rng(seed)
    n = num_nodes
    f32 = np.float32

    cpu_alloc = rng.choice([32000, 64000, 96000], n).astype(f32)
    mem_alloc = (rng.choice([128, 256, 384], n) * 1024).astype(f32)
    alloc = np.zeros((n, R), f32)
    alloc[:, CPU] = cpu_alloc
    alloc[:, MEM] = mem_alloc
    usage = np.zeros((n, R), f32)
    usage[:, CPU] = (rng.uniform(*usage_cpu_frac, n) * cpu_alloc).astype(f32)
    usage[:, MEM] = (rng.uniform(0.1, 0.7, n) * mem_alloc).astype(f32)
    alloc[:, BCPU] = np.maximum(
        (cpu_alloc - usage[:, CPU]) * batch_overcommit_ratio, 0)
    alloc[:, BMEM] = np.maximum(
        (mem_alloc - usage[:, MEM]) * batch_overcommit_ratio, 0)

    agg = np.zeros((n, NUM_AGG, R), f32)
    agg[:] = usage[:, None, :]
    agg[:, 2:] *= 1.15

    nodes = dict(
        allocatable=alloc,
        requested=np.zeros((n, R), f32),
        usage=usage,
        prod_usage=usage * 0.8,
        agg_usage=agg,
        assigned_estimated=np.zeros((n, R), f32),
        assigned_correction=np.zeros((n, R), f32),
        prod_assigned_estimated=np.zeros((n, R), f32),
        prod_assigned_correction=np.zeros((n, R), f32),
        metric_fresh=np.ones((n,), bool),
        has_agg=np.ones((n,), bool),
        schedulable=np.ones((n,), bool),
        label_group=np.zeros((n,), np.int32),
        numa_cap=np.zeros((n, 4, 2), f32),
        numa_free=np.zeros((n, 4, 2), f32),
        numa_valid=np.zeros((n, 4), bool),
        numa_policy=np.zeros((n,), np.int32),
        cpu_amplification=np.ones((n,), f32),
        taint_group=np.zeros((n,), np.int32),
    )

    q = max_quotas
    quota_min = np.zeros((q, R), f32)
    quota_max = np.full((q, R), np.inf, f32)
    weight = np.zeros((q, R), f32)
    parent = np.full((q,), -1, np.int32)
    ancestors = np.zeros((q, q), bool)
    depth_anc = np.full((q, MAX_QUOTA_DEPTH), -1, np.int32)
    qvalid = np.zeros((q,), bool)
    if num_quotas > 0:
        total_cpu = float(cpu_alloc.sum())
        total_mem = float(mem_alloc.sum())
        qvalid[:num_quotas] = True
        quota_max[0, CPU], quota_max[0, MEM] = total_cpu, total_mem
        ancestors[0, 0] = True
        depth_anc[0, 0] = 0
        for i in range(1, num_quotas):
            share = rng.uniform(0.05, 0.3)
            quota_max[i, CPU] = total_cpu * share
            quota_max[i, MEM] = total_mem * share
            quota_min[i, CPU] = total_cpu * share * 0.2
            quota_min[i, MEM] = total_mem * share * 0.2
            parent[i] = 0
            ancestors[i, i] = True
            ancestors[i, 0] = True
            depth_anc[i, 0] = 0
            depth_anc[i, 1] = i
        weight = np.where(np.isinf(quota_max), 1.0, quota_max).astype(f32)
    quotas = dict(
        min=quota_min, max=quota_max, shared_weight=weight, parent=parent,
        ancestors=ancestors, depth_ancestor=depth_anc,
        used=np.zeros((q, R), f32), demand=np.zeros((q, R), f32),
        allow_lent=np.ones((q,), bool),
        runtime=quota_max.copy(), valid=qvalid)

    g = max_gangs
    gangs = dict(
        min_member=np.full((g,), gang_min_member, np.int32),
        member_count=np.full((g,), gang_min_member, np.int32),
        assumed=np.zeros((g,), np.int32),
        strict=np.ones((g,), bool),
        satisfied=np.zeros((g,), bool),
        valid=np.arange(g) < num_gangs,
    )
    reservations = dict(
        node=np.full((0,), -1, np.int32),
        free=np.zeros((0, R), f32),
        owner_group=np.zeros((0,), np.int32),
        allocate_once=np.zeros((0,), bool),
        valid=np.ones((0,), bool),
        gpu_free=np.zeros((0, 0, NUM_DEV_DIMS), f32),
        gpu_valid=np.zeros((0, 0), bool),
        numa_free=np.zeros((0, 4, 2), f32),
        numa_valid=np.zeros((0, 4), bool),
    )
    devices = dict(
        gpu_total=np.zeros((n, NUM_DEV_DIMS), f32),
        gpu_free=np.zeros((n, 0, NUM_DEV_DIMS), f32),
        gpu_valid=np.zeros((n, 0), bool),
        gpu_numa=np.full((n, 0), -1, np.int32),
        gpu_pcie=np.full((n, 0), -1, np.int32),
        aux_free=np.zeros((n, NUM_AUX_TYPES, 0), f32),
        aux_valid=np.zeros((n, NUM_AUX_TYPES, 0), bool),
    )
    return from_reference("ClusterSnapshot", dict(
        nodes=nodes, quotas=quotas, gangs=gangs, reservations=reservations,
        devices=devices, version=np.int32(now_version)), device)


def synthetic_pods(num_pods: int, seed: int = 1,
                   prod_frac: float = 0.6,
                   num_quotas: int = 0, num_gangs: int = 0,
                   gang_min_member: int = 8,
                   device="cuda") -> PodBatch:
    """A pending-pod queue: prod pods request native cpu/mem, batch pods
    batch-tier resources; requests are multiples of 500 mC and 512 MiB."""
    rng = np.random.default_rng(seed)
    p = num_pods
    f32 = np.float32
    is_prod = rng.uniform(size=p) < prod_frac
    prio_class = np.where(is_prod, int(PriorityClass.PROD),
                          int(PriorityClass.BATCH)).astype(np.int8)
    priority = np.where(is_prod, 9000, 5000).astype(np.int32) + \
        rng.integers(0, 999, p).astype(np.int32)

    cpu_req = (rng.integers(1, 16, p) * 500).astype(f32)
    mem_req = (rng.integers(1, 32, p) * 512).astype(f32)
    requests = np.zeros((p, R), f32)
    requests[is_prod, CPU] = cpu_req[is_prod]
    requests[is_prod, MEM] = mem_req[is_prod]
    requests[~is_prod, BCPU] = cpu_req[~is_prod]
    requests[~is_prod, BMEM] = mem_req[~is_prod]
    limits = np.zeros((p, R), f32)
    estimated = estimate_vectorized(requests, limits, prio_class)

    gang_id = np.full((p,), -1, np.int32)
    if num_gangs > 0:
        members = num_gangs * gang_min_member
        gang_id[:members] = np.repeat(np.arange(num_gangs, dtype=np.int32),
                                      gang_min_member)
    quota_id = np.full((p,), -1, np.int32)
    if num_quotas > 1:
        quota_id = rng.integers(1, num_quotas, p).astype(np.int32)

    return from_reference("PodBatch", dict(
        requests=requests, estimated=estimated,
        qos=np.where(is_prod, int(QoSClass.LS),
                     int(QoSClass.BE)).astype(np.int8),
        priority_class=prio_class, priority=priority,
        gang_id=gang_id, quota_id=quota_id,
        selector_id=np.full((p,), -1, np.int32),
        selector_match=np.zeros((8, 64), bool),
        reservation_owner=np.full((p,), -1, np.int32),
        gpu_ratio=np.zeros((p,), f32),
        numa_single=np.zeros((p,), bool),
        daemonset=np.zeros((p,), bool),
        toleration_id=np.zeros((p,), np.int32),
        tol_forbid=np.zeros((1, 1), bool),
        tol_prefer=np.zeros((1, 1), f32),
        spread_id=np.full((p,), -1, np.int32),
        spread_carrier=np.zeros((p, 1), bool),
        spread_member=np.zeros((p, 1), bool),
        spread_max_skew=np.ones((1,), f32),
        spread_domain=np.full((1, 1), -1, np.int32),
        spread_count0=np.zeros((1, 1), f32),
        spread_dvalid=np.zeros((1, 1), bool),
        anti_id=np.full((p,), -1, np.int32),
        anti_member=np.zeros((p, 1), bool),
        anti_carrier=np.zeros((p, 1), bool),
        anti_domain=np.full((1, 1), -1, np.int32),
        anti_count0=np.zeros((1, 1), f32),
        anti_carrier_count0=np.zeros((1, 1), f32),
        aff_id=np.full((p,), -1, np.int32),
        aff_carrier=np.zeros((p, 1), bool),
        aff_member=np.zeros((p, 1), bool),
        aff_domain=np.full((1, 1), -1, np.int32),
        aff_count0=np.zeros((1, 1), f32),
        valid=np.ones((p,), bool),
    ), device)


def stack_pod_chunks(pods: PodBatch, chunk: int) -> Dict[str, torch.Tensor]:
    """[P, ...] per-pod columns -> [C, chunk, ...] views (the sweep's
    chunk operands)."""
    num = pods.valid.shape[0]
    if num % chunk:
        raise ValueError(f"{num} pods not divisible by chunk {chunk}")
    n_chunks = num // chunk
    return {f: getattr(pods, f).reshape(n_chunks, chunk,
                                        *getattr(pods, f).shape[1:])
            for f in PER_POD_FIELDS}


def slice_batch(batch: PodBatch, start: int, size: int) -> PodBatch:
    """A pod-chunk view; the batch-global matrices stay whole."""
    return batch.replace(**{f: getattr(batch, f)[start:start + size]
                            for f in PER_POD_FIELDS})
