"""Synthetic clusters and pod queues, in numpy.

A copy of the parts of `koordinator_tpu/utils/synthetic.py` that the
slim flagship, BASELINE config 2 and gpu_share need: the same generator
calls in the same order, so a seed gives the same arrays as the
reference (tests/test_torch_schema.py and tests/test_torch_reservation.py
hold the two equal). The arrays are built on the host and moved to
`device` once. GPU nodes (`gpu_node_frac`), GPU pods (`gpu_pod_frac`),
live reservation slots (`num_reservations`, on their own generator) and
the full-gate workload's taint classes, toleration sets, pod topology
groups and slot owners draw in the reference's order. The full-gate
packers (`pack_gate_prefixes`, `topo_constrained_mask`, `dom_classes`)
compute on the host, as the reference's do. `config_4_inputs` is
BASELINE config 4's cluster and queue. `amplified_cpu` draws the CPU
amplification ratios of the amplified full gate (`with_amplified_cpu`,
`amplified_full_gate_inputs`), which the reference's own generators do
not draw. `config_5_cluster` builds BASELINE config 5's descheduler
cluster as typed objects, with the draws of
`bench_configs.config_5_descheduler`, and with `every_node` the same
cluster listing pods on every node.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.api.extension import (
    AUX_KINDS,
    NUM_AUX_TYPES,
    NUM_RESOURCES,
    PriorityClass,
    QoSClass,
    ResourceKind,
)
from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.bridge import from_reference
from koordinator_tpu_torch.scheduler.plugins.deviceshare import (
    has_device_request,
    has_gpu_request,
)
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
GPU_CORE = int(ResourceKind.GPU_CORE)
GPU_MEMORY = int(ResourceKind.GPU_MEMORY)
# a live reservation slot's hold (synthetic_cluster num_reservations > 0)
RESV_SLOT_CPU, RESV_SLOT_MEM = 4000.0, 8192.0


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
                      gpu_node_frac: float = 0.0,
                      gpus_per_node: int = 8,
                      gpu_memory_mib: float = 81920.0,
                      num_reservations: int = 0,
                      now_version: int = 0,
                      device="cuda") -> ClusterSnapshot:
    """Heterogeneous nodes with fresh NodeMetrics, batch-tier overcommit
    resources, a two-level quota tree (root + num_quotas - 1 children)
    and gangs. With num_reservations = V > 0, V live reservation slots
    on V distinct nodes (drawn from their own generator, seed + 41),
    each holding RESV_SLOT_CPU / RESV_SLOT_MEM, charged onto its host
    node's `requested`, owned by owner group v, the even ones
    AllocateOnce, with no zone or instance hold. With gpu_node_frac > 0,
    that share of the nodes (drawn after the quotas, on the same
    generator) carries gpus_per_node A100-like instances (100 core,
    gpu_memory_mib, 100 ratio each), split over two NUMA zones and two
    a PCIe root, and their aggregate in the node's allocatable."""
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
    i = gpus_per_node if gpu_node_frac > 0 else 0
    v = int(num_reservations)
    if v > n:
        raise ValueError(f"num_reservations={v} needs at least that many "
                         f"nodes; got {n}")
    r_nodes = np.full((v,), -1, np.int32)
    r_free = np.zeros((v, R), f32)
    if v:
        r_nodes = np.random.default_rng(seed + 41).choice(
            n, v, replace=False).astype(np.int32)
        r_free[:, CPU] = RESV_SLOT_CPU
        r_free[:, MEM] = RESV_SLOT_MEM
        nodes["requested"][r_nodes, CPU] += RESV_SLOT_CPU
        nodes["requested"][r_nodes, MEM] += RESV_SLOT_MEM
    reservations = dict(
        node=r_nodes,
        free=r_free,
        owner_group=np.arange(v, dtype=np.int32),
        allocate_once=np.arange(v) % 2 == 0,
        valid=np.ones((v,), bool),
        gpu_free=np.zeros((v, i, NUM_DEV_DIMS), f32),
        gpu_valid=np.zeros((v, i), bool),
        numa_free=np.zeros((v, 4, 2), f32),
        numa_valid=np.zeros((v, 4), bool),
    )
    gpu_total = np.zeros((n, NUM_DEV_DIMS), f32)
    is_gpu_node = np.zeros((n,), bool)
    if gpu_node_frac > 0:
        is_gpu_node = rng.uniform(size=n) < gpu_node_frac
        gpu_total[is_gpu_node] = (100.0, gpu_memory_mib, 100.0)
        alloc[is_gpu_node, GPU_CORE] = i * 100.0
        alloc[is_gpu_node, GPU_MEMORY] = i * gpu_memory_mib
    inst = np.arange(i)
    gpu_numa = np.broadcast_to((inst * 2 // max(i, 1))[None, :],
                               (n, i)).astype(np.int32).copy()
    gpu_pcie = np.broadcast_to((inst // 2)[None, :],
                               (n, i)).astype(np.int32).copy()
    gpu_numa[~is_gpu_node] = -1
    gpu_pcie[~is_gpu_node] = -1
    devices = dict(
        gpu_total=gpu_total,
        gpu_free=np.broadcast_to(gpu_total[:, None, :],
                                 (n, i, NUM_DEV_DIMS)).copy(),
        gpu_valid=np.broadcast_to(is_gpu_node[:, None], (n, i)).copy(),
        gpu_numa=gpu_numa,
        gpu_pcie=gpu_pcie,
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
                   gpu_pod_frac: float = 0.0,
                   device="cuda") -> PodBatch:
    """A pending-pod queue: prod pods request native cpu/mem, batch pods
    batch-tier resources; requests are multiples of 500 mC and 512 MiB.
    With gpu_pod_frac > 0, that share of the pods asks for GPU ratio
    and core 50, 100, 200 or 400 (shared half-GPUs, whole GPUs, 2- and
    4-GPU trainers; probabilities 0.4/0.3/0.2/0.1), drawn before the
    gang and quota draws, as the reference draws them."""
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

    gpu_ratio = np.zeros((p,), f32)
    if gpu_pod_frac > 0:
        is_gpu = rng.uniform(size=p) < gpu_pod_frac
        shape = rng.choice([50, 100, 200, 400], p,
                           p=[0.4, 0.3, 0.2, 0.1]).astype(f32)
        gpu_ratio = np.where(is_gpu, shape, 0.0).astype(f32)
        requests[:, GPU_CORE] = np.where(is_gpu, shape, 0.0)

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
        gpu_ratio=gpu_ratio,
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


# --- the full-gate packing contracts (utils/synthetic.py:576-690) --------


def dom_classes(pods: PodBatch) -> tuple:
    """(spread, anti, affinity) domain classes for schedule_batch's
    `dom_classes`: each family's groups whose domain-map rows are equal
    (the upstream topologyKey sets the row), in first-seen order."""
    def classes(dom):
        seen = {}
        for g, row in enumerate(dom.cpu().numpy()):
            seen.setdefault(row.tobytes(), []).append(g)
        return tuple(tuple(v) for v in seen.values())
    return (classes(pods.spread_domain), classes(pods.anti_domain),
            classes(pods.aff_domain))


def topo_constrained_mask(pods: PodBatch) -> np.ndarray:
    """bool[P]: the pods carrying or matching any spread, anti-affinity
    or affinity group, the rows the topo_prefix contract puts first."""
    p = pods.num_pods
    constrained = np.zeros((p,), bool)
    for f in ("spread_member", "spread_carrier", "anti_member",
              "anti_carrier", "aff_member", "aff_carrier"):
        m = getattr(pods, f).cpu().numpy()
        if m.shape[0] == p:
            constrained |= m.any(axis=1)
    return constrained


def pack_topo_prefix(pods: PodBatch, chunk: int, align: int = 128) -> tuple:
    """(packed pods, topo_prefix, constrained mask in packed order): the
    topology class of `pack_gate_prefixes`."""
    packed, prefixes, masks = pack_gate_prefixes(pods, chunk, align=align)
    return packed, prefixes["topo"], masks["topo"]


def pack_gate_prefixes(pods: PodBatch, chunk: int, align: int = 128) -> tuple:
    """(packed pods, prefixes, masks): the pods of each chunk reordered,
    stably, by (topology, CPU-bind, device request) membership, so that
    each class lies inside a nested prefix of every chunk (topo <= numa
    <= gpu): the schedule_batch packing contracts. `prefixes` maps
    "topo", "numa", "gpu" to the largest class count of a chunk rounded
    up to `align` (at most the chunk); `masks` maps them to each class's
    bool[P] in packed order, and "perm" to the permutation (packed row i
    is row perm[i] of `pods`). Raises ValueError where a class escapes
    its prefix (`check_gate_prefixes`). The numa contract also needs a
    snapshot without topology-manager policies, which the caller
    checks."""
    p = pods.num_pods
    if p % chunk:
        raise ValueError(f"{p} pods not divisible by chunk {chunk}")
    topo = topo_constrained_mask(pods)
    numa = pods.numa_single.cpu().numpy().astype(bool)
    gpu = has_device_request(pods.requests, pods.gpu_ratio).cpu().numpy()
    perm = np.empty((p,), np.int64)
    worst = {"topo": 0, "numa": 0, "gpu": 0}
    for s in range(0, p, chunk):
        t = topo[s:s + chunk]
        n = t | numa[s:s + chunk]
        g = n | gpu[s:s + chunk]
        perm[s:s + chunk] = s + np.lexsort((~g, ~n, ~t))
        worst["topo"] = max(worst["topo"], int(t.sum()))
        worst["numa"] = max(worst["numa"], int(n.sum()))
        worst["gpu"] = max(worst["gpu"], int(g.sum()))
    prefixes = {k: min(-(-v // align) * align, chunk)
                for k, v in worst.items()}
    index = torch.from_numpy(perm).to(pods.valid.device)
    packed = pods.replace(**{f: getattr(pods, f)[index]
                             for f in PER_POD_FIELDS})
    masks = {"topo": topo[perm], "numa": numa[perm], "gpu": gpu[perm],
             "perm": perm}
    check_gate_prefixes(masks, prefixes, chunk)
    return packed, prefixes, masks


def check_gate_prefixes(masks: dict, prefixes: dict, chunk: int) -> None:
    """Raise ValueError where a pod of class "topo", "numa" or "gpu"
    (`masks`, packed order) sits at or beyond its prefix in its chunk:
    the scheduler would silently leave it out of that class's gates."""
    for key in ("topo", "numa", "gpu"):
        m, pref = masks[key], prefixes[key]
        for s in range(0, m.shape[0], chunk):
            if m[s + pref:s + chunk].any():
                raise ValueError(
                    f"pack_gate_prefixes: {key} pod escaped its prefix")


def with_two_numa_zones(snap: ClusterSnapshot) -> ClusterSnapshot:
    """Every node with two NUMA zones at half its cpu and memory each
    (the dual-socket shape), the zone axis cut to exactly 2, and the
    reservation zone columns cut to match; raises where the cut would
    drop a reservation's zone hold."""
    nodes, resv = snap.nodes, snap.reservations
    z = 2
    if resv.numa_valid.shape[1] < z:
        raise ValueError(
            "with_two_numa_zones needs >= 2 reservation zone slots to "
            "keep the node/reservation zone axes consistent")
    if bool(resv.numa_valid[:, z:].any()):
        raise ValueError(
            "with_two_numa_zones would silently drop reservation NUMA "
            "holds in zones >= 2; this helper is for dual-socket "
            "workloads only")
    half = torch.stack([nodes.allocatable[:, CPU], nodes.allocatable[:, MEM]],
                       dim=-1) / 2
    numa_cap = half[:, None, :].expand(-1, z, -1).contiguous()
    return snap.replace(
        nodes=nodes.replace(
            numa_cap=numa_cap, numa_free=numa_cap.clone(),
            numa_valid=torch.ones((nodes.num_nodes, z), dtype=torch.bool,
                                  device=numa_cap.device)),
        reservations=resv.replace(
            numa_free=resv.numa_free[:, :z].contiguous(),
            numa_valid=resv.numa_valid[:, :z].contiguous()))


def config_2_inputs(num_pods: int = 10_000, num_nodes: int = 1000,
                    device="cuda") -> Tuple[ClusterSnapshot, PodBatch]:
    """BASELINE config 2 (bench_configs.config_2_numa): nodes seed 0 with
    32 quotas and two populated NUMA zones, pods seed 1 (60 % prod, 32
    quotas), every prod pod single-NUMA bound."""
    snap = with_two_numa_zones(synthetic_cluster(
        num_nodes, num_quotas=32, seed=0, device=device))
    pods = synthetic_pods(num_pods, seed=1, prod_frac=0.6, num_quotas=32,
                          device=device)
    return snap, pods.replace(
        numa_single=pods.priority_class == int(PriorityClass.PROD))


def config_1_inputs(device="cuda") -> Tuple[ClusterSnapshot, PodBatch]:
    """BASELINE config 1 (bench_configs.config_1_spark, :84-93): 10 nodes
    seed 0 with 2 quotas, 32 pods seed 1, all of them batch-tier (prod
    share 0), over the same quotas."""
    snap = synthetic_cluster(10, num_quotas=2, seed=0, device=device)
    pods = synthetic_pods(32, seed=1, prod_frac=0.0, num_quotas=2,
                          device=device)
    return snap, pods


def config_3_inputs(num_gangs: int = 1000, num_nodes: int = 5000,
                    device="cuda") -> Tuple[ClusterSnapshot, PodBatch]:
    """BASELINE config 3 (bench_configs.config_3_gangs, :116-129):
    `num_nodes` nodes seed 0 with 32 quotas and `num_gangs` strict gangs
    of 8 in a table of 1024, and their 8 * num_gangs members, seed 1."""
    snap = synthetic_cluster(num_nodes, num_quotas=32, seed=0,
                             num_gangs=num_gangs, max_gangs=1024,
                             gang_min_member=8, device=device)
    pods = synthetic_pods(8 * num_gangs, seed=1, num_quotas=32,
                          num_gangs=num_gangs, gang_min_member=8,
                          device=device)
    return snap, pods


def config_4_inputs(num_pods: int = 50_000, num_nodes: int = 5000,
                    num_quotas: int = 500, device="cuda"
                    ) -> Tuple[ClusterSnapshot, PodBatch]:
    """BASELINE config 4 (bench_configs.config_4_quota, :131-141): nodes
    seed 0 with `num_quotas` quotas in a table of 512, pods seed 1 over
    the same quotas."""
    snap = synthetic_cluster(num_nodes, num_quotas=num_quotas, max_quotas=512,
                             seed=0, device=device)
    pods = synthetic_pods(num_pods, seed=1, num_quotas=num_quotas,
                          device=device)
    return snap, pods


# config_4_fair_share_500q_50k's quota tree: root, business units,
# departments (per unit), leaf teams; the root's share of the cluster
FAIR_SHARE_UNITS, FAIR_SHARE_DEPTS_PER_UNIT, FAIR_SHARE_LEAVES = 8, 5, 451
FAIR_SHARE_ROOT_SHARE = 0.3
FAIR_SHARE_UNIT_MIN = 0.6          # the units' mins, of the root's max
FAIR_SHARE_CHILD_MIN = (0.5, 0.9)  # a level's mins, of its parent's min
FAIR_SHARE_CHILD_MAX = (0.3, 0.8)  # a child's max, of its parent's max
FAIR_SHARE_WEIGHTED = 0.3          # quotas with an explicit shared weight
FAIR_SHARE_NOT_LENDING = 0.2
FAIR_SHARE_ZIPF_A = 1.3


def fair_share_tree(allocatable: np.ndarray, node_valid: np.ndarray,
                    num_pods: int, max_quotas: int = 512, seed: int = 5
                    ) -> dict:
    """A contended four-level ElasticQuota tree over a shared pool, in
    numpy: {"quotas": QuotaState's fields, "quota_id": i32[num_pods] (the
    pods redrawn over the leaves), "cluster_total": f32[R]}.

    Rows: 0 the root; 1-8 business units; 9-48 departments (5 a unit);
    49-499 leaf teams, spread evenly over the departments; the rest of
    the table invalid. The root's max is FAIR_SHARE_ROOT_SHARE of the
    valid nodes' allocatable (summed in float64, then f32; unlimited in
    a column the cluster has none of); a child's max a uniform
    FAIR_SHARE_CHILD_MAX share of its parent's; the units' mins split
    FAIR_SHARE_UNIT_MIN of the root's max, each lower level's a uniform
    FAIR_SHARE_CHILD_MIN share of its parent's min (Dirichlet splits,
    at most the child's max). FAIR_SHARE_WEIGHTED of the quotas carry a
    shared weight of 0.5-2x their max (the rest weigh their max), and
    FAIR_SHARE_NOT_LENDING do not lend. Each pod's quota is a leaf
    drawn with a Zipf skew (a = FAIR_SHARE_ZIPF_A over the leaves in a
    random order)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q = max_quotas
    cluster = allocatable[node_valid].astype(np.float64).sum(axis=0)
    units = FAIR_SHARE_UNITS
    depts = units * FAIR_SHARE_DEPTS_PER_UNIT
    first_dept, first_leaf = 1 + units, 1 + units + depts
    n = first_leaf + FAIR_SHARE_LEAVES
    if n > q:
        raise ValueError(f"the tree's {n} quotas exceed a table of {q}")
    parent = np.full((q,), -1, np.int32)
    parent[1:first_dept] = 0
    parent[first_dept:first_leaf] = 1 + np.arange(depts) \
        // FAIR_SHARE_DEPTS_PER_UNIT
    parent[first_leaf:n] = first_dept + np.arange(FAIR_SHARE_LEAVES) \
        * depts // FAIR_SHARE_LEAVES
    has = cluster > 0
    mx = np.full((q, R), np.inf)
    mn = np.zeros((q, R))
    mx[0] = np.where(has, cluster * FAIR_SHARE_ROOT_SHARE, np.inf)
    for i in range(1, n):
        mx[i] = mx[parent[i]] * rng.uniform(*FAIR_SHARE_CHILD_MAX)
    for p in range(first_leaf):
        kids = np.flatnonzero(parent[:n] == p)
        share = (FAIR_SHARE_UNIT_MIN * mx[0] if p == 0
                 else rng.uniform(*FAIR_SHARE_CHILD_MIN) * mn[p])
        split = rng.dirichlet(np.ones(kids.size))
        mn[kids] = np.where(has, share[None] * split[:, None], 0.0)
    mn = np.minimum(mn, mx)
    weighted = rng.uniform(size=q) < FAIR_SHARE_WEIGHTED
    sw = np.where(weighted[:, None] & np.isfinite(mx),
                  mx * rng.uniform(0.5, 2.0, size=(q, 1)), 0.0)
    lent = rng.uniform(size=q) >= FAIR_SHARE_NOT_LENDING
    valid = np.arange(q) < n
    lent[0] = True
    ancestors = np.zeros((q, q), bool)
    depth_anc = np.full((q, MAX_QUOTA_DEPTH), -1, np.int32)
    for i in range(n):
        chain = [i]
        while parent[chain[-1]] >= 0:
            chain.append(int(parent[chain[-1]]))
        ancestors[i, chain] = True
        depth_anc[i, :len(chain)] = chain[::-1]
    rank_p = np.arange(1, FAIR_SHARE_LEAVES + 1, dtype=np.float64) \
        ** -FAIR_SHARE_ZIPF_A
    order = rng.permutation(FAIR_SHARE_LEAVES)
    quota_id = (first_leaf + order[rng.choice(
        FAIR_SHARE_LEAVES, num_pods, p=rank_p / rank_p.sum())]).astype(
        np.int32)
    mx, mn = mx.astype(f32), mn.astype(f32)
    quotas = dict(
        min=mn, max=mx, shared_weight=sw.astype(f32), parent=parent,
        ancestors=ancestors, depth_ancestor=depth_anc,
        used=np.zeros((q, R), f32), demand=np.zeros((q, R), f32),
        allow_lent=lent, runtime=mx.copy(), valid=valid)
    return {"quotas": quotas, "quota_id": quota_id,
            "cluster_total": cluster.astype(f32)}


def fair_share_inputs(num_pods: int = 50_000, num_nodes: int = 5000,
                      device="cuda"):
    """config_4_fair_share_500q_50k: config 4's nodes (seed 0) and pods
    (seed 1) with the quota table rebuilt as `fair_share_tree` and the
    pods' quotas redrawn over its leaves. Returns (snap, pods,
    cluster_total f32[R]); the snapshot's runtime is its max."""
    snap, pods = config_4_inputs(num_pods, num_nodes, device="cpu")
    tree = fair_share_tree(snap.nodes.allocatable.numpy(),
                           snap.nodes.schedulable.numpy(), num_pods)
    snap = snap.replace(quotas=from_reference("QuotaState", tree["quotas"],
                                              "cpu"))
    pods = pods.replace(quota_id=torch.from_numpy(tree["quota_id"]))
    dev = resolve_device(device)
    return (snap.to(dev), pods.to(dev),
            torch.from_numpy(tree["cluster_total"]).to(dev))


# the amplified full gate: the share of nodes the node webhook amplifies
# and the ratios it draws from
AMPLIFIED_NODE_FRAC = 0.3
AMPLIFIED_RATIOS = (1.5, 2.0, 3.0)


def amplified_cpu(allocatable: np.ndarray, seed: int = 7
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(cpu_amplification f32[N], allocatable f32[N, R]): about
    AMPLIFIED_NODE_FRAC of the nodes get a ratio drawn from
    AMPLIFIED_RATIOS (the rest 1.0), and their CPU allocatable is
    multiplied by it in f32, as the node webhook publishes it (the NUMA
    zones stay raw). Numpy arrays, so that a test applies the same ones
    to the reference's snapshot."""
    rng = np.random.default_rng(seed)
    n = allocatable.shape[0]
    on = rng.uniform(size=n) < AMPLIFIED_NODE_FRAC
    drawn = rng.choice(np.asarray(AMPLIFIED_RATIOS, np.float32), size=n)
    ratio = np.where(on, drawn, np.float32(1.0)).astype(np.float32)
    alloc = np.array(allocatable, dtype=np.float32, copy=True)
    alloc[:, CPU] = alloc[:, CPU] * ratio
    return ratio, alloc


def with_amplified_cpu(snap: ClusterSnapshot, seed: int = 7
                       ) -> ClusterSnapshot:
    """`snap` with `amplified_cpu`'s ratios and allocatable."""
    dev = snap.nodes.allocatable.device
    ratio, alloc = amplified_cpu(snap.nodes.allocatable.cpu().numpy(), seed)
    return snap.replace(nodes=snap.nodes.replace(
        cpu_amplification=torch.from_numpy(ratio).to(dev),
        allocatable=torch.from_numpy(alloc).to(dev)))


def amplified_full_gate_inputs(num_pods: int = 100_000,
                               num_nodes: int = 10_000, device="cuda"
                               ) -> Tuple[ClusterSnapshot, PodBatch]:
    """`gpu_share_inputs` with the nodes' CPU amplified
    (`with_amplified_cpu`): the full gate's workload on a cluster whose
    node webhook amplifies CPU."""
    snap, pods = gpu_share_inputs(num_pods, num_nodes, device=device)
    return with_amplified_cpu(snap), pods


# the aux full gate's pools (J instances a node and pool) and draws:
# the RDMA VFs' free (percent), the pods' shares and requests, and the
# share of each kind of aux pod that asks for more than one instance
# holds (one instance serves a whole request), so finds no node
AUX_INSTANCES = 8
AUX_FREE_LEVELS = (100.0, 100.0, 75.0, 50.0, 0.0)
AUX_OTHER_NODE_FRAC, AUX_FPGA_NODE_FRAC = 0.10, 0.02
AUX_GPU_POD_FRAC, AUX_RDMA_ALONE_FRAC, AUX_FPGA_POD_FRAC = 0.6, 0.01, 0.002
AUX_GPU_POD_REQ, AUX_RDMA_ALONE_REQ = (100.0, 50.0, 25.0), (25.0, 50.0,
                                                          75.0, 100.0)
AUX_TOO_BIG_FRAC, AUX_TOO_BIG_REQ = 0.05, 150.0


def aux_pools(gpu_nodes: np.ndarray, gpu_pods: np.ndarray, seed: int = 11):
    """(aux_free f32[N, 2, J], aux_valid bool[N, 2, J], aux_req f32[P, 2],
    aux_alloc f32[N, 2], aux_used f32[N, 2]) of the aux full gate,
    J = AUX_INSTANCES: every GPU node (gpu_nodes
    bool[N]) gets J valid RDMA VFs and AUX_OTHER_NODE_FRAC of the other
    nodes two, each VF's free drawn from AUX_FREE_LEVELS; AUX_FPGA_NODE_FRAC
    of all nodes get two FPGA instances at 100 free. Of the GPU pods
    (gpu_pods bool[P]) AUX_GPU_POD_FRAC also ask for RDMA (100, 50 or 25),
    AUX_RDMA_ALONE_FRAC of the others for RDMA alone (25-100) and
    AUX_FPGA_POD_FRAC of the rest for FPGA 100; AUX_TOO_BIG_FRAC of each
    kind ask for AUX_TOO_BIG_REQ, more than any instance holds.
    aux_req's columns are the RDMA and FPGA requests; aux_alloc is each
    node's RDMA and FPGA allocatable (100 a valid instance, as the device
    plugin reports it and the reference's SnapshotBuilder merges it) and
    aux_used what running pods hold of it (100 less each valid
    instance's free). Numpy arrays, so that a test applies the same ones
    to the reference's inputs."""
    rng = np.random.default_rng(seed)
    n, p, j = gpu_nodes.shape[0], gpu_pods.shape[0], AUX_INSTANCES
    levels = np.asarray(AUX_FREE_LEVELS, np.float32)
    free = np.zeros((n, NUM_AUX_TYPES, j), np.float32)
    valid = np.zeros((n, NUM_AUX_TYPES, j), bool)
    other = ~gpu_nodes & (rng.uniform(size=n) < AUX_OTHER_NODE_FRAC)
    fpga = rng.uniform(size=n) < AUX_FPGA_NODE_FRAC
    drawn = rng.choice(levels, size=(n, j))
    valid[gpu_nodes, 0] = True
    valid[other, 0, :2] = True
    free[:, 0] = np.where(valid[:, 0], drawn, np.float32(0.0))
    valid[fpga, 1, :2] = True
    free[fpga, 1, :2] = 100.0
    req = np.zeros((p, NUM_AUX_TYPES), np.float32)
    u = rng.uniform(size=(p, 3))
    with_gpu = gpu_pods & (u[:, 0] < AUX_GPU_POD_FRAC)
    alone = ~gpu_pods & (u[:, 1] < AUX_RDMA_ALONE_FRAC)
    fpga_pod = ~gpu_pods & ~alone & (u[:, 2] < AUX_FPGA_POD_FRAC)
    req[with_gpu, 0] = rng.choice(np.asarray(AUX_GPU_POD_REQ, np.float32),
                                  size=int(with_gpu.sum()))
    req[alone, 0] = rng.choice(np.asarray(AUX_RDMA_ALONE_REQ, np.float32),
                               size=int(alone.sum()))
    req[fpga_pod, 1] = 100.0
    big = rng.uniform(size=p) < AUX_TOO_BIG_FRAC
    for kind, col in ((with_gpu, 0), (alone, 0), (fpga_pod, 1)):
        req[kind & big, col] = AUX_TOO_BIG_REQ
    alloc = (valid.sum(axis=2) * 100.0).astype(np.float32)
    used = (alloc - (free * valid).sum(axis=2)).astype(np.float32)
    return free, valid, req, alloc, used


def with_aux_pools(snap: ClusterSnapshot, pods: PodBatch, seed: int = 11
                   ) -> Tuple[ClusterSnapshot, PodBatch]:
    """`snap` and `pods` with `aux_pools`' pools, the nodes' RDMA and
    FPGA allocatable and use, and the pods' requests (the GPU nodes:
    those with a valid GPU instance; the GPU pods: those asking for a GPU
    resource)."""
    dev = snap.nodes.allocatable.device
    gpu_nodes = snap.devices.gpu_valid.any(dim=1).cpu().numpy()
    gpu_pods = has_gpu_request(pods.requests, pods.gpu_ratio).cpu().numpy()
    free, valid, req, alloc, used = aux_pools(gpu_nodes, gpu_pods, seed)
    kinds = list(AUX_KINDS)
    requests = pods.requests.clone()
    requests[:, kinds] = torch.from_numpy(req).to(dev)
    allocatable = snap.nodes.allocatable.clone()
    allocatable[:, kinds] = torch.from_numpy(alloc).to(dev)
    requested = snap.nodes.requested.clone()
    requested[:, kinds] = torch.from_numpy(used).to(dev)
    return (snap.replace(
                nodes=snap.nodes.replace(allocatable=allocatable,
                                         requested=requested),
                devices=snap.devices.replace(
                    aux_free=torch.from_numpy(free).to(dev),
                    aux_valid=torch.from_numpy(valid).to(dev))),
            pods.replace(requests=requests))


def aux_no_fit(snap: ClusterSnapshot, pods: PodBatch) -> Dict[str, int]:
    """{kind: pods}: the aux pods of each kind (GPU with RDMA, RDMA
    alone, FPGA) that no node's batch-start pools fit, one instance a
    request (the prefilter's aux part over every node)."""
    free = snap.devices.aux_free.cpu()
    valid = snap.devices.aux_valid.cpu()
    gpu = has_gpu_request(pods.requests, pods.gpu_ratio).cpu()
    out = {}
    for name, t, kind in (("gpu_rdma", 0, gpu), ("rdma", 0, ~gpu),
                          ("fpga", 1, None)):
        req = pods.requests[:, AUX_KINDS[t]].cpu()
        ask = req > 0 if kind is None else (req > 0) & kind
        best = torch.where(valid[:, t], free[:, t], -torch.inf).max()
        out[name] = int((ask & (best + 0.5 < req)).sum())
    return out


def aux_full_gate_inputs(num_pods: int = 100_000, num_nodes: int = 10_000,
                         device="cuda") -> Tuple[ClusterSnapshot, PodBatch]:
    """`gpu_share_inputs` with `with_aux_pools`: the full gate's workload
    on a cluster whose GPU nodes carry RDMA VFs beside their GPUs, a few
    nodes FPGAs, and pods that ask for them."""
    snap, pods = gpu_share_inputs(num_pods, num_nodes, device=device)
    return with_aux_pools(snap, pods)


def full_gate_reservations(num_nodes: int) -> int:
    """The live-slot count full_gate_cluster and full_gate_pods share
    (owner ids line up with the slots' owner groups)."""
    return min(64, num_nodes // 2)


# the reference full_gate_cluster's and full_gate_pods' defaults
FULL_GATE_CLUSTER_KW = dict(num_quotas=32, max_quotas=64, num_gangs=64,
                            max_gangs=64, gpu_node_frac=0.25,
                            gpus_per_node=8)
FULL_GATE_PODS_KW = dict(num_quotas=32, num_gangs=64, gang_min_member=8,
                         gpu_pod_frac=0.1)
NUMA_BIND_FRAC = 0.33
# its topology groups: zone spread groups (each with a hostname
# companion), their zone count and skew, the spread share of the pods,
# and the (groups, members) of anti-affinity and affinity
N_SPREAD_GROUPS, NUM_ZONES, SPREAD_FRAC, MAX_SKEW = 8, 16, 0.15, 64.0
ANTI_GROUPS, ANTI_MEMBERS = 16, 64
AFF_GROUPS, AFF_MEMBERS = 8, 48


def full_gate_cluster(num_nodes: int, seed: int = 0,
                      device="cuda") -> ClusterSnapshot:
    """The full-gate flagship cluster: `synthetic_cluster` with
    FULL_GATE_CLUSTER_KW (a quarter GPU nodes) and
    full_gate_reservations(num_nodes) live reservation slots, two
    populated NUMA zones a node, and three taint classes (0 untainted,
    1 dedicated, 2 GPU-exclusive; p = 0.8 / 0.15 / 0.05, drawn from
    their own generator, seed + 17)."""
    snap = with_two_numa_zones(synthetic_cluster(
        num_nodes, seed=seed,
        num_reservations=full_gate_reservations(num_nodes), device=device,
        **FULL_GATE_CLUSTER_KW))
    taint_group = np.random.default_rng(seed + 17).choice(
        3, num_nodes, p=[0.8, 0.15, 0.05]).astype(np.int32)
    return snap.replace(nodes=snap.nodes.replace(
        taint_group=torch.from_numpy(taint_group).to(
            snap.nodes.allocatable.device)))


def _topology_groups(rng: np.random.Generator, p: int,
                     num_nodes: int) -> dict:
    """The reference full_gate_pods' pod topology fields
    (utils/synthetic.py:439-529), drawn from `rng` in its order.

    Spread: every spread pod (SPREAD_FRAC of them) carries and matches a
    zone group g < N_SPREAD_GROUPS (NUM_ZONES domains, node n in zone
    n % NUM_ZONES, skew MAX_SKEW) and its hostname companion
    g + N_SPREAD_GROUPS (one domain a node, a loose skew). Anti-affinity:
    ANTI_GROUPS hostname groups of ANTI_MEMBERS pods, each member its
    group's carrier. Affinity: AFF_GROUPS zone groups of AFF_MEMBERS
    pods, disjoint from the anti pods; every member of an odd group also
    carries and matches its even partner. Member counts scale down with
    small batches, as the reference's do."""
    f32 = np.float32
    zone_of_node = (np.arange(num_nodes) % NUM_ZONES).astype(np.int32)
    host_of_node = np.arange(num_nodes, dtype=np.int32)
    n_sg = 2 * N_SPREAD_GROUPS
    spread_domain = np.empty((n_sg, num_nodes), np.int32)
    spread_domain[:N_SPREAD_GROUPS] = zone_of_node
    spread_domain[N_SPREAD_GROUPS:] = host_of_node
    in_spread = rng.uniform(size=p) < SPREAD_FRAC
    sgrp = rng.integers(0, N_SPREAD_GROUPS, p).astype(np.int32)
    spread_member = np.zeros((p, n_sg), bool)
    rows = np.flatnonzero(in_spread)
    spread_member[rows, sgrp[in_spread]] = True
    spread_member[rows, sgrp[in_spread] + N_SPREAD_GROUPS] = True
    d_cap = max(NUM_ZONES, num_nodes)
    spread_dvalid = np.zeros((n_sg, d_cap), bool)
    spread_dvalid[:N_SPREAD_GROUPS, :NUM_ZONES] = True
    spread_dvalid[N_SPREAD_GROUPS:, :num_nodes] = True
    host_skew = max(float(np.ceil(p * SPREAD_FRAC / N_SPREAD_GROUPS
                                  / max(num_nodes, 1))) + 3.0, 4.0)

    anti_members = max(min(ANTI_MEMBERS, p // (4 * ANTI_GROUPS)), 1)
    aff_members = max(min(AFF_MEMBERS, p // (4 * AFF_GROUPS)), 1)
    total_anti = ANTI_GROUPS * anti_members
    total_aff = AFF_GROUPS * aff_members
    if total_anti + total_aff > p:
        raise ValueError(
            f"full_gate_pods needs at least {ANTI_GROUPS + AFF_GROUPS}"
            f" pods for {ANTI_GROUPS} anti + {AFF_GROUPS} affinity "
            f"groups; got {p}")
    anti_id = np.full((p,), -1, np.int32)
    anti_member = np.zeros((p, ANTI_GROUPS), bool)
    a_idx = rng.choice(p, total_anti, replace=False)
    a_grp = np.repeat(np.arange(ANTI_GROUPS, dtype=np.int32), anti_members)
    anti_id[a_idx] = a_grp
    anti_member[a_idx, a_grp] = True

    aff_id = np.full((p,), -1, np.int32)
    aff_member = np.zeros((p, AFF_GROUPS), bool)
    f_idx = rng.choice(np.setdiff1d(np.arange(p), a_idx), total_aff,
                       replace=False)
    f_grp = np.repeat(np.arange(AFF_GROUPS, dtype=np.int32), aff_members)
    aff_id[f_idx] = f_grp
    aff_member[f_idx, f_grp] = True
    for g in range(1, AFF_GROUPS, 2):
        aff_member[f_idx[f_grp == g], g - 1] = True

    return dict(
        spread_id=np.where(in_spread, sgrp, -1).astype(np.int32),
        spread_carrier=spread_member.copy(), spread_member=spread_member,
        spread_max_skew=np.concatenate([
            np.full((N_SPREAD_GROUPS,), MAX_SKEW, f32),
            np.full((N_SPREAD_GROUPS,), host_skew, f32)]),
        spread_domain=spread_domain,
        spread_count0=np.zeros((n_sg, d_cap), f32),
        spread_dvalid=spread_dvalid,
        anti_id=anti_id, anti_member=anti_member,
        anti_carrier=anti_member.copy(),
        anti_domain=np.broadcast_to(
            host_of_node, (ANTI_GROUPS, num_nodes)).copy(),
        anti_count0=np.zeros((ANTI_GROUPS, num_nodes), f32),
        anti_carrier_count0=np.zeros((ANTI_GROUPS, num_nodes), f32),
        aff_id=aff_id, aff_carrier=aff_member.copy(), aff_member=aff_member,
        aff_domain=np.broadcast_to(
            zone_of_node, (AFF_GROUPS, num_nodes)).copy(),
        aff_count0=np.zeros((AFF_GROUPS, NUM_ZONES), f32))


def full_gate_pods(num_pods: int, num_nodes: int, seed: int = 1,
                   device="cuda") -> PodBatch:
    """The full-gate flagship's pods: `synthetic_pods` with
    FULL_GATE_PODS_KW (10 % GPU pods), then on one generator (seed + 29)
    in the reference's order: NUMA_BIND_FRAC of the prod pods
    single-NUMA bound, three toleration sets (p = 0.7 / 0.2 / 0.1; set 0
    tolerates nothing, set 1 the dedicated class, set 2 both; the
    dedicated and the GPU-exclusive class also carry a PreferNoSchedule
    taint for the sets that do not tolerate them), the spread,
    anti-affinity and affinity groups (`_topology_groups`), and two
    owners for each of the full_gate_reservations(num_nodes) slots among
    the pods that fit a slot's hold (no batch-tier, device or
    single-NUMA pod). has_taints, has_spread, has_anti and has_aff are
    True."""
    pods = synthetic_pods(num_pods, seed=seed, device="cpu",
                          **FULL_GATE_PODS_KW)
    rng = np.random.default_rng(seed + 29)
    p = num_pods
    requests = pods.requests.numpy()
    is_prod = pods.priority_class.numpy() == int(PriorityClass.PROD)
    numa_single = is_prod & (rng.uniform(size=p) < NUMA_BIND_FRAC)
    toleration_id = rng.choice(3, p, p=[0.7, 0.2, 0.1]).astype(np.int32)
    tol_forbid = np.array([[False, True, True],
                           [False, False, True],
                           [False, False, False]])
    tol_prefer = np.array([[0.0, 1.0, 1.0],
                           [0.0, 0.0, 1.0],
                           [0.0, 0.0, 0.0]], np.float32)
    topo = _topology_groups(rng, p, num_nodes)
    v = full_gate_reservations(num_nodes)
    owner = np.full((p,), -1, np.int32)
    if v:
        slot_free = np.zeros((R,), np.float32)
        slot_free[CPU], slot_free[MEM] = RESV_SLOT_CPU, RESV_SLOT_MEM
        fits_slot = (requests <= slot_free[None, :]).all(axis=1)
        device_req = has_device_request(pods.requests, pods.gpu_ratio).numpy()
        plain = np.flatnonzero(fits_slot & ~device_req & ~numa_single)
        owners = rng.choice(plain, min(2 * v, plain.size), replace=False)
        owner[owners] = (np.arange(owners.size) % v).astype(np.int32)
    return pods.replace(
        numa_single=torch.from_numpy(numa_single),
        reservation_owner=torch.from_numpy(owner),
        toleration_id=torch.from_numpy(toleration_id),
        tol_forbid=torch.from_numpy(tol_forbid),
        tol_prefer=torch.from_numpy(tol_prefer),
        **{f: torch.from_numpy(x) for f, x in topo.items()},
        has_taints=True, has_spread=True, has_anti=True,
        has_aff=True).to(resolve_device(device))


def gpu_share_inputs(num_pods: int = 100_000, num_nodes: int = 10_000,
                     device="cuda") -> Tuple[ClusterSnapshot, PodBatch]:
    """The reference's full-gate flagship workload (`full_gate_cluster`
    and `full_gate_pods`, seeds 0 and 1):
    10 000 nodes with 32 quotas, 64 gangs, a quarter of them GPU nodes
    with 8 instances each, two populated NUMA zones, three taint classes
    and 64 live reservation slots; 100 000 pods with 32 quotas, 64 gangs
    of 8, 10 % GPU pods, a third of the prod pods single-NUMA bound,
    three toleration sets, two owners a slot, 16 spread groups (8 zone
    groups, each with a hostname companion), 16 hostname anti-affinity
    groups and 8 zone affinity groups. The one cut, the cascade, is a
    knob of the run."""
    snap = full_gate_cluster(num_nodes, seed=0, device=device)
    pods = full_gate_pods(num_pods, num_nodes, seed=1, device=device)
    return snap, pods


# --- delta inputs of the guarded cycle --------------------------------------


def _delta_rows_idx(snap: ClusterSnapshot, k: int,
                    rng: np.random.Generator) -> np.ndarray:
    """k distinct node rows, in ascending order, none hosting a
    reservation slot (the reference's builder sends those through a
    full rebuild)."""
    resv = snap.reservations
    hosts = resv.node[resv.valid].cpu().numpy()
    eligible = np.setdiff1d(np.arange(snap.num_nodes), hosts)
    return np.sort(rng.choice(eligible, size=k, replace=False)).astype(
        np.int32)


def _host_rows(struct, fields, idx: np.ndarray) -> dict:
    return {f: getattr(struct, f).cpu().numpy()[idx] for f in fields}


def _tensors(arrays: dict) -> dict:
    return {f: torch.from_numpy(np.ascontiguousarray(v))
            for f, v in arrays.items()}


def metric_delta_rows(snap: ClusterSnapshot, k: int, seed: int,
                      version: int):
    """A NodeMetricDelta of k distinct node rows (no slot host) at
    source_version `version`, on the host: fresh usage drawn as
    `synthetic_cluster` draws it (cpu uniform(0, 0.6), memory
    uniform(0.1, 0.7) of the row's allocatable; prod 0.8 of it; the
    aggregates with p90 and above 1.15 of it), the assigned columns as
    the snapshot holds them."""
    from koordinator_tpu_torch.snapshot.delta import (
        METRIC_FIELDS,
        NodeMetricDelta,
    )

    rng = np.random.default_rng(seed)
    idx = _delta_rows_idx(snap, k, rng)
    alloc = snap.nodes.allocatable.cpu().numpy()[idx]
    rows = _host_rows(snap.nodes, METRIC_FIELDS, idx)
    usage = np.zeros((k, R), np.float32)
    usage[:, CPU] = (rng.uniform(0.0, 0.6, k) * alloc[:, CPU]).astype(
        np.float32)
    usage[:, MEM] = (rng.uniform(0.1, 0.7, k) * alloc[:, MEM]).astype(
        np.float32)
    agg = np.zeros((k, NUM_AGG, R), np.float32)
    agg[:] = usage[:, None, :]
    agg[:, 2:] *= 1.15
    rows.update(usage=usage, prod_usage=usage * 0.8, agg_usage=agg,
                metric_fresh=np.ones((k,), bool), has_agg=np.ones((k,), bool))
    return NodeMetricDelta(
        idx=torch.from_numpy(idx), **_tensors(rows),
        source_version=torch.tensor(version, dtype=torch.int32))


def topology_delta_rows(snap: ClusterSnapshot, k: int, seed: int,
                        version: int):
    """A NodeTopologyDelta of k distinct node rows (no slot host) at
    source_version `version`, on the host. About half (uniform < 0.5)
    are removed nodes: zeroed rows (schedulable False, allocatable,
    requested, zones and instances 0, invalid zones and instances,
    instance zone and PCIe -1, amplification 1, metric_fresh False).
    The rest keep their row with a new taint group and label group,
    each drawn among the groups the snapshot already uses."""
    from koordinator_tpu_torch.snapshot.delta import (
        METRIC_FIELDS,
        TOPOLOGY_DEVICE_FIELDS,
        TOPOLOGY_NODE_FIELDS,
        NodeMetricDelta,
        NodeTopologyDelta,
    )

    rng = np.random.default_rng(seed)
    idx = _delta_rows_idx(snap, k, rng)
    removed = rng.uniform(size=k) < 0.5
    nodes = snap.nodes
    n_taint = int(nodes.taint_group.max()) + 1
    n_label = int(nodes.label_group.max()) + 1
    rows = _host_rows(nodes, TOPOLOGY_NODE_FIELDS, idx)
    rows.update(_host_rows(snap.devices, TOPOLOGY_DEVICE_FIELDS, idx))
    rows["taint_group"] = rng.integers(0, n_taint, k).astype(np.int32)
    rows["label_group"] = rng.integers(0, n_label, k).astype(np.int32)
    metric = _host_rows(nodes, METRIC_FIELDS, idx)
    fill = {"cpu_amplification": 1.0, "gpu_numa": -1, "gpu_pcie": -1}
    for table in (rows, metric):
        for f, v in table.items():
            v[removed] = fill.get(f, 0)
    return NodeTopologyDelta(
        idx=torch.from_numpy(idx), **_tensors(rows),
        metric=NodeMetricDelta(idx=torch.from_numpy(idx.copy()),
                               **_tensors(metric)),
        source_version=torch.tensor(version, dtype=torch.int32))


CONFIG_5_NOW = 1e9


def config_5_cluster(num_nodes: int = 10_000, every_node: bool = False):
    """BASELINE config 5 (bench_configs.py:159-183): `num_nodes` nodes of
    64 000 mC and 262 144 MiB, each at usage `uniform(0.1, 0.95)` of both
    (one draw of `num_nodes` from `default_rng(3)`), reported at
    `CONFIG_5_NOW`; every node above 0.7 carries 4 BE pods of 4000 mC and 8192
    MiB (priority 5500, namespace "default", no pod metrics, so their
    usage falls back to their requests). With `every_node` every node
    lists its 4 pods, as a descheduler sees a cluster it lists whole
    (4 * num_nodes pods; the plan moves only the hot nodes' ones).
    Returns (nodes, metrics by node name, pods by node name) as
    `api.types` objects."""
    from koordinator_tpu_torch.api import types as api

    rng = np.random.default_rng(3)
    nodes, metrics, pods_by_node = [], {}, {}
    usage_frac = rng.uniform(0.1, 0.95, size=num_nodes)
    for i in range(num_nodes):
        name = f"n{i}"
        nodes.append(api.Node(meta=api.ObjectMeta(name=name),
                              allocatable={ResourceKind.CPU: 64000.0,
                                           ResourceKind.MEMORY: 262144.0}))
        metrics[name] = api.NodeMetric(
            node_name=name, update_time=CONFIG_5_NOW,
            node_usage={ResourceKind.CPU: 64000.0 * usage_frac[i],
                        ResourceKind.MEMORY: 262144.0 * usage_frac[i]})
        if every_node or usage_frac[i] > 0.7:
            pods_by_node[name] = [
                api.Pod(meta=api.ObjectMeta(name=f"{name}-p{j}",
                                            uid=f"{name}-p{j}"),
                        priority=5500, qos_label="BE", node_name=name,
                        requests={ResourceKind.CPU: 4000.0,
                                  ResourceKind.MEMORY: 8192.0})
                for j in range(4)]
    return nodes, metrics, pods_by_node


# node_resource_10k: koord-manager's view of a colocation cluster
NODE_RESOURCE_NOW = 1.7e9
NODE_RESOURCE_SYNC_S = 60.0        # one metric sync round
# (priority class, share of the pods, the band's lowest priority)
NODE_RESOURCE_CLASSES = ((PriorityClass.PROD, 0.45, 9000),
                         (PriorityClass.MID, 0.10, 7000),
                         (PriorityClass.BATCH, 0.35, 5000),
                         (PriorityClass.FREE, 0.10, 3000))
NODE_RESOURCE_POOL_LABEL = "colocation-pool"
# the per-node strategy overrides: pool label value -> strategy fields
NODE_RESOURCE_POOLS = (
    ("mem-request", {"memory_calculate_policy": "request"}),
    ("mem-max-usage-request", {"memory_calculate_policy": "maxUsageRequest"}),
    ("cpu-max-usage-request", {"cpu_calculate_policy": "maxUsageRequest"}),
)


def node_resource_cluster(num_nodes: int = 10_000, pods_per_node: int = 30,
                          seed: int = 0) -> dict:
    """node_resource_10k's cluster as `api.types` objects: {"nodes",
    "metrics" (by node name), "pods_by_node", "node_reservations",
    "config" (a ColocationConfig), "now", "drifted" (the metrics one
    sync round later), "drift_now"}.

    Nodes carry the allocatable (cpu, memory) of `synthetic_cluster(
    num_nodes, seed=0)` and a kubelet reservation (2 % of the cpu, 2048
    MiB); 10 % of them a pool label whose override computes memory by
    request or by maxUsageRequest, or cpu by maxUsageRequest. Each node
    lists `pods_per_node` Running (95 %) or Pending pods: 45 % prod, 10 %
    mid, 35 % batch, 10 % free (batch and free pods ask for batch
    resources); 5 % of the prod and mid (HP) pods are LSE, the rest LS;
    10 % of the HP pods have no pod metric, the others report a usage of
    0.2-1.2x their request. NodeMetrics report system usage and the
    prod-reclaimable prediction; 2 % of the nodes report one dangling
    pod metric (a prod pod no longer listed), 0.2 % a NaN system cpu
    usage, 3 % a metric older than the default degrade time (15
    minutes) and 1 % none. `drifted`: every reported node one sync round
    later, half of them with 5 % more pod and system usage."""
    from koordinator_tpu_torch.api import types as api
    from koordinator_tpu_torch.slo_controller.config import (
        CalculatePolicy,
        ColocationConfig,
        ColocationStrategy,
        ColocationStrategyOverride,
    )

    n, per = num_nodes, pods_per_node
    alloc = synthetic_cluster(n, seed=0, device="cpu").nodes.allocatable[
        :, [CPU, MEM]].numpy().astype(np.float64)
    rng = np.random.default_rng(seed + 17)
    pool = np.where(rng.uniform(size=n) < 0.1,
                    rng.integers(0, len(NODE_RESOURCE_POOLS), n), -1)
    sys_use = alloc * np.stack([rng.uniform(0.01, 0.06, n),
                                rng.uniform(0.02, 0.08, n)], axis=1)
    reclaim = alloc * np.stack([rng.uniform(0.0, 0.25, n),
                                rng.uniform(0.0, 0.2, n)], axis=1)
    state = rng.uniform(size=n)          # < 0.01 none, < 0.04 stale
    age = np.where(state < 0.04, rng.uniform(15 * 60.0, 3600.0, n),
                   rng.uniform(0.0, 120.0, n))
    dangling = rng.uniform(size=n) < 0.02
    nan_cpu = rng.uniform(size=n) < 0.002
    drift = rng.uniform(size=n) < 0.5
    p = n * per
    cls = rng.choice(len(NODE_RESOURCE_CLASSES), p,
                     p=[c[1] for c in NODE_RESOURCE_CLASSES])
    prio = np.array([c[2] for c in NODE_RESOURCE_CLASSES])[cls] \
        + rng.integers(0, 1000, p)
    running = rng.uniform(size=p) < 0.95
    req = np.stack([rng.integers(1, 9, p) * 250.0,
                    rng.integers(1, 17, p) * 256.0], axis=1)
    hp = cls < 2
    lse = hp & (rng.uniform(size=p) < 0.05)
    metered = ~(hp & (rng.uniform(size=p) < 0.1))
    use = req * rng.uniform(0.2, 1.2, size=(p, 2))
    ghost = alloc * 0.02

    config = ColocationConfig(
        cluster_strategy=ColocationStrategy(enable=True),
        node_overrides=[ColocationStrategyOverride(
            node_selector={NODE_RESOURCE_POOL_LABEL: name},
            fields={k: CalculatePolicy(v) for k, v in fields.items()})
            for name, fields in NODE_RESOURCE_POOLS])
    rk_cpu, rk_mem = ResourceKind.CPU, ResourceKind.MEMORY
    nodes, reservations, pods_by_node = [], {}, {}
    metrics, drifted = {}, {}
    for i in range(n):
        name = f"node-{i:05d}"
        labels = ({NODE_RESOURCE_POOL_LABEL: NODE_RESOURCE_POOLS[pool[i]][0]}
                  if pool[i] >= 0 else {})
        nodes.append(api.Node(meta=api.ObjectMeta(name=name, labels=labels),
                              allocatable={rk_cpu: float(alloc[i, 0]),
                                           rk_mem: float(alloc[i, 1])}))
        reservations[name] = {rk_cpu: float(np.floor(alloc[i, 0] * 0.02)),
                              rk_mem: 2048.0}
        pods, infos = [], []
        for j in range(i * per, (i + 1) * per):
            pc = NODE_RESOURCE_CLASSES[cls[j]][0]
            kinds = (rk_cpu, rk_mem) if hp[j] else (ResourceKind.BATCH_CPU,
                                                    ResourceKind.BATCH_MEMORY)
            meta = api.ObjectMeta(name=f"pod-{j}", namespace=f"ns-{j % 50}")
            pods.append(api.Pod(
                meta=meta, priority=int(prio[j]), node_name=name,
                phase="Running" if running[j] else "Pending",
                qos_label="LSE" if lse[j] else "LS" if hp[j] else "BE",
                requests={kinds[0]: float(req[j, 0]),
                          kinds[1]: float(req[j, 1])}))
            if metered[j]:
                infos.append((meta.namespace, meta.name, pc, use[j]))
        if dangling[i]:
            infos.append(("ns-ghost", f"gone-{i}", PriorityClass.PROD,
                          ghost[i]))
        pods_by_node[name] = pods
        if state[i] < 0.01:
            continue

        def report(scale, sync):
            sys_cpu = np.nan if nan_cpu[i] else float(sys_use[i, 0] * scale)
            return api.NodeMetric(
                node_name=name,
                update_time=NODE_RESOURCE_NOW - age[i] + sync,
                system_usage={rk_cpu: sys_cpu,
                              rk_mem: float(sys_use[i, 1] * scale)},
                pods_metric=[api.PodMetricInfo(
                    namespace=ns, name=pn, priority_class=pc,
                    usage={rk_cpu: float(u[0] * scale),
                           rk_mem: float(u[1] * scale)})
                    for ns, pn, pc, u in infos],
                prod_reclaimable={rk_cpu: float(reclaim[i, 0]),
                                  rk_mem: float(reclaim[i, 1])})
        metrics[name] = report(1.0, 0.0)
        stale = state[i] < 0.04
        drifted[name] = (metrics[name] if stale else
                         report(1.05 if drift[i] else 1.0,
                                NODE_RESOURCE_SYNC_S))
    return {"nodes": nodes, "metrics": metrics, "pods_by_node": pods_by_node,
            "node_reservations": reservations, "config": config,
            "now": NODE_RESOURCE_NOW, "drifted": drifted,
            "drift_now": NODE_RESOURCE_NOW + NODE_RESOURCE_SYNC_S}
