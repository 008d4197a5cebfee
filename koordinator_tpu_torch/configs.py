"""Configurations beside the slim flagship.

`run_config_2_numa` is the counterpart of `bench_configs.config_2_numa`
in the JAX package (BASELINE.json configs[1]): 10 000 pods against
1000 nodes with LoadAware and NodeNUMAResource Filter/Score. Nodes
carry two populated NUMA zones, 60 % of the pods are prod and every
prod pod is single-NUMA bound. The pods run in chunks of 2000 through
`schedule_batch(enable_numa=True)` with the bench's knobs (2 rounds,
8 choices, score dims cpu and memory, fit dims 0-3, 2 quota levels,
tie-break on, cascade off, NUMA strategy "most"), each chunk on the previous one's snapshot;
there is no straggler tail. The reference scans the chunks on device;
here they are a Python loop.

`run_config_4_quota` is BASELINE config 4 (`bench_configs.config_4_quota`,
:131-141, through `_run_scheduler_config`, :48-81): 50 000 pods against
5000 nodes under a tree of 500 quotas (a table of 512), in chunks of
2500 through `schedule_batch` with the bench's knobs and NUMA off
(`CONFIG_4_KW`), each chunk on the previous one's snapshot, exact
top-k, no tail. A chunk of 2500 is above one block of K2 (2048): its
steps take K2's tiled walk.

`run_gpu_share` (`gpu_share_100kx10k`) is the reference's full-gate
flagship (bench.py:226-250 knobs, :398-470 sweep and tail, :84-89 tail
passes; utils/synthetic.py:369-554 full_gate_cluster and
full_gate_pods): 100 000 pods against 10 000 nodes, a quarter of the
nodes with 8 A100-like GPU instances split over their two NUMA zones,
three taint classes on the nodes and three toleration sets on the pods,
64 live reservation slots with two owners each (half of them
AllocateOnce), 10 % GPU pods (shared half-GPUs, whole GPUs, 2- and
4-GPU trainers), a third of the prod pods single-NUMA bound, 32 quotas,
64 gangs of 8, 15 % spread pods (8 zone groups over 16 zones with skew
64, each with a hostname companion group of loose skew), 16 hostname
anti-affinity groups of 64 and 8 zone affinity groups of 48 (in dual
pairs). It runs the DeviceShare path with NodeNUMAResource (NUMA
strategy "most", device strategy "least"), the taint gate and penalty,
the slot columns and the three pod topology families at full width (no
packing prefixes, singleton domain classes), chunks of 2000 with the
bench's knobs, the topology counts threaded from chunk to chunk, then
the straggler tail (4 rounds x 32 choices, windows of 512, 2 to 10
passes). It is the full-gate workload unpacked and with the cascade off
(`GPU_SHARE_CUTS`): the cascade and the packing prefixes live in
`run_full_gate`.

`run_full_gate` (`score_bind_100k_pods_10k_nodes_full_gate`) is the
reference's full-gate flagship uncut (bench.py:226-253, :346-355,
:398-416, :483-496): gpu_share's cluster and pods, the pods packed by
`utils.synthetic.pack_gate_prefixes` into nested prefixes of each chunk
of 2000 (topology, CPU-bind, device pods), the snapshot checked free of
topology-manager policies, `dom_classes` derived from the domain maps,
and the sweep run with the cascade on and the three prefixes
(`FULL_GATE_KW`); the tail keeps the cascade, the topology prefix and
the domain classes but not the numa and gpu prefixes (a retry window
is not packed), and budgets its constrained stragglers by the topology
prefix. With `amplified` it runs the same on a cluster whose node
webhook amplified the CPU of about 30 % of the nodes
(`utils.synthetic.amplified_full_gate_inputs`) and with
`enable_amplification` on (`full_gate_amplified_100kx10k`). With `aux`
it runs the same on a cluster whose GPU nodes carry 8 RDMA VFs each, a
tenth of the others two and 2 % of all nodes two FPGAs, with 60 % of
the GPU pods, 1 % of the others and 0.2 % asking for them
(`utils.synthetic.aux_full_gate_inputs`, `full_gate_aux_100kx10k`).

`run_config_1_spark` and `run_config_3_gangs` are BASELINE configs 1
and 3 (`bench_configs.config_1_spark`, :84-93, and `config_3_gangs`,
:116-129, through `_run_scheduler_config`): 32 BE pods against 10 nodes
in one chunk of 32, and 1000 strict gangs of 8 against 5000 nodes
(a gang table of 1024) in chunks of 2000, both with config 4's knobs
(NUMA off, exact top-k, no tail).

`run_guarded_cycles` (`guarded_cycles_10k`) is the service's inner
cycle without the service (frameworkext.py:624-1267: the store, the
guarded batch, the store update, forget on failed binds): the full
gate's first ten packed chunks of 2000 against 10 000 nodes through a
`SnapshotStore` that takes a metric delta of 1000 rows, a duplicate and
a stale re-stamp of it (both refused) and a topology delta of 64 rows,
then `guards.guarded_schedule_batch` a batch, eight of them each with
one column fault (`testing.faults`), each result published and 5 % of
the batch forgotten, and at the end a checkpoint restored into a fresh
store (`guarded_cycle_inputs` and `guarded_cycle` are its set-up and
its timed steps).

`run_config_4_fair_share` (`config_4_fair_share_500q_50k`) is BASELINE
config 4 with its ElasticQuota fair share (GroupQuotaManager's
pending-demand fold and water-fill, composed as
tests/test_waterfill.py:195-240 composes them): config 4's nodes and
pods with the quota table rebuilt as a contended four-level tree of
500 quotas (`utils.synthetic.fair_share_tree`); the whole pending queue
folded into the leaves' demand (`ops.quota_demand.add_pending_demand`,
K3), the forest's runtime solved once (`ops.waterfill`, K18), then
config 4's chunked sweep with four quota levels gated
(`FAIR_SHARE_KW`).

`run_node_resource` (`node_resource_10k`) is koord-manager's
NodeResourceController (`slo_controller.noderesource`): the batch and
mid overcommit of 10 000 nodes from their NodeMetrics and pods
(`utils.synthetic.node_resource_cluster`), two reconciles a metric
sync round apart, the second after a usage drift.

`run_config_5_descheduler` is BASELINE config 5
(`bench_configs.config_5_descheduler`, :144-200): koord-descheduler's
LowNodeLoad balance plan over 10 000 nodes (`config_5_cluster`), about
11 800 evictable pods on the hot nodes, `consecutive_abnormalities=1`
and the reference's defaults otherwise (low 45/60, high 65/80, weights
1/1, node_fit on), through `DeviceLowNodeLoad.balance_once` with a
`RecordingEvictor`: plain (no caps: K10, K11, K12) or capped
(`EvictionLimiter(max_per_cycle=4000, max_per_node=2,
max_per_namespace=2000)`: K10, K11, K13). With `every_node` the
cluster lists 4 pods on every node (40 000 pods at 10 000 nodes,
`..._every_node`), above the 16 384 that K11 and K12 hold in shared
memory.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.api.extension import AUX_KINDS, ResourceKind
from koordinator_tpu_torch.flagship import FlagshipRun, sweep_and_tail
from koordinator_tpu_torch.kernels.quota_runtime import quota_runtime
from koordinator_tpu_torch.ops.quota_demand import add_pending_demand
from koordinator_tpu_torch.ops.waterfill import quota_depth
from koordinator_tpu_torch.scheduler.core import schedule_batch
from koordinator_tpu_torch.scheduler.domains import (
    COUNT_FIELDS,
    batch_counts,
    charge_all_counts,
)
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.snapshot.schema import ClusterSnapshot, PodBatch
from koordinator_tpu_torch.scheduler.plugins.deviceshare import (
    has_gpu_request,
)
from koordinator_tpu_torch.utils.synthetic import (
    CONFIG_5_NOW,
    amplified_full_gate_inputs,
    aux_full_gate_inputs,
    aux_no_fit,
    config_1_inputs,
    config_2_inputs,
    config_3_inputs,
    config_4_inputs,
    config_5_cluster,
    fair_share_inputs,
    node_resource_cluster,
    dom_classes,
    gpu_share_inputs,
    metric_delta_rows,
    pack_gate_prefixes,
    slice_batch,
    topology_delta_rows,
)

CPU, MEM = int(ResourceKind.CPU), int(ResourceKind.MEMORY)

CONFIG_2_METRIC = "baseline_cfg2_numa_10kx1k"
# bench_configs._run_scheduler_config's step
CONFIG_2_KW = dict(num_rounds=2, k_choices=8, score_dims=(0, 1),
                   tie_break=True, quota_depth=2, fit_dims=(0, 1, 2, 3),
                   cascade=False, enable_numa=True, numa_strategy="most")

CONFIG_4_METRIC = "baseline_cfg4_quota_500x50k"
CONFIG_4_KW = dict(num_rounds=2, k_choices=8, score_dims=(0, 1),
                   tie_break=True, quota_depth=2, fit_dims=(0, 1, 2, 3),
                   cascade=False, enable_numa=False)
# configs 1 and 3 run _run_scheduler_config's step with NUMA off, as
# config 4 does
# the fair share's tree has four levels, all gated
FAIR_SHARE_METRIC = "config_4_fair_share_500q_50k"
FAIR_SHARE_KW = dict(CONFIG_4_KW, quota_depth=4)
FAIR_SHARE_LEVELS = 4
CONFIG_1_METRIC, CONFIG_1_CHUNK = "baseline_cfg1_spark_32x10", 32
CONFIG_1_KW = CONFIG_4_KW
CONFIG_3_METRIC = "baseline_cfg3_gangs_1kx8_5k"
CONFIG_3_KW = CONFIG_4_KW
CONFIG_3_GANG_SIZE = 8

GPU_SHARE_METRIC = "gpu_share_100kx10k"
# bench.py's full-gate step unpacked and with the cascade off
GPU_SHARE_KW = dict(num_rounds=2, k_choices=8, score_dims=(0, 1),
                    tie_break=True, quota_depth=2, fit_dims=(0, 1, 2, 3),
                    cascade=False, enable_numa=True, numa_strategy="most",
                    enable_devices=True, device_strategy="least")
GPU_SHARE_TAIL_KW = dict(GPU_SHARE_KW, num_rounds=4, k_choices=32)
GPU_SHARE_CUTS = ("cascade",)
FULL_GATE_MAX_TAIL_PASSES = 10

FULL_GATE_METRIC = "score_bind_100k_pods_10k_nodes_full_gate"
# bench.py's full-gate step (:398-405, cascade on for full gate); the
# prefixes and domain classes come from the packed pods
FULL_GATE_KW = dict(GPU_SHARE_KW, cascade=True)
FULL_GATE_TAIL_KW = dict(FULL_GATE_KW, num_rounds=4, k_choices=32)
FULL_GATE_AMPLIFIED_METRIC = "full_gate_amplified_100kx10k"
FULL_GATE_AUX_METRIC = "full_gate_aux_100kx10k"

NODE_RESOURCE_METRIC = "node_resource_10k"

CONFIG_5_METRIC = "baseline_cfg5_descheduler_10k"
CONFIG_5_CAPPED_METRIC = "baseline_cfg5_descheduler_10k_capped"
# bench_configs.config_5_descheduler's limiter of the capped line
CONFIG_5_CAPS = dict(max_per_cycle=4000, max_per_node=2,
                     max_per_namespace=2000)


@dataclasses.dataclass
class SweepRun:
    snapshot: ClusterSnapshot
    assignment: torch.Tensor     # i32[P] node per pod, -1 = unplaced
    numa_zone: torch.Tensor      # i32[P]
    numa_take: torch.Tensor      # f32[P, Z, 2]


def chunked_sweep(snap: ClusterSnapshot, pods: PodBatch,
                  cfg: LoadAwareConfig, chunk: int,
                  step_kw: dict) -> SweepRun:
    """Schedule `pods` chunk by chunk with `schedule_batch(**step_kw)`,
    each chunk on the previous one's snapshot (bench_configs.
    _run_scheduler_config's sweep, no tail)."""
    num = pods.num_pods
    if num % chunk:
        raise ValueError(f"{num} pods not divisible by chunk {chunk}")
    results = []
    for start in range(0, num, chunk):
        res = schedule_batch(snap, slice_batch(pods, start, chunk), cfg,
                             **step_kw)
        snap = res.snapshot
        results.append(res)
    return SweepRun(snapshot=snap,
                    assignment=torch.cat([r.assignment for r in results]),
                    numa_zone=torch.cat([r.numa_zone for r in results]),
                    numa_take=torch.cat([r.numa_take for r in results]))


def run_config_2_numa(num_pods: int = 10_000, num_nodes: int = 1000,
                      chunk: int = 2000, device="cuda"):
    """Build BASELINE config 2, time one chunked sweep on it, and return
    (line, run): `line` holds the bench line's fields (value = seconds
    of the timed region, which ends with the assignment's readback;
    pods_per_sec, placed, numa_bound_placed) and the device it ran on;
    `run` the final snapshot and the per-pod results. The first call on
    a card also pays the kernels' build unless `kernels.build.
    build_all()` ran before."""
    dev = resolve_device(device)
    snap, pods = config_2_inputs(num_pods, num_nodes, device=dev)
    cfg = LoadAwareConfig.make(device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    run = chunked_sweep(snap, pods, cfg, chunk, CONFIG_2_KW)
    assign = run.assignment.cpu()
    elapsed = time.perf_counter() - t0
    line = {
        "metric": CONFIG_2_METRIC,
        "value": elapsed,
        "pods_per_sec": num_pods / elapsed,
        "placed": int((assign >= 0).sum()),
        "numa_bound_placed": int((run.numa_zone >= 0).sum()),
        "num_pods": num_pods,
        "num_nodes": num_nodes,
        "chunk": chunk,
        "platform": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    return line, run


def _timed_chunked_sweep(metric: str, snap: ClusterSnapshot, pods: PodBatch,
                         chunk: int, step_kw: dict, dev, **extra):
    """Time one `chunked_sweep` of `pods` on `snap` and return (line,
    run): `line` holds the bench line's fields (value = seconds of the
    timed region, which ends with the assignment's readback;
    pods_per_sec, placed, `extra`) and the device it ran on, on a card
    with its name and power limit."""
    cfg = LoadAwareConfig.make(device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    run = chunked_sweep(snap, pods, cfg, chunk, step_kw)
    assign = run.assignment.cpu()
    elapsed = time.perf_counter() - t0
    num_pods = pods.num_pods
    line = {
        "metric": metric,
        "value": elapsed,
        "pods_per_sec": num_pods / elapsed,
        "placed": int((assign >= 0).sum()),
        "num_pods": num_pods,
        "num_nodes": snap.nodes.num_nodes,
        **extra,
        "chunk": chunk,
        "platform": dev.type,
        "device": (card_name_and_power_limit() if dev.type == "cuda"
                   else "cpu"),
    }
    return line, run


def run_config_1_spark(device="cuda"):
    """Build BASELINE config 1 (`config_1_inputs`: 32 BE pods against 10
    nodes), time one chunked sweep on it (`CONFIG_1_KW`, one chunk of
    32), and return (line, run) as `run_config_4_quota` does."""
    dev = resolve_device(device)
    snap, pods = config_1_inputs(device=dev)
    return _timed_chunked_sweep(CONFIG_1_METRIC, snap, pods, CONFIG_1_CHUNK,
                                CONFIG_1_KW, dev)


def run_config_3_gangs(num_gangs: int = 1000, num_nodes: int = 5000,
                       chunk: int = 2000, device="cuda"):
    """Build BASELINE config 3 (`config_3_inputs`: `num_gangs` strict
    gangs of 8 against `num_nodes` nodes), time one chunked sweep on it
    (`CONFIG_3_KW`), and return (line, run) as `run_config_4_quota`
    does; the line also counts the gangs whose every member placed
    (`gangs_placed`) and those with some but not all placed
    (`gangs_partial`, 0 for strict gangs after the rollback)."""
    dev = resolve_device(device)
    snap, pods = config_3_inputs(num_gangs, num_nodes, device=dev)
    line, run = _timed_chunked_sweep(CONFIG_3_METRIC, snap, pods, chunk,
                                     CONFIG_3_KW, dev, num_gangs=num_gangs)
    gang = pods.gang_id.cpu().long()
    placed = (run.assignment.cpu() >= 0).to(torch.int64)
    members = torch.zeros(num_gangs, dtype=torch.int64).index_add_(
        0, gang, placed)
    line["gangs_placed"] = int((members == CONFIG_3_GANG_SIZE).sum())
    line["gangs_partial"] = int(((members > 0)
                                 & (members < CONFIG_3_GANG_SIZE)).sum())
    return line, run


def run_config_4_quota(num_pods: int = 50_000, num_nodes: int = 5000,
                       chunk: int = 2500, num_quotas: int = 500,
                       device="cuda"):
    """Build BASELINE config 4 (`config_4_inputs`), time one chunked
    sweep on it (`CONFIG_4_KW`), and return (line, run): `line` holds
    the bench line's fields (value = seconds of the timed region, which
    ends with the assignment's readback; pods_per_sec, placed) and the
    device it ran on, on a card with its name and power limit; `run`
    the final snapshot and the assignment. The first call on a card also
    pays the kernels' build unless `kernels.build.build_all()` ran
    before."""
    dev = resolve_device(device)
    snap, pods = config_4_inputs(num_pods, num_nodes, num_quotas, device=dev)
    return _timed_chunked_sweep(CONFIG_4_METRIC, snap, pods, chunk,
                                CONFIG_4_KW, dev, num_quotas=num_quotas)


@dataclasses.dataclass
class FairShareRun:
    snapshot: ClusterSnapshot    # after the sweep
    assignment: torch.Tensor     # i32[P]
    quotas: object               # QuotaState: the folded demand, runtime
    limited: torch.Tensor        # f32[Q, R] limited demand
    rounds: torch.Tensor         # i32[6] the water-fill's rounds a level


def run_config_4_fair_share(num_pods: int = 50_000, num_nodes: int = 5000,
                            chunk: int = 2500, device="cuda",
                            count_turned_away: bool = False):
    """`config_4_fair_share_500q_50k`: fold the whole pending queue into
    the quota tree's demand (K3), solve the forest's runtime once (K18),
    set it as the snapshot's runtime, then config 4's chunked sweep with
    the tree's four levels gated; all of it timed (value ends with the
    assignment's readback). Returns (line, run). The line also gives,
    for each level 1-3, the quotas whose runtime is below their limited
    demand in CPU and in memory, the rounds each level's water-fill ran,
    K18's device time by CUDA events (on a card), and with
    `count_turned_away` the pods that the same sweep with runtime = max
    places but this one does not (an untimed second sweep)."""
    dev = resolve_device(device)
    snap, pods, total = fair_share_inputs(num_pods, num_nodes, device=dev)
    cfg = LoadAwareConfig.make(device=dev)
    cuda = dev.type == "cuda"
    if cuda:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    quotas = add_pending_demand(snap.quotas, pods)
    if cuda:
        events[0].record()
    solved = quota_runtime(quotas, total)
    if cuda:
        events[1].record()
    quotas = quotas.replace(runtime=solved.runtime)
    run = chunked_sweep(snap.replace(quotas=quotas), pods, cfg, chunk,
                        FAIR_SHARE_KW)
    assign = run.assignment.cpu()
    elapsed = time.perf_counter() - t0
    depth = quota_depth(quotas).cpu()
    below = ((solved.runtime < solved.limited).cpu()
             & quotas.valid.cpu()[:, None])
    line = {
        "metric": FAIR_SHARE_METRIC,
        "value": elapsed,
        "pods_per_sec": num_pods / elapsed,
        "placed": int((assign >= 0).sum()),
        "num_pods": num_pods,
        "num_nodes": num_nodes,
        "num_quotas": int(quotas.valid.sum()),
        "below_demand_cpu": [int(below[depth == d, CPU].sum())
                             for d in range(1, FAIR_SHARE_LEVELS)],
        "below_demand_memory": [int(below[depth == d, MEM].sum())
                                for d in range(1, FAIR_SHARE_LEVELS)],
        "rounds": solved.rounds.cpu().tolist(),
        "quota_runtime_ms": (events[0].elapsed_time(events[1]) if cuda
                             else None),
        "chunk": chunk,
        "platform": dev.type,
        "device": card_name_and_power_limit() if cuda else "cpu",
    }
    if count_turned_away:
        capped = chunked_sweep(snap.replace(quotas=quotas.replace(
            runtime=snap.quotas.runtime)), pods, cfg, chunk, FAIR_SHARE_KW)
        line["placed_at_max"] = int((capped.assignment >= 0).sum())
        line["turned_away"] = int(((capped.assignment >= 0)
                                   & (run.assignment < 0)).sum())
    return line, FairShareRun(run.snapshot, run.assignment, quotas,
                              solved.limited, solved.rounds)


def run_gpu_share(num_pods: int = 100_000, num_nodes: int = 10_000,
                  chunk: int = 2000, device="cuda"):
    """Build `gpu_share_100kx10k` (`utils.synthetic.gpu_share_inputs`),
    time one sweep-and-tail on it, and return (line, run): `line` holds
    the bench line's fields (`placed_line`, the cuts) and the device it
    ran on; `run` the final snapshot, the assignment, the placed pods'
    GPU instance takes and reservation slots, and the final topology
    counts. The first call on a card also pays the kernels' build
    unless `kernels.build.build_all()` ran before."""
    dev = resolve_device(device)
    snap, pods = gpu_share_inputs(num_pods, num_nodes, device=dev)
    cfg = LoadAwareConfig.make(device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    run: FlagshipRun = sweep_and_tail(
        snap, pods, cfg, chunk, step_kw=GPU_SHARE_KW,
        tail_kw=GPU_SHARE_TAIL_KW, max_passes=FULL_GATE_MAX_TAIL_PASSES)
    assign = run.assignment.cpu()
    elapsed = time.perf_counter() - t0
    line = placed_line(GPU_SHARE_METRIC, elapsed, snap, pods, run, assign,
                       chunk)
    line["cuts"] = list(GPU_SHARE_CUTS)
    return line, run


def placed_line(metric: str, elapsed: float, snap: ClusterSnapshot,
                pods: PodBatch, run: FlagshipRun, assign: torch.Tensor,
                chunk: int) -> dict:
    """A full-gate bench line: value (the timed seconds), pods_per_sec,
    placed, gpu_pods_placed, numa_bound_placed, slot_consumers,
    once_slots_taken, spread_placed, anti_placed and aff_placed (placed
    pods carrying a group of each family), the stragglers and tail
    passes, the shape and the device."""
    num_pods = pods.num_pods
    placed = assign >= 0
    gpu = has_gpu_request(pods.requests, pods.gpu_ratio).cpu()
    res_slot = run.res_slot.cpu()
    consumed = torch.unique(res_slot[res_slot >= 0]).long()
    stats = [int(x) for x in run.stats]
    dev = pods.valid.device
    return {
        "metric": metric,
        "value": elapsed,
        "pods_per_sec": num_pods / elapsed,
        "placed": int(placed.sum()),
        "gpu_pods_placed": int((placed & gpu).sum()),
        "numa_bound_placed": int((placed & pods.numa_single.cpu()).sum()),
        "slot_consumers": int((res_slot >= 0).sum()),
        "once_slots_taken": int(
            snap.reservations.allocate_once.cpu()[consumed].sum()),
        **{f"{fam}_placed": int((placed & getattr(
            pods, f"{fam}_carrier").cpu().any(dim=1)).sum())
           for fam in ("spread", "anti", "aff")},
        "stragglers_after_sweep": stats[0],
        "stragglers_final": stats[1],
        "never_retried": stats[2],
        "tail_passes": stats[3],
        "num_pods": num_pods,
        "num_nodes": snap.num_nodes,
        "chunk": chunk,
        "platform": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def pack_full_gate(snap: ClusterSnapshot, pods: PodBatch, chunk: int,
                   amplified: bool = False):
    """The full-gate run's set-up (bench.py:226-253, :346-355): (packed
    pods, prefixes, masks, step kwargs, tail kwargs). Packs the pods
    (`pack_gate_prefixes`), derives the domain classes, and adds the
    cascade's prefixes to FULL_GATE_KW (with `enable_amplification`
    where `amplified`); the tail's kwargs keep the topology prefix and
    the classes but drop the numa and gpu prefixes. Raises ValueError on
    a snapshot with a topology-manager policy node, where the numa
    prefix would be unsound."""
    if bool(snap.nodes.numa_policy.ne(0).any()):
        raise ValueError("numa_prefix needs a policy-free snapshot "
                         "(the schedule_batch contract)")
    packed, prefixes, masks = pack_gate_prefixes(pods, chunk)
    contracts = dict(topo_prefix=prefixes["topo"],
                     dom_classes=dom_classes(packed))
    if amplified:
        contracts["enable_amplification"] = True
    step_kw = dict(FULL_GATE_KW, numa_prefix=prefixes["numa"],
                   gpu_prefix=prefixes["gpu"], **contracts)
    tail_kw = dict(FULL_GATE_TAIL_KW, numa_prefix=None, gpu_prefix=None,
                   **contracts)
    return packed, prefixes, masks, step_kw, tail_kw


def full_gate_sweep(snap: ClusterSnapshot, packed: PodBatch,
                    cfg: LoadAwareConfig, chunk: int, prefixes: dict,
                    masks: dict, step_kw: dict, tail_kw: dict) -> FlagshipRun:
    """The full-gate sweep and tail over pods packed by
    `pack_full_gate`, the tail budgeted by the topology prefix."""
    return sweep_and_tail(snap, packed, cfg, chunk, step_kw=step_kw,
                          tail_kw=tail_kw,
                          max_passes=FULL_GATE_MAX_TAIL_PASSES,
                          topo_prefix=prefixes["topo"],
                          topo_mask=masks["topo"])


def run_full_gate(num_pods: int = 100_000, num_nodes: int = 10_000,
                  chunk: int = 2000, device="cuda", amplified: bool = False,
                  aux: bool = False):
    """Build the full-gate flagship (`gpu_share_inputs`, or with
    `amplified` `amplified_full_gate_inputs` and amplification on, or
    with `aux` `aux_full_gate_inputs`; packed by `pack_full_gate`:
    set-up, untimed as in the bench), time one sweep-and-tail on it, and
    return (line, run, setup): `line` is `placed_line` with the three
    prefixes (and with `aux` the aux pods asked, placed and fitting no
    node; the timed run counts nothing more, so that it runs the full
    gate's code: `schedule_batch(aux_stats=...)` counts the pods the aux
    gates turn away in an untimed batch); `run` as run_gpu_share's, in the
    packed order; `setup` the initial snapshot, the packed pods, the
    prefixes, masks and kwargs. The first call on a card also pays the
    kernels' build unless `kernels.build.build_all()` ran before."""
    dev = resolve_device(device)
    inputs = (amplified_full_gate_inputs if amplified
              else aux_full_gate_inputs if aux else gpu_share_inputs)
    snap, pods = inputs(num_pods, num_nodes, device=dev)
    cfg = LoadAwareConfig.make(device=dev)
    packed, prefixes, masks, step_kw, tail_kw = pack_full_gate(
        snap, pods, chunk, amplified)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    run = full_gate_sweep(snap, packed, cfg, chunk, prefixes, masks,
                          step_kw, tail_kw)
    assign = run.assignment.cpu()
    elapsed = time.perf_counter() - t0
    line = placed_line(FULL_GATE_AMPLIFIED_METRIC if amplified
                       else FULL_GATE_AUX_METRIC if aux
                       else FULL_GATE_METRIC, elapsed, snap, packed, run,
                       assign, chunk)
    line.update(topo_prefix=prefixes["topo"], numa_prefix=prefixes["numa"],
                gpu_prefix=prefixes["gpu"], cascade=True,
                amplified=amplified, aux=aux)
    if aux:
        asks = (packed.requests[:, list(AUX_KINDS)] > 0).any(dim=1).cpu()
        line.update(aux_pods=int(asks.sum()),
                    aux_placed=int((asks & (assign >= 0)).sum()),
                    aux_no_fit=aux_no_fit(snap, packed))
    setup = dict(snap=snap, pods=packed, prefixes=prefixes, masks=masks,
                 step_kw=step_kw, tail_kw=tail_kw)
    return line, run, setup


GUARDED_METRIC = "guarded_cycles_10k"
# the guarded cycle's delta sizes and its share of failed binds
GUARDED_METRIC_ROWS, GUARDED_TOPOLOGY_ROWS, GUARDED_FORGET_FRAC = 1000, 64, 0.05


@dataclasses.dataclass
class GuardedRun:
    """The record of one `run_guarded_cycles` run.

    `batches` holds a dict a batch: `kind` (its column fault or None),
    `rows` (the corrupted rows, None on a clean batch), `snapshot` and
    `batch` (the clean inputs, counts carried), `result`, `health`,
    `node_bad`, `pod_bad` (what `guarded_schedule_batch` returned),
    `forget` (the failed-bind mask) and `forgotten` (the store's
    snapshot after the forget). `rejections` holds the four ingests'
    reasons (None where the delta applied), `deltas` the metric, stale
    and topology deltas, `store` the store at the end, `restored` a
    fresh store restored from its checkpoint, and `setup` the published
    snapshot, the LoadAware config and the step kwargs."""

    batches: list
    rejections: list
    deltas: dict
    store: object
    restored: object = None
    setup: dict = None


def guarded_cycle_inputs(num_nodes: int = 10_000, batches: int = 10,
                         chunk: int = 2000, seed: int = 0,
                         device="cuda") -> dict:
    """The set-up of `run_guarded_cycles`: the snapshot, the first
    `batches` packed chunks, the LoadAware config, the full gate's step
    kwargs, the metric and topology deltas and the failed-bind masks."""
    dev = resolve_device(device)
    snap, pods = gpu_share_inputs(100_000, num_nodes, device=dev)
    # the whole chunks of the queue (all of it at chunk 2000)
    pods = slice_batch(pods, 0, pods.num_pods // chunk * chunk)
    packed, _, _, step_kw, _ = pack_full_gate(snap, pods, chunk)
    if batches * chunk > packed.num_pods:
        raise ValueError(f"{batches} batches of {chunk} exceed the "
                         f"{packed.num_pods} pods")
    deltas = dict(
        metric=metric_delta_rows(
            snap, min(GUARDED_METRIC_ROWS, num_nodes // 4), seed + 1, 1),
        topology=topology_delta_rows(
            snap, min(GUARDED_TOPOLOGY_ROWS, num_nodes // 8), seed + 2, 2))
    forget = [torch.from_numpy(np.random.default_rng(seed + 100 + i).uniform(
        size=chunk) < GUARDED_FORGET_FRAC).to(dev) for i in range(batches)]
    return dict(snap=snap, cfg=LoadAwareConfig.make(device=dev),
                step_kw=step_kw, deltas=deltas, forget=forget, seed=seed,
                chunks=[slice_batch(packed, i * chunk, chunk)
                        for i in range(batches)])


def guarded_cycle(inputs: dict):
    """Steps 2-5 of `run_guarded_cycles` on a fresh store over
    `guarded_cycle_inputs`; returns (seconds of steps 3-5, host clock,
    ending with a synchronise; GuardedRun)."""
    from koordinator_tpu_torch.scheduler.guards import guarded_schedule_batch
    from koordinator_tpu_torch.snapshot.store import SnapshotStore
    from koordinator_tpu_torch.testing.faults import (
        BATCH_FAULTS,
        SNAPSHOT_FAULTS,
        FaultInjector,
    )

    snap, cfg, step_kw = inputs["snap"], inputs["cfg"], inputs["step_kw"]
    dev = snap.nodes.allocatable.device
    store = SnapshotStore(device=dev)
    store.publish(snap)
    inj = FaultInjector(inputs["seed"])
    faults = SNAPSHOT_FAULTS + BATCH_FAULTS
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rejections = []
    metric = inputs["deltas"]["metric"]
    stale = inj.stale_delta(metric, 1)  # below version 1, applied first
    for delta in (metric, metric, stale, inputs["deltas"]["topology"]):
        store.ingest(delta)
        rejections.append(store.take_delta_rejection())
    counts = batch_counts(inputs["chunks"][0])
    batches = []
    for i, (batch, forget) in enumerate(zip(inputs["chunks"],
                                            inputs["forget"])):
        batch = batch.replace(**dict(zip(COUNT_FIELDS, counts)))
        clean = store.current()
        kind = faults[i] if i < len(faults) else None
        run_snap, run_batch, rows = clean, batch, None
        if kind in SNAPSHOT_FAULTS:
            run_snap, rows = inj.corrupt_snapshot(clean, kind, i % 3 + 1)
        elif kind is not None:
            run_batch, rows = inj.corrupt_batch(batch, kind, i % 3 + 1)
        res, health, node_bad, pod_bad = guarded_schedule_batch(
            run_snap, run_batch, cfg, **step_kw)
        store.update(lambda _s, res=res: res.snapshot)
        # a quarantined carrier of a bad spread group is its member too,
        # so the corrupted domain row charges nothing
        counts = charge_all_counts(counts, run_batch, res.assignment)
        forgotten = store.forget(run_batch, res, forget)
        batches.append(dict(kind=kind, rows=rows, snapshot=clean,
                            batch=batch, result=res, health=health,
                            node_bad=node_bad, pod_bad=pod_bad,
                            forget=forget, forgotten=forgotten))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    return elapsed, GuardedRun(
        batches=batches, rejections=rejections,
        deltas=dict(inputs["deltas"], stale=stale), store=store,
        setup=dict(snap=snap, cfg=cfg, step_kw=step_kw))


def run_guarded_cycles(num_nodes: int = 10_000, batches: int = 10,
                       chunk: int = 2000, seed: int = 0, device="cuda"):
    """The service's inner cycle on the full-gate workload, without the
    service: `gpu_share_inputs(100_000, num_nodes)` (its whole chunks)
    packed by `pack_full_gate`, the first `batches` chunks with the full
    gate's step kwargs; a fresh `SnapshotStore` takes the snapshot, a
    metric delta of 1000 rows (version 1; a quarter of the nodes on a
    smaller cluster), the same again (a duplicate), a stale re-stamp of
    it (`FaultInjector(seed).stale_delta`) and a topology delta of 64
    rows (version 2; an eighth of the nodes on a smaller cluster); then
    each batch runs `guarded_schedule_batch` on the store's snapshot,
    batch i < 8 with the i-th column fault (SNAPSHOT_FAULTS +
    BATCH_FAULTS, on i % 3 + 1 rows of the snapshot or the batch), the
    topology counts carried as `flagship.sweep_and_tail` carries them;
    the store takes the result and forgets a seeded 5 % of the batch
    (the failed binds). The cycle runs twice, each on its own store;
    the second is timed (steps 3-5, host clock, ending with a
    synchronise). Finally the store is checkpointed (to a temporary
    file) and restored into a fresh store.

    Returns (line, GuardedRun): `line` holds metric
    `guarded_cycles_10k`, `value` (seconds), placed, quarantined_nodes,
    quarantined_pods, deltas_applied, deltas_rejected, forgotten, the
    shape and the device. The first call on a card also pays the
    kernels' build unless `kernels.build.build_all()` ran before."""
    inputs = guarded_cycle_inputs(num_nodes, batches, chunk, seed, device)
    guarded_cycle(inputs)
    elapsed, run = guarded_cycle(inputs)
    dev = run.store.device
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "snapshot.ckpt")
        run.store.checkpoint(path)
        from koordinator_tpu_torch.snapshot.store import SnapshotStore
        run.restored = SnapshotStore(device=dev)
        if not run.restored.restore(path):
            raise RuntimeError("the checkpoint did not restore")
    placed = [b["result"].assignment >= 0 for b in run.batches]
    health = torch.stack([b["health"] for b in run.batches]).cpu()
    line = {
        "metric": GUARDED_METRIC,
        "value": elapsed,
        "placed": int(sum(int(p.sum()) for p in placed)),
        "quarantined_nodes": int(health[:, 1].sum()),
        "quarantined_pods": int(health[:, 2].sum()),
        "deltas_applied": sum(r is None for r in run.rejections),
        "deltas_rejected": sum(r is not None for r in run.rejections),
        "forgotten": int(sum(int((p & b["forget"]).sum())
                             for p, b in zip(placed, run.batches))),
        "batches": batches,
        "chunk": chunk,
        "num_nodes": num_nodes,
        "platform": dev.type,
        "device": (card_name_and_power_limit() if dev.type == "cuda"
                   else "cpu"),
    }
    return line, run


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


@dataclasses.dataclass
class NodeResourceRun:
    cluster: dict                # node_resource_cluster's objects
    outputs: list                # each reconcile's result
    gauges: list                 # each reconcile's gauge samples
    controller: object           # the NodeResourceController


def run_node_resource(num_nodes: int = 10_000, device="cuda",
                      cluster: dict = None):
    """`node_resource_10k`: koord-manager's NodeResourceController over
    `utils.synthetic.node_resource_cluster(num_nodes)`, two reconciles
    a metric sync round apart (the second on the drifted metrics), each
    `build_inputs` then `reconcile` with the per-node strategies of the
    cluster's ColocationConfig (resolved once, at set-up), the formulas
    on K19. Returns (line, run): the line's `value` is the second
    reconcile's seconds (host clock, from the typed objects to the
    gauges), and `reconciles` gives each reconcile's seconds split into
    build_inputs, the calculation (K19, its readback, the resets and the
    diff gate) and the gauge updates, with the synced and degraded
    counts; `run` holds each reconcile's result and gauge samples. The
    controller's metrics go to a registry of its own. `cluster` may give
    a `node_resource_cluster` built before (it is not changed)."""
    from koordinator_tpu_torch.metrics import Registry
    from koordinator_tpu_torch.slo_controller.metrics_defs import (
        SloControllerMetrics,
    )
    from koordinator_tpu_torch.slo_controller.noderesource import (
        NodeResourceController,
        build_inputs,
    )

    dev = resolve_device(device)
    if cluster is None:
        cluster = node_resource_cluster(num_nodes)
    nodes = cluster["nodes"]
    strategies = [cluster["config"].strategy_for(n.meta.labels,
                                                 n.meta.annotations)
                  for n in nodes]
    registry = Registry()
    ctl = NodeResourceController(
        strategy=cluster["config"].cluster_strategy,
        stats=SloControllerMetrics(registry), device=str(dev))
    gauge = ctl.stats.node_extended_resource_allocatable
    reconciles, outputs, gauges = [], [], []
    for metrics, now in ((cluster["metrics"], cluster["now"]),
                         (cluster["drifted"], cluster["drift_now"])):
        t0 = time.perf_counter()
        inputs = build_inputs(nodes, metrics, cluster["pods_by_node"], now,
                              cluster["node_reservations"])
        t1 = time.perf_counter()
        out = ctl.reconcile(inputs, strategies)
        elapsed = time.perf_counter() - t0
        reconciles.append({"value": elapsed, "build_inputs_s": t1 - t0,
                           **ctl.timings,
                           "synced": int(out["sync_mask"].sum()),
                           "degraded": int(out["degraded"].sum())})
        outputs.append(out)
        gauges.append(gauge.samples())
    line = {
        "metric": NODE_RESOURCE_METRIC,
        "value": reconciles[-1]["value"],
        "reconciles": reconciles,
        "nodes": len(nodes),
        "pods": sum(len(v) for v in cluster["pods_by_node"].values()),
        "platform": dev.type,
        "device": (card_name_and_power_limit() if dev.type == "cuda"
                   else "cpu"),
    }
    return line, NodeResourceRun(cluster, outputs, gauges, ctl)


@dataclasses.dataclass
class DeschedulerRun:
    nodes: list
    metrics: dict
    pods_by_node: dict
    evictor: object       # the RecordingEvictor, holding the timed plan


def run_config_5_descheduler(capped: bool = False, n_nodes: int = 10_000,
                             device="cuda", every_node: bool = False):
    """BASELINE config 5 as `bench_configs.config_5_descheduler` measures
    it: one warm `balance_once`, then the limiter reset and the
    evictions cleared, then one timed `balance_once` (it ends with the
    plan's readback). Returns (line, run): `line` holds the bench line's
    fields (metric `baseline_cfg5_descheduler_10k`, or `..._capped` with
    the caps, value = the timed seconds, evictions_planned, nodes) and
    the device it ran on with, on a card, its name and power limit;
    `run` the cluster (`config_5_cluster(n_nodes, every_node)`, built
    once; the metric ends in `_every_node` with it) and the evictor.
    The first call on a card also pays the kernels' build unless
    `kernels.build.build_all()` ran before."""
    from koordinator_tpu_torch.descheduler import (
        DeviceLowNodeLoad,
        EvictionLimiter,
        LowNodeLoadArgs,
        RecordingEvictor,
    )

    dev = resolve_device(device)
    nodes, metrics, pods_by_node = config_5_cluster(n_nodes, every_node)
    evictor = RecordingEvictor(
        EvictionLimiter(**CONFIG_5_CAPS) if capped else None)
    plugin = DeviceLowNodeLoad(LowNodeLoadArgs(consecutive_abnormalities=1),
                               evictor, device=dev)
    plugin.balance_once(nodes, metrics, pods_by_node, CONFIG_5_NOW)  # warm
    evictor.limiter.reset()
    evictor.evictions.clear()  # the warm plan must not double-count
    t0 = time.perf_counter()
    plugin.balance_once(nodes, metrics, pods_by_node, CONFIG_5_NOW)
    elapsed = time.perf_counter() - t0
    line = {
        "metric": (CONFIG_5_CAPPED_METRIC if capped else CONFIG_5_METRIC)
        + ("_every_node" if every_node else ""),
        "value": elapsed,
        "nodes": len(nodes),
        "pods": sum(len(v) for v in pods_by_node.values()),
        "evictions_planned": len(evictor.evictions),
        "device_plan": True,
        "platform": dev.type,
        "device": (card_name_and_power_limit() if dev.type == "cuda"
                   else "cpu"),
    }
    if capped:
        line["caps"] = "node=2,ns=2000,cycle=4000"
    return line, DeschedulerRun(nodes, metrics, pods_by_node, evictor)
