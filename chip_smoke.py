#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`koordinator_tpu_torch/`).

    python3 chip_smoke.py

needs one CUDA card (sm_90a: an H100) and nvcc; it builds the kernels
from `koordinator_tpu_torch/csrc/` into `build/kernels/` first. Phases,
in order:

1. device: the card's name and power limit, and the kernels' build time;
2. kernels: each of K1 score_topk (fed the static gates in factored
   form), K2 segment_prefix_ok (chained over the node level and the
   quota levels of a step) and K3 ordered_scatter_add against its plain
   PyTorch version on the card, at the flagship's shapes, required equal
   (K1 indices exactly and values bit for bit, K2 bools, K3 bit for
   bit): K1 at the sweep's and the tail's shapes and over all 11 dims,
   and untimed where its splits, tiles and row groups meet their edges
   (N = 1000, N = k, every row inactive, P = 10 000, a tie-heavy batch
   without jitter, P = 1, every factored gate biting, table indices out
   of range, a pair mask, negative estimates and weights); K2 with 70 % and 8 % of the pods trying, over all 11
   dims, and one level alone; K3 (`check_k3`) in the one-group and the
   grouped form at the node, quota and count commits, the
   order-sensitive hot row at P = 2000 and 50 000, the reservation
   rebuild's P = 2500, C = 24 in one call and a grouped step of the
   full gate's eight commits. The NUMA path's kernels the same way: K4
   numa_pair_terms at a config-2 chunk (P = 2000, N = 1000, Z = 2) and
   at the flagship's width (N = 10 000), both strategies, and at Z = 4
   (policy nodes, invalid and partly used zones); K5 topology_admit at a
   config-2 chunk at Z = 2 and 4, both strategies, every policy, zero
   requests, every pod trying and P = 1; K1 with K4's pair mask and
   score addend (the config-2 chunk; k = 32 without jitter, negative
   estimates, N = 10 000); K2 as the zone gates (per-level requests,
   strided zone tables; Z = 2 and 4). The DeviceShare path's kernels:
   K6 device_pair_terms at a gpu_share chunk (P = 2000 against N =
   10 000 nodes, 8 instances a node; ANDed into a pair mask in place),
   both strategies, and untimed on an edge state (odd per-GPU memory,
   invalid and zone -1 instances, nodes where none, one or all
   instances fit, memory-specified and non-divisible requests), without
   a mask and at P = 1; K5 with DeviceShare's hint provider at a
   gpu_share step, both strategies, every policy code, the edge state,
   P = 1; K7 gpu_instance_pick's two launches around the K2 gate
   (shared pods' instances, one multi-GPU pod a node, whole instances
   but the shared pods' takes) at a gpu_share step, both strategies,
   the edge state, the topology manager off, P = 1, and the same at
   I = 24 and 56 (MIG slices); K7's take one device activity and a
   step's K7 work two (torch.profiler's trace, checked); K1 with two
   addends (K4's zone score, then K6's pool score; k = 32 without
   jitter, negative estimates, K6's alone). The taint and reservation
   slot paths: K1 with the taint term and the 64 slot columns at a
   gpu_share chunk (both addends, taken once slots), the taint term
   with no addend and with one, k = 32 without jitter, N = 16 with
   k = 24 (the selection reaches into the slot columns), toleration ids
   and taint groups out of the tables' range, a penalty table of zeros,
   slots without taints; K2 as the AllocateOnce level (64 once slots,
   every pod on one slot, P = 1); K5 and K7 (with the K2 gate between
   K7's launches) over the extended rows of slots that hold zones and
   instances. The pod topology families: K1 with the topology term
   (the factored gate over the node and slot columns and the spread
   penalty) at a gpu_share chunk with both addends, the taint term and
   the slots, and at the tail's setting (P = 512, k = 32, jitter), and
   untimed with no addend, one, no taints and no slots, no spread
   family, pods carrying three spread groups, k = 32 without jitter;
   K8 topology_prefix_gate at a gpu_share step (P = 2000), the tail's
   (P = 512) and the full gate's first packed chunk on its topo_prefix
   rows (P = 384), each beside the launch floor (an empty kernel on
   K8's grid), then every pod trying on one column, every column
   keyless, every spread group soft, each family alone, segments of
   more than 64 charging pods, ranks in the reverse of index order, an
   opener column over 10 000 domains, P = 1 and 33; K2 with K8's
   verdict ANDed in after the node level. The cascade: K9 stage1_mask
   at a full-gate chunk (the first packed chunk, P = 2000 against N =
   10 000, the taint tables in, a quota at its ceiling, whose pods must
   lose every candidate), at N = 1001, with fit_dims None and on an
   all-dead batch, then at N = 1, 17 and 10 003, P = 65, quota depth 0,
   table ids out of range, tables too wide for its words, fractional
   and non-finite values; K4 and K6 on the numa and gpu
   prefixes' rows, 0 rows and P rows, ANDing into K9's mask in place,
   and K1 with addends of those rows. The descheduler's kernels, chained
   as the LowNodeLoad plan chains them (K11 lnl_eviction_order, K10
   lnl_node_fit on its low nodes, K12 lnl_plan_prefix and K13
   lnl_plan_capped on its order): at config 5's shape (10 000 nodes,
   11 796 pods; timed, K11 beside one stable `torch.argsort` of as many
   keys), in deviation mode, at P = 1, with every pod nodeless, with a
   budget that binds and with every cap binding, K11's order, flags
   and floats bit for bit and the takes equal. The guarded cycle's
   kernels, bit for bit against their plain versions on the card: K14
   guard_nodes and K15 guard_pods at a full-gate batch (N = 10 000,
   P = 2000, the three topology families), healthy (outputs equal to
   the inputs, health zero; timed) and under each of the eight column
   faults (its bit set, its rows quarantined), and untimed with every
   row bad, N = 1 and P = 1, a family absent, a NaN in an invalid pod
   row, signed zeros and NaN payloads in scrubbed rows and the caller's
   masks; K16 delta_rows at 10 000 nodes with a metric delta of 1000
   rows and a topology delta of 64 (timed on given columns, beside
   index_copy_ over the same columns, and again with the wrapper's
   clones, each against its own bound), with repeated, -1 and
   out-of-range indices, K = 1 and an empty delta. Batches above one
   block: K2 at P = 2500 and 4096 (the tiled walk; 70 % and 8 % trying,
   11 dims, one level, the topology mask, level 0's own amplified
   requests), K5 and K7's take (between K7's choose launch and the K2
   gate) at the same sizes, K8 over two and three tiles at a gpu_share
   step of 2500 and 4096 pods; K2 on fractional requests at P = 250,
   2048 and 2500 at R = 4, and at R = 1 and 11, off and on the gate
   boundaries (fault C7: the pinned order, equal to the plain version
   in every verdict), and the pinned form's time beside the scan's; K1 with
   the amplified CPU fit at the sweep's shape (a third of the nodes
   amplified and nearly full, a third of the pods CPU-bound), over 11
   dims and at ratio 1; K11 and K12 (with K10 and K13) at the config-5
   cluster listing pods on every node (40 000 pods: the sorts and scans
   in device memory); fault C8's widths (`check_c8`): at Z = 8 K4, K5,
   K2's 8-level zone chain, K14 and a config-2 chunk, at I = 24 and 56
   K6, K5 with the GPU hints, K7 and a gpu_share chunk, at Z = 8 with
   I = 56 K5, K7 and a chunk, at J = 64 K17 and K6's aux part, each
   kernel against its plain version and each chunk card against host
   in every field, and every widened wrapper refusing one past its cap.
   Each timed case with
   its time
   (CUDA events over back-to-back calls, and the kernel's device time
   from torch.profiler), the plain version's, one library call's where
   there is one, and the card's lower bound for the same work;
3. slice equality: the slim flagship at 8000 pods x 1000 nodes on the
   card against the plain path on the host: equal assignments;
4. flagship: the slim flagship at 100 000 pods x 10 000 nodes, chunk
   2000, on the card, after a warm-up run: the bench line, every
   kernel's launch count in the measured run (each must be > 0; K2 once
   an inner step; K3 once an inner step, once a round and once a
   batch: `k3_formula`), peak device memory, and the invariants (no
   overcommit, quota used within runtime, every straggler retried, the
   sweep's stragglers unchanged; K4 to K8 never launched);
5. config 2: BASELINE config 2 (10 000 pods x 1000 nodes, chunks of
   2000, LoadAware + NodeNUMAResource, `configs.run_config_2_numa`) on
   the card after a warm-up run, then on the host: the bench line, the
   measured run's launch counts (K4 once a chunk, K5 once an inner step,
   K2 twice an inner step, K1 once a round), the card's assignment,
   zones, takes, zone free and requested equal to the host's, each
   zone's takes within its capacity, no overcommit, quota within
   runtime; K6 to K8 never launched;
6. gpu_share: `configs.run_gpu_share` (the DeviceShare path with
   NodeNUMAResource, taints and tolerations, 64 reservation slots and
   the spread, anti-affinity and affinity groups) at 4000 pods x 1000
   nodes (phase 7 compares 8000 on the same path with the cascade) on
   the card and on the host, every result field equal
   (assignment, tail stats, instance takes, slots consumed, requested,
   zone free, instance free, quotas, gangs, the reservation state, the
   four topology count tables, the placed pods of each family); then
   100 000 x 10 000 on the card: the bench line, the launch counts its
   design fixes (K4 and K6 once a batch, K1 once a round, K5 and K8
   once an inner step, K7 twice, K2 four times; K3 once an inner step,
   once a round and twice a batch: `k3_formula`, printed as
   K3_FORMULA),
   every placed GPU pod holding its count of instances, the takes times
   the per-instance requests equal to each valid instance's total minus
   its free, no negative free; every slot consumer on its slot's node
   and owning it, at most one consumer an AllocateOnce slot, each
   slot's free its initial free less its consumers' requests, node
   requested not charged by consumers, no pod on a node whose taints
   its toleration set forbids; no node holding two placed carriers of
   one anti-affinity group, the carried counts equal to the recount
   from the final assignment (each hard spread group's final skew and
   each affinity group's zones printed); no overcommit, quota within
   runtime, and never_retried what the tail's pass budget leaves (each
   pass retries a full window of never-retried stragglers first);
7. the full gate: `configs.run_full_gate`
   (score_bind_100k_pods_10k_nodes_full_gate: gpu_share's workload
   packed by `pack_gate_prefixes`, the cascade on, the topology, numa
   and gpu prefixes and the domain classes, the tail budgeted by the
   topology prefix) at 8000 pods x 1000 nodes on the card with the
   cascade on and off and on the host with it on, every field equal
   (assignment, stats, instance takes, slots, zones, the four count
   tables, every leaf of the snapshot); then 100 000 x 10 000 on the
   card after a warm-up run: the bench line with the prefixes, the
   first chunk's candidate counts (min, median, max), launches and
   peak memory, gpu_share's launch formulas with K9 once a batch, its
   invariants, and no straggler left never retried;
8. config 5: BASELINE config 5, koord-descheduler's LowNodeLoad plan
   over 10 000 nodes (`configs.run_config_5_descheduler`: a warm plan,
   then the timed one), plain (K10, K11, K12) and capped (per cycle
   4000, per node 2, per namespace 2000: K10, K11, K13) on the card,
   then on the host (the port's plan through the plain versions, and
   the host loop LowNodeLoad): the evicted pods equal name for name and
   in order, each kernel's launches over the two plans (K10 and K11
   once a plan, K12 once a plain plan, K13 once a capped plan, nothing
   else), every evicted pod on a source node, the caps held, and no
   node losing a pod once it is at or under its high threshold on
   every dim; the two bench lines printed;
9. the guarded cycle: `configs.run_guarded_cycles` (10 000 nodes, ten
   full-gate batches of 2000 through a `SnapshotStore`: a metric delta
   of 1000 rows, a duplicate and a stale re-stamp of it, a topology
   delta of 64 rows, `guarded_schedule_batch` a batch with the eight
   column faults on batches 1-8, 5 % of each batch forgotten, a
   checkpoint restored) on the card, counting launches (K14 once a
   batch, K15 twice, K16 twice a delta applied, K1-K9 by the full
   gate's formulas of phase 7, K3 also the count of one forget, which
   is measured alone around one `store.forget`; nothing else), then
   on the host: every batch's clean snapshot, result, health, masks and
   post-forget snapshot equal; each fault's bit, its nodes
   unschedulable and its pods unplaced, and its placements equal to the
   unguarded batch on the clean inputs with the corrupted rows masked
   by hand; batches 9 and 10 equal to the unguarded batch field for
   field; the duplicate and the stale delta refused with their reasons;
   after each forget, requested, quota used and gang assumed equal to
   the host's numpy recount of the committed snapshot less the
   forgotten pods' charges (gpu_free within GPU_FREE_TOL); the restored
   store equal to the checkpointed one; the line and the guard's
   overhead on a clean batch (guarded against unguarded, in turns);
10. config 4: BASELINE config 4 (`configs.run_config_4_quota`: 50 000
   pods x 5000 nodes under 500 quotas, chunks of 2500, every K2 launch
   the tiled walk) on the card after a warm-up run, counting launches
   (K1 once a round, K2 once an inner step, no NUMA, DeviceShare or
   topology kernel), then its first 20 000 pods on the card and on the
   host: the assignment and every leaf of the final snapshot equal; no
   overcommit, quota within runtime;
11. config 5 with pods on every node (`run_config_5_descheduler(
   every_node=True)`: 40 000 pods on 10 000 nodes), plain and capped, as
   phase 8: the card's plan equal to the host's and the host loop's,
   launches, caps and thresholds;
12. the amplified full gate (`run_full_gate(amplified=True)`,
   `full_gate_amplified_100kx10k`: the full gate on a cluster whose node
   webhook amplified the CPU of about 30 % of the nodes, amplification
   on): on the card and the host, every field equal, at 5000 pods x
   10 000 nodes in chunks of 2500 (K2, K5, K7's take and K8 above 2048
   pods inside the batch); at 100 000 x 10 000 on the card with the
   full gate's launch formulas and invariants (node requested equal to
   the recount with the bind pods' CPU amplified) and CPU-bind pods
   placed on amplified nodes (the host run of the whole 100k x 10k would
   take over an hour).
13. full_gate_aux_100kx10k (`configs.run_full_gate(aux=True)`: RDMA
   VFs on the GPU nodes and a tenth of the others, FPGAs on 2 % of the
   nodes, pods asking for them): card against host in every field
   (aux_inst and aux_free included) at 8000 x 1000 and on the first
   full-width chunk; at 100 000 x 10 000 on the card with the full
   gate's launch formulas plus K17 and K2 once more a step, the
   aux invariants (the final VF free is the batch-start free less the
   placed pods' requests, exactly; none below 0; every held VF valid)
   and aux pods both placed and turned away. Phase 2 also holds K17
   (ties, empty pools, both strategies), K6 with its aux part and K2's
   aux levels against their plain versions, and K2 on fractional
   requests equal to its plain version (fault C7's pinned order).
14-15. BASELINE configs 1 (32 BE pods x 10 nodes) and 3 (1000 strict
   gangs of 8 on 5000 nodes): card against host in the assignment and
   every leaf of the snapshot, only K1-K3 launched, no gang in part.
16. config_4_fair_share_500q_50k (`configs.run_config_4_fair_share`:
   config 4 under a contended four-level tree of 500 quotas, the whole
   queue folded into the leaves' demand by K3, the runtime solved once
   by K18, config 4's sweep with four quota levels) on the card after a
   warm-up run: K18 launched once, K3 once (the fold) more than the
   same sweep at runtime = max (which also counts the pods the runtime
   turns away), K1, K2 and the order switch as that sweep; the card's
   runtime, limited demand and rounds equal to the host's plain
   water-fill; quota used within runtime at every level; the tree
   binding (quotas below their demand at levels 1-3, pods turned
   away); the first 5000 pods' run card against host in the assignment
   and every leaf of the snapshot. Phase 2 holds K18 against its plain
   version on the fair-share tree, config 4's own tree, a six-level
   chain, unlimited maxes with zero weights, max_iters = 2 and Q = 1,
   and K3 as the fold at 50 000 pods with quota-less, invalid and
   out-of-table pods;
17. node_resource_10k (`configs.run_node_resource`: koord-manager's
   NodeResourceController over 10 000 nodes and 300 000 pods, two
   reconciles, the second after a usage drift): K19 launched once a
   reconcile, nothing else; batch, mid, degraded, sync_mask and the
   gauges card against host in both reconciles, the diff gate both
   syncing and holding rows. Phase 2 holds K19 against its plain
   version at 10 000 nodes, every policy, NaN, infinite, -0 and
   negative inputs (NaN where the host has NaN: the card does not keep
   NaN payloads).
Each phase's seconds are printed.

The last three lines are one JSON object listing the kernels, the
card's name and power limit, and one JSON object stating the result.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from koordinator_tpu_torch import kernels, resolve_device
from koordinator_tpu_torch.api.extension import ResourceKind
from koordinator_tpu_torch.bridge import from_reference, to_numpy
from koordinator_tpu_torch.configs import (
    CONFIG_2_KW,
    CONFIG_4_KW,
    CONFIG_5_CAPS,
    CONFIG_3_GANG_SIZE,
    FAIR_SHARE_LEVELS,
    FULL_GATE_AUX_METRIC,
    FULL_GATE_KW,
    GPU_SHARE_KW,
    GPU_SHARE_TAIL_KW,
    card_name_and_power_limit,
    full_gate_sweep,
    pack_full_gate,
    run_config_1_spark,
    run_config_2_numa,
    run_config_3_gangs,
    run_config_4_fair_share,
    run_config_4_quota,
    run_config_5_descheduler,
    run_full_gate,
    run_gpu_share,
    run_guarded_cycles,
    run_node_resource,
)
from koordinator_tpu_torch.descheduler import (
    EvictionLimiter,
    LowNodeLoad,
    LowNodeLoadArgs,
    RecordingEvictor,
)
from koordinator_tpu_torch.descheduler.lownodeload_device import columnarize
from koordinator_tpu_torch.flagship import (
    STEP_KW,
    TAIL_KW,
    run_northstar,
    sweep_and_tail,
)
from koordinator_tpu_torch.kernels import guard
from koordinator_tpu_torch.kernels.aux_instances import (
    aux_instance_pick,
    aux_instance_pick_plain,
)
from koordinator_tpu_torch.kernels.build import build_all
from koordinator_tpu_torch.kernels.delta_rows import (
    delta_rows,
    delta_rows_into,
    delta_rows_into_plain,
    delta_rows_plain,
)
from koordinator_tpu_torch.kernels.device_terms import (
    device_pair_terms,
    device_pair_terms_plain,
)
from koordinator_tpu_torch.kernels.guard import (
    guard_nodes,
    guard_nodes_plain,
    guard_pods,
    guard_pods_plain,
)
from koordinator_tpu_torch.kernels.gpu_instances import (
    gpu_choose_plain,
    gpu_instance_pick,
    gpu_take_plain,
)
from koordinator_tpu_torch.kernels.lownodeload import (
    EPS as LNL_EPS,
    lnl_eviction_order,
    lnl_eviction_order_plain,
    lnl_node_fit,
    lnl_node_fit_plain,
    lnl_plan_capped,
    lnl_plan_capped_plain,
    lnl_plan_prefix,
    lnl_plan_prefix_plain,
    weighted_sum,
)
from koordinator_tpu_torch.kernels.node_overcommit import (
    node_overcommit,
    node_overcommit_plain,
)
from koordinator_tpu_torch.kernels.numa_terms import (
    numa_pair_terms,
    numa_pair_terms_plain,
)
from koordinator_tpu_torch.kernels.quota_runtime import (
    quota_runtime,
    quota_runtime_plain,
)
from koordinator_tpu_torch.kernels.scatter import (
    ordered_scatter_add,
    ordered_scatter_add_many,
    ordered_scatter_add_many_plain,
    ordered_scatter_add_plain,
)
from koordinator_tpu_torch.kernels.score_topk import (
    JITTER,
    add_rows,
    masked_scores,
    score_topk,
    score_topk_plain,
    spread_penalty,
    tie_break_jitter,
    topo_blocked,
)
from koordinator_tpu_torch.kernels.segment_prefix import (
    exact_in_any_order,
    exact_in_any_order_plain,
    segment_prefix_chain,
    segment_prefix_chain_plain,
    segment_prefix_ok_plain,
)
from koordinator_tpu_torch.kernels.stage1 import (
    stage1_mask,
    stage1_mask_plain,
)
from koordinator_tpu_torch.kernels.topology import (
    topology_admit,
    topology_admit_plain,
)
from koordinator_tpu_torch.kernels.topology_prefix import (
    CAP,
    OPENER,
    PrefixFamily,
    launch_floor,
    topology_prefix_gate,
    topology_prefix_gate_plain,
)
from koordinator_tpu_torch.scheduler.batching import (
    EPS,
    rank_by_priority,
    stable_rank,
)
from koordinator_tpu_torch.scheduler.cascade import (
    _table_index,
    expand_gates,
    static_gate_terms,
    taint_penalty,
)
from koordinator_tpu_torch.ops import feasibility
from koordinator_tpu_torch.ops.quota_demand import add_pending_demand
from koordinator_tpu_torch.ops.waterfill import quota_depth
from koordinator_tpu_torch.scheduler import cascade, domains
from koordinator_tpu_torch.scheduler import guards
from koordinator_tpu_torch.scheduler.core import (
    overcommit_ok,
    quota_ok,
    schedule_batch,
)
from koordinator_tpu_torch.scheduler.guards import guarded_schedule_batch
from koordinator_tpu_torch.scheduler.plugins import (
    deviceshare,
    loadaware,
    numaaware,
)
from koordinator_tpu_torch.scheduler.plugins.reservation import slot_columns
from koordinator_tpu_torch.snapshot import delta as snapshot_delta
from koordinator_tpu_torch.snapshot.delta import NodeTopologyDelta
from koordinator_tpu_torch.snapshot.store import SnapshotStore
from koordinator_tpu_torch.testing import faults, lnl_cases
from koordinator_tpu_torch.testing.scatter_cases import hot_row_case
from koordinator_tpu_torch.utils import synthetic
from koordinator_tpu_torch.utils.synthetic import (
    CONFIG_5_NOW,
    aux_full_gate_inputs,
    config_2_inputs,
    config_4_inputs,
    config_5_cluster,
    fair_share_inputs,
    gpu_share_inputs,
    node_resource_cluster,
    slice_batch,
    synthetic_cluster,
    synthetic_pods,
)

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s
# and f32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
CPU = int(ResourceKind.CPU)
FIT_DIMS = [0, 1, 2, 3]
SCORE_DIMS = [0, 1]
ALL_DIMS = list(range(11))
QUOTA_DEPTH = STEP_KW["quota_depth"]
# the slim flagship at pods seed 1, snapshot seed 7 leaves this many
# stragglers after its sweep; a kernel change that moves a placement
# changes it
STRAGGLERS_AFTER_SWEEP = 510
# config 4's pods that phase 10 compares card against host
CONFIG_4_COMPARED_PODS = 20_000
# gpu_share's pods that phase 6 compares card against host at 1000 nodes
# (phase 7's full gate compares 8000 on this path and the cascade's)
GPU_SHARE_COMPARED_PODS = 4000
# the fair share's pods that phase 16 compares card against host
FAIR_SHARE_COMPARED_PODS = 5000
# the slim path's kernels (K2's order switch once a batch); the NUMA path
# adds K4 and K5, the DeviceShare path K6 and K7
SLIM_KERNELS = ("score_topk", "segment_prefix_ok", "order_switch",
                "ordered_scatter_add")
NUMA_KERNELS = SLIM_KERNELS + ("numa_pair_terms", "topology_admit")
GPU_KERNELS = ("device_pair_terms", "gpu_instance_pick")
SOURCES = {
    "score_topk": ("koordinator_tpu_torch/csrc/score_topk.cu",
                   "koordinator_tpu/scheduler/core.py:721"),
    "segment_prefix_ok": ("koordinator_tpu_torch/csrc/segment_prefix_ok.cu",
                          "koordinator_tpu/scheduler/batching.py:45"),
    "order_switch": ("koordinator_tpu_torch/csrc/segment_prefix_ok.cu",
                     "koordinator_tpu/scheduler/batching.py:45"),
    "ordered_scatter_add": (
        "koordinator_tpu_torch/csrc/ordered_scatter_add.cu",
        "koordinator_tpu/scheduler/core.py:1109"),
    "numa_pair_terms": ("koordinator_tpu_torch/csrc/numa_terms.cu",
                        "koordinator_tpu/scheduler/plugins/numaaware.py:70"),
    "topology_admit": ("koordinator_tpu_torch/csrc/topology_admit.cu",
                       "koordinator_tpu/scheduler/core.py:907"),
    "device_pair_terms": ("koordinator_tpu_torch/csrc/device_terms.cu",
                          "koordinator_tpu/scheduler/plugins/"
                          "deviceshare.py:152"),
    "gpu_instance_pick": ("koordinator_tpu_torch/csrc/gpu_instances.cu",
                          "koordinator_tpu/scheduler/core.py:962"),
    "topology_prefix_gate": ("koordinator_tpu_torch/csrc/topology_prefix.cu",
                             "koordinator_tpu/scheduler/core.py:776"),
    "stage1_mask": ("koordinator_tpu_torch/csrc/stage1_mask.cu",
                    "koordinator_tpu/scheduler/cascade.py:117 "
                    "(ops/feasibility.py:44)"),
    "lnl_node_fit": ("koordinator_tpu_torch/csrc/lownodeload_fit.cu",
                     "koordinator_tpu/descheduler/lownodeload_device.py:103"),
    "lnl_eviction_order": (
        "koordinator_tpu_torch/csrc/lownodeload_order.cu",
        "koordinator_tpu/descheduler/lownodeload_device.py:75"),
    "lnl_plan_prefix": (
        "koordinator_tpu_torch/csrc/lownodeload_prefix.cu",
        "koordinator_tpu/descheduler/lownodeload_device.py:162"),
    "lnl_plan_capped": (
        "koordinator_tpu_torch/csrc/lownodeload_capped.cu",
        "koordinator_tpu/descheduler/lownodeload_device.py:231"),
    "guard_nodes": ("koordinator_tpu_torch/csrc/guard_nodes.cu",
                    "koordinator_tpu/scheduler/guards.py:120"),
    "guard_pods": ("koordinator_tpu_torch/csrc/guard_pods.cu",
                   "koordinator_tpu/scheduler/guards.py:149"),
    "delta_rows": ("koordinator_tpu_torch/csrc/delta_rows.cu",
                   "koordinator_tpu/snapshot/delta.py:108"),
    "aux_instance_pick": ("koordinator_tpu_torch/csrc/aux_instances.cu",
                          "koordinator_tpu/scheduler/plugins/"
                          "deviceshare.py:274"),
    "quota_runtime": ("koordinator_tpu_torch/csrc/quota_runtime.cu",
                      "koordinator_tpu/ops/waterfill.py:135"),
    "node_overcommit": ("koordinator_tpu_torch/csrc/node_overcommit.cu",
                        "koordinator_tpu/slo_controller/"
                        "noderesource.py:166"),
}


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of fn() on the card, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel, reps: int = 20) -> float:
    """Mean device milliseconds a call of fn() from torch.profiler's
    device trace: `kernel` is a symbol fragment, or a tuple of them when
    a call launches one kernel of each (their times summed). The host's
    time between launches, which `cuda_ms` sees when the host is slower
    than the kernel, is not in it."""
    symbols = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    fn()
    torch.cuda.synchronize()
    # the tracer may miss launches (a few at its start, or now and then a
    # whole trace, twice in a row at times): the mean of those seen, from
    # up to six traces
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(s in e.name for s in symbols)]
        calls = len(spans) / len(symbols)
        if calls >= reps // 2:
            return sum(spans) / calls / 1e3
        print(f"device_ms: the trace holds {len(spans)} launches of "
              f"{symbols}, not {reps * len(symbols)}; tracing again",
              file=sys.stderr)
    raise SystemExit(f"six traces missed most launches of {symbols}")


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def loaded_state(dev, gen, n_nodes=10_000):
    """The flagship's pods against a snapshot whose nodes and quotas are
    partly filled (integer-valued loads, as commits leave them;
    non-integer estimates)."""
    snap = synthetic_cluster(n_nodes, seed=0, num_quotas=32, device=dev)
    pods = synthetic_pods(100_000, seed=1, num_quotas=32, device=dev)
    nodes, quotas = snap.nodes, snap.quotas
    alloc = nodes.allocatable
    load = torch.rand(alloc.shape, generator=gen, device=dev) * 0.95
    requested = torch.floor(alloc * load / 500.0) * 500.0
    est = torch.floor(alloc * load * 0.4) + 0.375
    nodes = nodes.replace(requested=requested, assigned_estimated=est,
                          prod_assigned_estimated=est * 0.5)
    runtime = torch.where(torch.isinf(quotas.runtime), 0.0, quotas.runtime)
    slack = torch.rand(runtime.shape, generator=gen, device=dev) * 40000.0
    used = torch.clamp_min(torch.floor((runtime - slack) / 500.0) * 500.0, 0.0)
    return snap.replace(nodes=nodes, quotas=quotas.replace(used=used)), pods


def k1_case(snap, pods, cfg, p0, p, k, gen, fit_dims, score_dims,
            active=0.9, tie_break=True, pair=False):
    """K1's arguments for pods [p0, p0 + p), as schedule_batch forms
    them (the static gates in factored form), with a share `active` of
    the rows active; score_dims None = all dims; `pair` adds a random
    pair mask (60 % pass)."""
    dev = snap.nodes.allocatable.device
    batch = slice_batch(pods, p0, p)
    gates = static_gate_terms(snap.nodes, batch, cfg, snap.devices)
    node_term, prod_term, alloc_s, weights = loadaware.score_terms(
        snap.nodes, cfg, None if score_dims is None else tuple(score_dims))
    sd = ALL_DIMS if score_dims is None else score_dims
    row_ok = torch.rand((p,), generator=gen, device=dev) < active
    pair_ok = (torch.rand((p, snap.num_nodes), generator=gen, device=dev)
               < 0.6) if pair else None
    return dict(
        gates=gates, pair_ok=pair_ok, row_ok=row_ok,
        req_fit=batch.requests[:, fit_dims].contiguous(),
        requested_fit=snap.nodes.requested[:, fit_dims].contiguous(),
        alloc_fit=snap.nodes.allocatable[:, fit_dims].contiguous(),
        est=batch.estimated[:, sd].contiguous(),
        prod_scored=loadaware.prod_scored(batch, cfg),
        node_term=node_term, prod_term=prod_term, alloc_score=alloc_s,
        weights=weights, k=k, tie_break=tie_break, eps=EPS,
        fma_sum=score_dims is not None)


def k1_equal(label, kw):
    """Run K1 and its plain version on kw; raise unless equal (indices
    exactly, values bit for bit). Returns (kernel output, max abs err)."""
    got = score_topk(**kw)
    want = score_topk_plain(**kw)
    err = float((got[0] - want[0]).abs().max())
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and got[0].view(torch.int32).equal(want[0].view(torch.int32))):
        bad = (got[1] != want[1]).any(dim=1).nonzero()[:5, 0].tolist()
        raise SystemExit(f"K1 score_topk ({label}) differs from its plain "
                         f"version; rows {bad}")
    return got, err


def gated_state(dev, gen, n):
    """A snapshot of n nodes and a LoadAware config in which every
    factored gate bites: label groups and pod selectors (some matching
    few groups), stale metrics, unschedulable nodes, DaemonSet pods,
    prod-usage thresholds for prod pods, and pods asking for GPU or aux
    resources (no instances: their rows are all -1)."""
    snap, pods = loaded_state(dev, gen, n)
    nodes = snap.nodes
    nodes = nodes.replace(
        label_group=torch.randint(0, 64, (n,), generator=gen, device=dev,
                                  dtype=torch.int32),
        metric_fresh=torch.rand((n,), generator=gen, device=dev) < 0.8,
        schedulable=torch.rand((n,), generator=gen, device=dev) < 0.9,
        prod_usage=nodes.usage * torch.rand((n, 1), generator=gen,
                                            device=dev))
    np_ = pods.num_pods
    match = torch.rand(pods.selector_match.shape, generator=gen,
                       device=dev) < 0.5
    match[0] = False
    match[0, :2] = True                    # selector 0: 2 groups of 64
    req = pods.requests.clone()
    req[:, deviceshare.GPU_CORE] = torch.where(
        torch.rand((np_,), generator=gen, device=dev) < 0.05, 50.0, 0.0)
    pods = pods.replace(
        requests=req,
        selector_id=torch.randint(-1, match.shape[0], (np_,), generator=gen,
                                  device=dev, dtype=torch.int32),
        selector_match=match,
        daemonset=torch.rand((np_,), generator=gen, device=dev) < 0.1)
    cfg = loadaware.LoadAwareConfig.make(
        prod_usage_thresholds={ResourceKind.CPU: 45.0}, device=dev)
    return snap.replace(nodes=nodes), pods, cfg


def check_k1_edges(snap, pods, cfg, gen):
    """K1 equal to its plain version, untimed, where the kernel's splits,
    tiles and row groups meet their edges: N = 1000 (no multiple of the
    256-node tile), N = k, every row inactive, P = 10 000 (16-row groups,
    three fully inactive), a tie-heavy batch without jitter (nodes in
    groups of identical columns), P = 1, every factored gate biting,
    selector ids and label groups out of the table's range, a pair mask,
    and negative estimates and a negative weight (rows the node bounds
    do not hold for)."""
    dev = snap.nodes.allocatable.device
    small = {n: loaded_state(dev, gen, n) for n in (1000, 32, 8)}
    dup_snap, dup_pods = small[1000]
    src = torch.arange(1000, device=dev) // 8 * 8
    dup_snap = dup_snap.replace(nodes=dup_snap.nodes.replace(**{
        f: getattr(dup_snap.nodes, f)[src]
        for f in ("allocatable", "requested", "usage", "assigned_estimated",
                  "prod_assigned_estimated")}))
    gsnap, gpods, gcfg = gated_state(dev, gen, 10_000)
    s_, labels = gpods.selector_match.shape
    wild = (gsnap.replace(nodes=gsnap.nodes.replace(label_group=torch.randint(
                -labels - 8, labels + 8, (10_000,), generator=gen,
                device=dev, dtype=torch.int32))),
            gpods.replace(selector_id=torch.randint(
                -3, s_ + 3, (gpods.num_pods,), generator=gen, device=dev,
                dtype=torch.int32)))

    def inactive_groups(a):
        a["row_ok"][:48] = False

    def negative_est(a):
        a["est"][::3, 0] -= 3000.0

    def negative_weight(a):
        a["weights"] = torch.tensor([1.0, -0.5], device=dev)

    cases = [
        ("N=1000", small[1000], cfg, dict(p=2000, k=8), None),
        ("N=1000 k=32", small[1000], cfg, dict(p=512, k=32), None),
        ("N=k=32", small[32], cfg, dict(p=512, k=32), None),
        ("N=k=8", small[8], cfg, dict(p=2000, k=8), None),
        ("all rows inactive", (snap, pods), cfg,
         dict(p=2000, k=8, active=0.0), None),
        ("P=10000", (snap, pods), cfg, dict(p=10_000, k=8),
         inactive_groups),
        ("ties, no jitter", (dup_snap, dup_pods), cfg,
         dict(p=2000, k=32, tie_break=False), None),
        ("P=1", (snap, pods), cfg, dict(p=1, k=8, active=1.0), None),
        ("P=1 k=32", (snap, pods), cfg, dict(p=1, k=32, active=1.0), None),
        ("gated", (gsnap, gpods), gcfg, dict(p=2000, k=8), None),
        ("gated, indices out of range", wild, gcfg, dict(p=2000, k=8),
         None),
        ("gated, pair mask", (gsnap, gpods), gcfg,
         dict(p=512, k=32, pair=True), None),
        ("negative estimates", (snap, pods), cfg, dict(p=2000, k=8),
         negative_est),
        ("negative weight", (snap, pods), cfg, dict(p=512, k=32),
         negative_weight),
    ]
    out = {}
    for label, (s, p_), c, kw, edit in cases:
        args = k1_case(s, p_, c, 0, kw.pop("p"), kw.pop("k"), gen,
                       FIT_DIMS, SCORE_DIMS, **kw)
        if edit is not None:
            edit(args)
        (val, _), _ = k1_equal(label, args)
        out[label] = dict(
            feasible_pairs=int((val >= 0).sum()),
            rows_below_k=int(((val >= 0).sum(dim=1) < args["k"]).sum()),
            ties=int((val[:, 1:] == val[:, :-1]).sum()))
    return out


def k1_needed_pairs(kw, checked, val, idx):
    """(pairs, usage terms): the pairs of K1's arguments `kw` whose fit
    and score a selection must evaluate when it may rule a pair out by
    its node's bound (the value a pod that estimates zero gives the node,
    plus the pair's own score addend where `kw` has one, with the
    largest jitter: no pod of a non-negative estimate and weights gives
    more), given the selection's result (val, idx): the pairs in
    `checked` (the gates passed) whose bound reaches the row's k-th
    entry in the top-k order, and every pair in `checked` of a row with
    a negative estimate or weight. The usage terms are those the active
    rows score against (the node's, and the prod term)."""
    gates, prod = kw["gates"], kw["prod_scored"]
    d = kw["est"].shape[1]
    ub = loadaware.least_requested_score(
        torch.zeros((2, d), device=val.device),
        torch.tensor([False, True], device=val.device), kw["node_term"],
        kw["prod_term"], kw["alloc_score"], gates.metric_fresh,
        kw["weights"], kw["fma_sum"])
    ub = ub[prod.long()]                                     # [P, N]
    if kw.get("pair_score") is not None:
        ub = add_rows(ub, kw["pair_score"])
    if kw.get("pair_score2") is not None:
        ub = add_rows(ub, kw["pair_score2"])
    penalty = taint_penalty(gates)
    if penalty is not None:
        ub = torch.clamp_min(ub - penalty, 0.0)
    topo = kw.get("topo")
    if topo is not None and topo.penalty is not None:
        ub = torch.clamp_min(ub - spread_penalty(topo, ub.shape[1]), 0.0)
    if kw["tie_break"]:
        ub = loadaware.fma_f32(torch.full_like(ub, 1023.0), JITTER, ub)
    kv, ki = val[:, -1:], idx[:, -1:].long()
    node = torch.arange(ub.shape[1], device=ub.device)[None, :]
    checked = checked[:, :ub.shape[1]]
    reach = (ub > kv) | ((ub == kv) & (node <= ki))
    bounded = (kw["est"] >= 0).all(dim=1) & bool((kw["weights"] >= 0).all())
    needed = checked & (reach | ~bounded[:, None])
    active = kw["row_ok"] & gates.device_ok
    return int(needed.sum()), 1 + int(bool(prod[active].any()))


def check_k1(snap, pods, cfg, gen):
    """K1 at the sweep's shape (P=2000, k=8) and the tail's (P=512,
    k=32) over the flagship's dims, and at the sweep's shape over all
    11 dims (fit_dims = score_dims = None: the 8-lane weighted sum)."""
    out = {}
    for label, p0, p, k, fd, sd in (
            ("sweep", 0, 2000, 8, FIT_DIMS, SCORE_DIMS),
            ("tail", 2000, 512, 32, FIT_DIMS, SCORE_DIMS),
            ("sweep R=11", 4000, 2000, 8, ALL_DIMS, None)):
        kw = k1_case(snap, pods, cfg, p0, p, k, gen, fd, sd)
        (val, idx), err = k1_equal(label, kw)
        gates = kw["gates"]
        n = gates.label_group.shape[0]
        f, d = kw["req_fit"].shape[1], kw["est"].shape[1]
        checked = expand_gates(gates) & kw["row_ok"][:, None]
        fit = torch.all(kw["req_fit"][:, None, :] + kw["requested_fit"][None]
                        <= kw["alloc_fit"][None] + EPS, dim=-1)
        n_rows = int(kw["row_ok"].sum())
        n_checked = int(checked.sum())
        n_feasible = int((checked & fit).sum())
        n_needed, n_terms = k1_needed_pairs(kw, checked, val, idx)
        active = int((kw["row_ok"] & gates.device_ok).sum())
        # bytes: the factored gates (five flag bytes and the selector id
        # a pod, a label and four flag bytes a node, the selector table)
        # and the pod and node columns, each read once, and the result
        # (`bound_ms_mask_form`: the [P, N] mask of the active rows in
        # place of the gate terms).
        shared = p * (f + d) * 4 + n * (2 * f + 3 * d) * 4 + d * 4 \
            + p * k * 8
        nbytes = shared + p * 9 + n * 8 + gates.selector_match.numel()
        mask_bytes = shared + n_rows * n + 2 * p + n
        # operations (a correctly rounded division counts as one).
        # `bound_ms`: what a selection that prunes by node bounds needs:
        # one compare for each pair of an active row; each node's gate
        # classes and its bound for each usage term in use; the fit and
        # the score of only the pairs `k1_needed_pairs` counts.
        # `bound_ms_all_pairs` (and the mask form) charge a selection
        # that prunes nothing: the gate of each pair of an active row,
        # the fit of each pair that passes it, the per-node terms once,
        # the score of each feasible pair.
        ops = active * n + n * (3 + n_terms * (5 * d + 3)) \
            + n_needed * (2 * f + 8 * d + 4)
        ops_all = n_rows * n + n_checked * 2 * f + n * (f + 2 * d) \
            + n_feasible * (8 * d + 4)
        b_ms, b_by = bound(nbytes, ops)
        masked = torch.where(checked & fit, tie_break_jitter(
            loadaware.least_requested_score(
                kw["est"], kw["prod_scored"], kw["node_term"],
                kw["prod_term"], kw["alloc_score"], gates.metric_fresh,
                kw["weights"], kw["fma_sum"])), -1.0)
        out[label] = dict(
            ms=cuda_ms(lambda: score_topk(**kw)),
            device_ms=device_ms(lambda: score_topk(**kw),
                                "score_topk_kernel"),
            plain_ms=cuda_ms(lambda: score_topk_plain(**kw), reps=3),
            library_ms=cuda_ms(lambda: torch.topk(masked, k, dim=1)),
            bound_ms=b_ms, bound_by=b_by,
            bound_ms_all_pairs=bound(nbytes, ops_all)[0],
            bound_ms_mask_form=bound(mask_bytes, ops_all)[0],
            max_abs_err=err, shape=f"P={p} N={n} k={k} F={f} D={d}",
            feasible_pairs=n_feasible, needed_pairs=n_needed)
    return out


def k2_case(snap, pods, gen, p0, trying_frac, fit_dims, p=2000):
    """The chained gate of one inner step as schedule_batch forms it
    for the chunk [p0, p0 + p): the node level (choices spread over
    the 10^4 nodes, half of them on 64 popular ones) and the 2 quota
    levels of the flagship (segments from the chunk's pod_anc)."""
    dev = snap.nodes.allocatable.device
    batch = slice_batch(pods, p0, p)
    p = batch.num_pods
    n_nodes, quotas = snap.num_nodes, snap.quotas
    n_quotas = quotas.min.shape[0]
    trying = torch.rand((p,), generator=gen, device=dev) < trying_frac
    choice = torch.where(
        torch.rand((p,), generator=gen, device=dev) < 0.5,
        torch.randint(0, 64, (p,), generator=gen, device=dev),
        torch.randint(0, n_nodes, (p,), generator=gen, device=dev))
    choice_eff = torch.where(trying, choice, n_nodes).to(torch.int32)
    pod_anc = torch.where(
        batch.quota_id[:, None] >= 0,
        quotas.depth_ancestor[batch.quota_id.clamp_min(0).long()], -1)
    quota_seg = torch.where(pod_anc >= 0, pod_anc, n_quotas)[
        :, :QUOTA_DEPTH].T.to(torch.int32)
    # the root's headroom: half of what the trying pods ask for, so
    # that every level admits some pods and rejects others
    demand = (batch.requests * trying[:, None]).sum(dim=0)
    runtime = quotas.runtime
    root = torch.floor(torch.clamp_min(runtime[0] - 0.5 * demand, 0.0)
                       / 500.0) * 500.0
    used = quotas.used.clone()
    used[0] = torch.where(torch.isinf(runtime[0]), 0.0, root)
    quota_table = (used[:, fit_dims].contiguous(),
                   runtime[:, fit_dims].contiguous(), n_quotas)
    return dict(
        seg=torch.cat([choice_eff[None], quota_seg]).contiguous(),
        rank=rank_by_priority(batch),
        req=batch.requests[:, fit_dims].contiguous(), active=trying,
        tables=[(snap.nodes.requested[:, fit_dims].contiguous(),
                 snap.nodes.allocatable[:, fit_dims].contiguous(), n_nodes)]
        + [quota_table] * QUOTA_DEPTH, eps=EPS)


# K2 launches given no flag, held against the plain version: their
# verdicts (the order switch decided in the launch), one a k2_switch call
K2_FOLDED = []


def k2_switch(kw):
    """kw with K2's order switch decided (`exact_in_any_order` of its
    request arrays), so that a timed call runs the launch alone, as the
    main path's launches do where it decides the switch once a batch
    (check_order_switch times the switch itself). First the launch given
    no flag, which decides the switch in its own prologue (as the GPU,
    zone and amplified levels' launches do), is held against the plain
    version: the same gate, and a verdict equal to
    `exact_in_any_order_plain`'s and the switch kernel's (K2_FOLDED
    keeps it)."""
    reqs = [kw["req"]] + ([kw["req0"]] if kw.get("req0") is not None
                          else [])
    exact = exact_in_any_order(*reqs)
    plain = bool(exact_in_any_order_plain(*reqs))
    bare = {k: v for k, v in kw.items() if k != "exact"}
    decided = torch.empty((1,), dtype=torch.bool, device=kw["rank"].device)
    got = segment_prefix_chain(**bare, switch_out=decided)
    if not torch.equal(got, segment_prefix_chain_plain(**bare)) or not (
            bool(decided) == plain == bool(exact)):
        raise SystemExit(f"K2 deciding its own order switch: verdict "
                         f"{bool(decided)}, plain {plain}, switch kernel "
                         f"{bool(exact)}, or its gate differs from the "
                         f"plain version's")
    K2_FOLDED.append(plain)
    return dict(kw, exact=exact)


def check_k2(snap, pods, gen):
    """K2's chained gate (node + 2 quota levels, one launch) at P=2000:
    70 % of the pods trying (a round's first steps), 8 % trying (its
    late steps), and 70 % over all 11 dims; and one level alone (the
    single-level form), with the masked matmul of its prefix sums."""
    out = {}
    for label, p0, frac, fd in (("chain", 0, 0.7, FIT_DIMS),
                                ("chain 8% trying", 2000, 0.08, FIT_DIMS),
                                ("chain R=11", 4000, 0.7, ALL_DIMS),
                                ("node level", 6000, 0.7, FIT_DIMS)):
        kw = k2_case(snap, pods, gen, p0, frac, fd)
        if label == "node level":
            kw["seg"], kw["tables"] = kw["seg"][:1], kw["tables"][:1]
        kw = k2_switch(kw)
        got = segment_prefix_chain(**kw)
        want = segment_prefix_chain_plain(**kw)
        err = float((got.int() - want.int()).abs().max())
        if not torch.equal(got, want):
            raise SystemExit(f"K2 segment_prefix_chain ({label}) differs "
                             f"from its plain version at "
                             f"{(got != want).nonzero()[:5, 0].tolist()}")
        # the work this data needs (`k2_cost`), and on the single level
        # the same-segment earlier pairs the masked matmul multiplies
        p, r = kw["req"].shape
        nbytes, ops = k2_cost(kw)
        matched = 0
        if label == "node level":
            level, rank = kw["seg"][0], kw["rank"]
            inr = kw["active"] & (level < kw["tables"][0][2])
            mask = ((level[:, None] == level[None, :])
                    & (rank[None, :] < rank[:, None])
                    & inr[:, None] & inr[None, :])
            matched = int(mask.sum())
        b_ms, b_by = bound(nbytes, ops)
        library_ms = None
        if label == "node level":
            mask_f = mask.to(torch.float32)
            library_ms = cuda_ms(lambda: mask_f @ kw["req"])
        deciding = {}
        if label == "chain":
            # the same launch given no flag: it decides the order switch
            # in its prologue (the GPU, zone and amplified levels' form)
            bare = {k: v for k, v in kw.items() if k != "exact"}
            deciding = dict(
                deciding_ms=cuda_ms(lambda: segment_prefix_chain(**bare)),
                deciding_device_ms=device_ms(
                    lambda: segment_prefix_chain(**bare),
                    "segment_prefix_chain_kernel"))
        out[label] = dict(
            ms=cuda_ms(lambda: segment_prefix_chain(**kw)),
            device_ms=device_ms(lambda: segment_prefix_chain(**kw),
                                "segment_prefix_chain_kernel"),
            plain_ms=cuda_ms(lambda: segment_prefix_chain_plain(**kw)),
            library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, **deciding,
            max_abs_err=err,
            shape=f"P={p} L={len(kw['tables'])} R={r} "
                  f"S={[t[2] for t in kw['tables']]}",
            trying=int(kw["active"].sum()), accepted=int(got.sum()),
            matched_pairs=matched if label == "node level" else None)
    return out


def check_order_switch(snap, pods, gen):
    """K2's order switch (`exact_in_any_order`) against its plain version
    on the flagship's requests (whole numbers: True), the same with a
    third of a millicore, an infinity, a column of zeros, sums of
    magnitudes past f32's range (the kernel's f32 sum overflows: counted
    again in f64), and one with
    a per-level zone take as the NUMA step passes it (a [Z, P, 2] view
    of a [P, Z, 2] take) beside level 0's own requests; timed on the
    chained gate's requests (P = 2000, R = 4), where a batch decides it
    once (a K2 launch given no flag decides it itself: `k2_switch`
    holds that, check_k2 times it)."""
    kw = k2_case(snap, pods, gen, 0, 0.7, FIT_DIMS)
    req = kw["req"]
    third = req.clone()
    third[5, 0] += 1.0 / 3.0
    inf = req.clone()
    inf[7, 1] = float("inf")
    zeros = torch.zeros_like(req)
    take = torch.floor(torch.rand((2000, 2, 2), generator=gen,
                                  device=req.device) * 64.0) * 500.0
    # a column of multiples of 2^127 whose sum passes 2^128 (f32's sum
    # overflows) but not its bound 2^151; and one with a multiple of
    # 2^104 beside them, whose bound 2^128 the sum passes
    huge = torch.zeros_like(req[:3])
    huge[:, 0] = 2.0 ** 127
    at_bound = huge.clone()
    at_bound[2, 0] = 2.0 ** 104
    cases = {"whole numbers": ((req,), True), "a third": ((third,), False),
             "an infinity": ((inf,), False), "zeros": ((zeros,), True),
             "sum past f32": ((huge,), True),
             "sum past 2^128 at e = 104": ((at_bound,), False),
             "zone take and req0": ((take.transpose(0, 1), take[:, 0]),
                                    True),
             "fractional take": ((take.transpose(0, 1) + 0.1,), False)}
    out = {}
    for label, (arrays, want) in cases.items():
        got = exact_in_any_order(*arrays)
        plain = exact_in_any_order_plain(*arrays)
        if bool(got) != bool(plain) or bool(got) != want:
            raise SystemExit(f"order switch ({label}): {bool(got)}, plain "
                             f"version {bool(plain)}, expected {want}")
        out[label] = dict(exact=bool(got), max_abs_err=0.0)
    b_ms, b_by = bound(req.numel() * 4 + 1, req.numel())
    out["chain requests"] = dict(
        ms=cuda_ms(lambda: exact_in_any_order(req)),
        device_ms=device_ms(lambda: exact_in_any_order(req),
                            "order_switch_kernel"),
        plain_ms=cuda_ms(lambda: exact_in_any_order_plain(req)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=0.0,
        shape=f"P={req.shape[0]} R={req.shape[1]}")
    return out


def k3_equal(groups, label):
    """K3 against its plain version on the host, bit for bit: each group
    in the one-group form, then all of them in one grouped call, which
    must launch the kernel once."""
    plain = [ordered_scatter_add_plain(*(x.cpu() for x in g)) for g in groups]
    one = [ordered_scatter_add(*g).cpu() for g in groups]
    before = ordered_scatter_add.launches
    many = [o.cpu() for o in ordered_scatter_add_many(groups)]
    if ordered_scatter_add.launches != before + 1:
        raise SystemExit(f"K3 ({label}): a grouped call launched "
                         f"{ordered_scatter_add.launches - before} times")
    for form, outs in (("one-group", one), ("grouped", many)):
        for got, want in zip(outs, plain):
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                err = float((got - want).abs().max())
                raise SystemExit(f"K3 ordered_scatter_add ({label}, {form} "
                                 f"form) differs from its plain version on "
                                 f"the host, max abs err {err}")


def k3_work(groups):
    """(bytes, adds, kept entries, the hottest row's adds) of K3's
    function on these groups: each target read and written once, the
    indices read once, the rows some level keeps read once; an add a
    kept entry and column."""
    nbytes = adds = kept = hottest = 0
    for target, idx, rows in groups:
        s, c = target.shape
        levels = idx.reshape(-1, rows.shape[0])
        wrapped = torch.where(levels < 0, levels + s, levels)
        keep = (wrapped >= 0) & (wrapped < s)
        nbytes += 2 * s * c * 4 + levels.numel() * 4 \
            + int(keep.any(dim=0).sum()) * c * 4
        adds += int(keep.sum()) * c
        kept += int(keep.sum())
        if keep.any():
            hottest = max(hottest, int(torch.bincount(
                wrapped[keep].long(), minlength=s).max()))
    return nbytes, adds, kept, hottest


def k3_timed(groups, shape, library=None):
    """One case's numbers: events and device time of a grouped call of
    the groups, the plain version's, the library call's (one index_add_
    of the kept entries, one group only), the bound and the chain's
    floor (the hottest row's adds)."""
    nbytes, adds, kept, hottest = k3_work(groups)
    b_ms, b_by = bound(nbytes, adds)
    lib = None
    if library:
        target, idx, rows = groups[0]
        s = target.shape[0]
        levels = idx.reshape(-1, rows.shape[0])
        wrapped = torch.where(levels < 0, levels + s, levels)
        keep = (wrapped >= 0) & (wrapped < s)
        flat_idx = wrapped[keep].long()
        flat_rows = rows.expand(levels.shape[0], *rows.shape)[keep]
        lib = cuda_ms(lambda: target.clone().index_add_(0, flat_idx,
                                                        flat_rows))
    return dict(
        ms=cuda_ms(lambda: ordered_scatter_add_many(groups)),
        device_ms=device_ms(lambda: ordered_scatter_add_many(groups),
                            "ordered_scatter_add_kernel"),
        # torch's CUDA index_add_ under the plain version: atomics, no
        # fixed order (timed only)
        plain_ms=cuda_ms(lambda: ordered_scatter_add_many_plain(groups)),
        library_ms=lib, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
        shape=shape, groups=len(groups), kept=kept, hottest_row=hottest)


def full_gate_step_groups(dev, gen):
    """Eight K3 groups of the full gate's inner step at its widths
    (10 000 nodes and 64 slots, P = 2000, the NUMA and GPU prefixes):
    the zone takes [N + V, 4] of 768 pods, the instance takes [N + V,
    24] of 896 pods, the four count tables (spread 16 x 10 000,
    anti-affinity and carriers 16 x 10 000, affinity 8 x 10 000, a level
    a group, 2 % of the pods a group), requested [N + V, 11] and the
    quota levels [64, 11] x 2 of 2000 pods, every commit half the pods
    accepted, fractional rows."""
    n_ext, p = 10_064, 2000

    def frac(shape):
        return torch.rand(shape, generator=gen, device=dev) * 3000.0 + 0.1

    def nodes(rows, s=n_ext):
        i = torch.randint(0, s, (rows,), generator=gen, device=dev)
        off = torch.rand((rows,), generator=gen, device=dev) < 0.5
        return torch.where(off, s, i).to(torch.int32)

    def counts(g):
        i = torch.where(
            torch.rand((g, p), generator=gen, device=dev) < 0.02,
            torch.arange(g, device=dev)[:, None] * 10_000
            + torch.randint(0, 10_000, (g, p), generator=gen, device=dev),
            g * 10_000).to(torch.int32)
        return (torch.randint(0, 5, (g * 10_000, 1), generator=gen,
                              device=dev).to(torch.float32), i,
                torch.ones((p, 1), device=dev))

    quota_idx = torch.stack([
        torch.where(torch.rand((p,), generator=gen, device=dev) < 0.5, 0, 64),
        torch.randint(1, 65, (p,), generator=gen, device=dev)]).to(
            torch.int32)
    return [(frac((n_ext, 4)), nodes(768), -frac((768, 4))),
            (frac((n_ext, 24)), nodes(896), -frac((896, 24))),
            counts(16), counts(16), counts(16), counts(8),
            (frac((n_ext, 11)), nodes(p), frac((p, 11))),
            (frac((64, 11)), quota_idx, frac((p, 11)))]


def check_k3(snap, pods, gen):
    """K3 against its plain version on the host (bit for bit, one-group
    and grouped form, one launch a grouped call), then timed: the node
    commit (P=2000 rows into 10^4 targets, one level, repeats and
    drops), the quota commit (P=2000 into the 64-row quota table, 2
    levels from a real chunk's pod_anc, half the pods accepted: every
    accepted quota pod lands on the root at level 0), non-integer rows
    in both, and a step's count commit into a topology count table (16
    groups x 10^4 domains, one level a group, 2 % of the pods charging
    each group, rows of 1.0: gpu_share's spread and anti-affinity
    tables), with index_add_ as the library call; the order-sensitive
    hot row (`testing.scatter_cases.hot_row_case`: nine in ten indices
    on one row, rows of mixed magnitude) at P = 2000 and 50 000; the
    reservation rebuild's instance scatter (P = 2500 rows of C = 24
    into 64 slots, two levels, drops) in one call; and a grouped step
    of the full gate's eight commits at their widths
    (`full_gate_step_groups`). Untimed: indices below 0 (wrapped or
    dropped as in the reference). The plain version runs on the host,
    whose index_add_ adds in order (the card's uses atomics)."""
    dev = snap.nodes.allocatable.device
    s_node, c, p = snap.num_nodes, 11, 2000
    idx = torch.randint(0, s_node + 1, (p,), generator=gen, device=dev)
    idx = torch.where(torch.rand((p,), generator=gen, device=dev) < 0.5,
                      idx % 200, idx)                      # repeats
    idx = torch.where(torch.rand((p,), generator=gen, device=dev) < 0.2,
                      s_node, idx).to(torch.int32)          # drops
    quotas = snap.quotas
    n_quotas = quotas.min.shape[0]
    batch = slice_batch(pods, 0, p)
    pod_anc = torch.where(
        batch.quota_id[:, None] >= 0,
        quotas.depth_ancestor[batch.quota_id.clamp_min(0).long()], -1)
    take = torch.rand((p,), generator=gen, device=dev) < 0.5
    qidx = torch.where(take[:, None] & (pod_anc >= 0), pod_anc, n_quotas)[
        :, :QUOTA_DEPTH].T.to(torch.int32).contiguous()
    # negative indices: [-S, 0) wraps to S + idx, as in the reference
    # (no commit passes one; checked, not timed)
    neg = torch.randint(-n_quotas - 4, n_quotas + 4, (p,), generator=gen,
                        device=dev).to(torch.int32)
    k3_equal([(torch.rand((n_quotas, c), generator=gen, device=dev) * 5000.0,
               neg,
               torch.rand((p, c), generator=gen, device=dev) * 3000.0 + 0.1)],
             "negative indices")
    groups, domains_ = 16, 10_000
    cidx = torch.where(
        torch.rand((groups, p), generator=gen, device=dev) < 0.02,
        torch.arange(groups, device=dev)[:, None] * domains_
        + torch.randint(0, domains_, (groups, p), generator=gen, device=dev),
        groups * domains_).to(torch.int32)
    cases = {}
    for label, s, c, index in (("node commit", s_node, c, idx),
                               ("quota commit", n_quotas, c, qidx),
                               ("count commit", groups * domains_, 1, cidx)):
        if label == "count commit":
            target = torch.randint(0, 5, (s, c), generator=gen,
                                   device=dev).to(torch.float32)
            rows = torch.ones((p, c), device=dev)
        else:
            target = torch.rand((s, c), generator=gen, device=dev) * 5000.0
            rows = torch.rand((p, c), generator=gen, device=dev) * 3000.0 \
                + 0.1
        cases[label] = ([(target, index, rows)],
                        f"P={p} S={s} C={c} L={index.reshape(-1, p).shape[0]}",
                        True)
    for hp in (2000, 50_000):
        cases[f"hot row P={hp}"] = (
            [tuple(torch.from_numpy(x).to(dev)
                   for x in hot_row_case(hp, seed=hp))],
            f"P={hp} S=64 C=11 L=1, nine in ten on row 0", True)
    p_big, s_res, c_res = 2500, 64, 24
    cases["rebuild P=2500 C=24"] = (
        [(torch.rand((s_res, c_res), generator=gen, device=dev) * 5000.0,
          torch.randint(0, s_res + 2, (2, p_big), generator=gen,
                        device=dev).to(torch.int32),
          torch.rand((p_big, c_res), generator=gen, device=dev) * 3000.0)],
        f"P={p_big} S={s_res} C={c_res} L=2", True)
    cases["full gate step"] = (
        full_gate_step_groups(dev, gen),
        "eight groups: zones, instances, four count tables, requested, "
        "quota levels", False)
    out = {}
    for label, (grp, shape, library) in cases.items():
        k3_equal(grp, label)
        out[label] = k3_timed(grp, shape, library)
    return out


def with_zones(snap, gen, z):
    """`snap` with z NUMA zones a node: each node's cpu and memory split
    over its zones at random (the zones kept where z is the snapshot's
    own width), about 15 % of the zones invalid (zone 0 valid), zones
    partly used (multiples of 500 mC / 512 MiB, as commits leave them),
    every topology policy code on some nodes (a quarter each, at
    random), the reservations' zone columns z wide with no hold, and the
    GPU instances spread over the z zones in index order."""
    nodes, resv, d = snap.nodes, snap.reservations, snap.devices
    dev = nodes.allocatable.device
    n_nodes = snap.num_nodes
    if z != nodes.numa_cap.shape[1]:
        share = torch.rand((n_nodes, z), generator=gen, device=dev)
        share = share / share.sum(dim=1, keepdim=True)
        cap = torch.stack([
            torch.floor(nodes.allocatable[:, None, 0] * share / 500) * 500,
            torch.floor(nodes.allocatable[:, None, 1] * share / 512) * 512],
            dim=-1)
    else:
        cap = nodes.numa_cap
    valid = torch.rand((n_nodes, z), generator=gen, device=dev) < 0.85
    valid[:, 0] = True
    cap = (cap * valid[:, :, None]).contiguous()
    load = torch.rand((n_nodes, z, 1), generator=gen, device=dev) * 0.9
    used = torch.floor(cap * load / 500.0) * 500.0
    policy = torch.randint(0, 4, (n_nodes,), generator=gen, device=dev,
                           dtype=torch.int32)
    v, i = resv.numa_free.shape[0], d.gpu_numa.shape[1]
    zone_of = (torch.arange(i, device=dev, dtype=torch.int32) * z
               // max(i, 1))
    return snap.replace(
        nodes=nodes.replace(numa_cap=cap, numa_free=(cap - used).contiguous(),
                            numa_valid=valid, numa_policy=policy),
        reservations=resv.replace(
            numa_free=torch.zeros((v, z, 2), device=dev),
            numa_valid=torch.zeros((v, z), dtype=torch.bool, device=dev)),
        devices=d.replace(gpu_numa=torch.where(
            d.gpu_numa >= 0, zone_of[None, :], d.gpu_numa).contiguous()))


def numa_state(dev, gen, n_nodes, z=2):
    """BASELINE config 2's pods (seed 1, 60 % prod, prod pods NUMA-bound)
    against n_nodes nodes with z zones (`with_zones`)."""
    snap, pods = config_2_inputs(10_000, n_nodes, device=dev)
    return with_zones(snap, gen, z), pods


def k4_args(snap, batch, strategy):
    nodes = snap.nodes
    return (numaaware.zone_demand(batch), batch.numa_single.contiguous(),
            nodes.numa_cap, nodes.numa_free, nodes.numa_valid,
            nodes.numa_policy, strategy)


def check_k4(dev, gen):
    """K4 at a config-2 chunk (P=2000, N=1000, Z=2) and at the flagship's
    width (N=10 000), both strategies, and untimed at Z=4: policy nodes,
    invalid zones, partly used zones; timed at Z=8 (fault C8's width).
    Equal to the plain version (bools, scores bit for bit)."""
    out = {}
    for label, n, z, strategy, timed in (
            ("cfg2 most", 1000, 2, "most", True),
            ("cfg2 least", 1000, 2, "least", False),
            ("N=10000 most", 10_000, 2, "most", True),
            ("N=10000 least", 10_000, 2, "least", False),
            ("Z=4 most", 1000, 4, "most", False),
            ("Z=4 least", 1000, 4, "least", False),
            ("Z=8 most", 1000, 8, "most", True)):
        snap, pods = numa_state(dev, gen, n, z)
        batch = slice_batch(pods, 0, 2000)
        args = k4_args(snap, batch, strategy)
        ok, score = numa_pair_terms(*args)
        want_ok, want_score = numa_pair_terms_plain(*args)
        err = float((score - want_score).abs().max())
        if not (torch.equal(ok, want_ok) and torch.equal(
                score.view(torch.int32), want_score.view(torch.int32))):
            raise SystemExit(f"K4 numa_pair_terms ({label}) differs from its "
                             f"plain version, max abs err {err}")
        if not timed:
            out[label] = dict(max_abs_err=err, pairs_ok=int(ok.sum()))
            continue
        # bytes: the pod columns (demand, numa_single) and node columns
        # (cap, free, valid, policy) once, the two [P, N] outputs.
        # operations this data needs: per pair of a bound pod, the fit of
        # each zone (2 adds, 2 compares) and, per zone it fits, its score
        # (sub, add, div a dim, the mean's add and div, the max: 9; the
        # "least" form 2 more) and the clip and scale (3); per pair on a
        # policy node the combined fit (2 adds, 2 compares); per node the
        # total valid free (2 multiplies and adds a zone)
        p = batch.num_pods
        single = batch.numa_single
        req2 = args[0] * single[:, None]
        fits = (torch.all(snap.nodes.numa_free[None] + EPS
                          >= req2[:, None, None, :], dim=-1)
                & snap.nodes.numa_valid[None])           # [P, N, Z]
        n_fit = int(fits[single].sum())
        n_bound = int(single.sum()) * n
        n_policy = p * int((snap.nodes.numa_policy != 0).sum())
        ops = (n_bound * (4 * z + 3)
               + n_fit * (9 if strategy == "most" else 11)
               + n_policy * 4 + n * 4 * z)
        nbytes = p * 9 + n * (z * 17 + 4) + p * n * 5
        b_ms, b_by = bound(nbytes, ops)
        out[label] = dict(
            ms=cuda_ms(lambda: numa_pair_terms(*args)),
            device_ms=device_ms(lambda: numa_pair_terms(*args),
                                "numa_pair_terms_kernel"),
            plain_ms=cuda_ms(lambda: numa_pair_terms_plain(*args), reps=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err, shape=f"P={p} N={n} Z={z}",
            pairs_ok=int(ok.sum()), zone_fits=n_fit)
    return out


def k5_args(snap, batch, gen, trying_frac=0.7, zero_frac=0.05):
    """One inner step's K5 arguments: chosen nodes spread over the
    snapshot (half of them on 64 popular ones), a share of the pods
    trying, some with no cpu or memory request."""
    dev = snap.nodes.allocatable.device
    p, n = batch.num_pods, snap.num_nodes
    nodes = snap.nodes
    choice = torch.where(
        torch.rand((p,), generator=gen, device=dev) < 0.5,
        torch.randint(0, 64, (p,), generator=gen, device=dev),
        torch.randint(0, n, (p,), generator=gen, device=dev))
    trying = torch.rand((p,), generator=gen, device=dev) < trying_frac
    demand = numaaware.zone_demand(batch)
    demand = torch.where(
        torch.rand((p, 1), generator=gen, device=dev) < zero_frac, 0.0,
        demand).contiguous()
    return (torch.where(trying, choice, n).to(torch.int32), trying,
            batch.numa_single.contiguous(), demand, nodes.numa_cap,
            (nodes.numa_cap - nodes.numa_free).contiguous(),
            nodes.numa_valid, nodes.numa_policy)


def check_k5(dev, gen):
    """K5 at a config-2 chunk (P=2000, N=1000) at Z=2, 4 and 8 (all four
    policies on the nodes, NUMA-bound pods, zero requests), both
    strategies, and at P=1 and with every pod trying. Equal to the plain
    version (every output; takes bit for bit)."""
    out = {}
    for label, z, strategy, timed, kw in (
            ("cfg2 most", 2, "most", True, {}),
            ("cfg2 least", 2, "least", False, {}),
            ("Z=4 most", 4, "most", True, {}),
            ("Z=4 least", 4, "least", False, {}),
            ("all trying", 2, "most", False, dict(trying_frac=1.0)),
            ("zero requests", 4, "least", False, dict(zero_frac=0.5)),
            ("Z=8 most", 8, "most", True, {})):
        snap, pods = numa_state(dev, gen, 1000, z)
        batch = slice_batch(pods, 2000, 2000)
        args = k5_args(snap, batch, gen, **kw) + (strategy,)
        one = tuple(a[:1] if i < 4 else a for i, a in enumerate(args))
        for a in (args, one):   # and P = 1
            got, want = topology_admit(*a), topology_admit_plain(*a)
            for name, g, w in zip(got._fields, got, want):
                same = (torch.equal(g.view(torch.int32), w.view(torch.int32))
                        if g.dtype == torch.float32 else torch.equal(g, w))
                if not same:
                    raise SystemExit(f"K5 topology_admit ({label}, P="
                                     f"{a[0].shape[0]}) differs from its "
                                     f"plain version in {name}")
            if a is args:
                err = float((got.take - want.take).abs().max())
                full = got
        engaged = int(full.engaged.sum())
        admitted = int((full.admit & full.engaged).sum())
        if not timed:
            out[label] = dict(max_abs_err=err, engaged=engaged,
                              admitted=admitted)
            continue
        p = args[0].shape[0]
        b_ms, b_by = bound(*k5_cost(args, full, z))
        out[label] = dict(
            ms=cuda_ms(lambda: topology_admit(*args)),
            device_ms=device_ms(lambda: topology_admit(*args),
                                "topology_admit_kernel"),
            plain_ms=cuda_ms(lambda: topology_admit_plain(*args), reps=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err, shape=f"P={p} S=1000 Z={z}", engaged=engaged,
            admitted=admitted)
    return out


def check_k1_numa(dev, gen):
    """K1 with the NUMA pair mask and score addend of K4, at a config-2
    chunk (P=2000, N=1000, k=8, jitter on; timed) and, untimed, at the
    tail's k=32 without jitter, with negative estimates (rows the node
    bound does not hold for), and at the flagship's width (N=10 000).
    Equal to the plain version (indices, values bit for bit)."""
    out = {}
    for label, n, p, k, tie_break in (
            ("cfg2", 1000, 2000, 8, True),
            ("k=32, no jitter", 1000, 512, 32, False),
            ("negative estimates", 1000, 2000, 8, True),
            ("N=10000", 10_000, 2000, 8, True)):
        snap, pods = numa_state(dev, gen, n)
        alloc = snap.nodes.allocatable
        load = torch.rand(alloc.shape, generator=gen, device=dev) * 0.9
        snap = snap.replace(nodes=snap.nodes.replace(
            requested=torch.floor(alloc * load / 500.0) * 500.0))
        cfg = loadaware.LoadAwareConfig.make(device=dev)
        kw = k1_case(snap, pods, cfg, 0, p, k, gen, FIT_DIMS, SCORE_DIMS,
                     tie_break=tie_break)
        kw["pair_ok"], kw["pair_score"] = numa_pair_terms(
            *k4_args(snap, slice_batch(pods, 0, p), "most"))
        if label == "negative estimates":
            kw["est"][::3, 0] -= 3000.0
        (val, idx), err = k1_equal(f"NUMA addend, {label}", kw)
        if label != "cfg2":
            out[label] = dict(max_abs_err=err,
                              feasible_pairs=int((val >= 0).sum()))
            continue
        gates = kw["gates"]
        f, d = kw["req_fit"].shape[1], kw["est"].shape[1]
        checked = expand_gates(gates) & kw["pair_ok"] & kw["row_ok"][:, None]
        fit = torch.all(kw["req_fit"][:, None, :] + kw["requested_fit"][None]
                        <= kw["alloc_fit"][None] + EPS, dim=-1)
        n_rows = int(kw["row_ok"].sum())
        n_checked = int(checked.sum())
        n_feasible = int((checked & fit).sum())
        n_needed, n_terms = k1_needed_pairs(kw, checked, val, idx)
        active = int((kw["row_ok"] & gates.device_ok).sum())
        # as the slim K1's pruned bound (check_k1), plus the pair mask's
        # byte for each pair of an active row, the addend (4 bytes) and
        # one add to the node bound for each pair that passes the gates,
        # and one add for each pair whose score is needed.
        # `bound_ms_all_pairs`: as K1's all-pairs bound, plus the pair
        # mask and the addend of every pair (5 bytes) and one add a
        # feasible pair.
        shared = p * (f + d) * 4 + n * (2 * f + 3 * d) * 4 + d * 4 \
            + p * k * 8 + p * 9 + n * 8 + gates.selector_match.numel()
        nbytes = shared + active * n + n_checked * 4
        ops = active * n + n_checked + n * (3 + n_terms * (5 * d + 3)) \
            + n_needed * (2 * f + 8 * d + 5)
        ops_all = (n_rows * n + n_checked * 2 * f + n * (f + 2 * d)
                   + n_feasible * (8 * d + 5))
        b_ms, b_by = bound(nbytes, ops)
        masked = torch.where(checked & fit, tie_break_jitter(
            loadaware.least_requested_score(
                kw["est"], kw["prod_scored"], kw["node_term"],
                kw["prod_term"], kw["alloc_score"], gates.metric_fresh,
                kw["weights"], kw["fma_sum"]) + kw["pair_score"]), -1.0)
        out[label] = dict(
            ms=cuda_ms(lambda: score_topk(**kw)),
            device_ms=device_ms(lambda: score_topk(**kw),
                                "score_topk_kernel"),
            plain_ms=cuda_ms(lambda: score_topk_plain(**kw), reps=3),
            library_ms=cuda_ms(lambda: torch.topk(masked, k, dim=1)),
            bound_ms=b_ms, bound_by=b_by,
            bound_ms_all_pairs=bound(shared + p * n * 5, ops_all)[0],
            max_abs_err=err,
            shape=f"P={p} N={n} k={k} F={f} D={d} + pair score",
            feasible_pairs=n_feasible, needed_pairs=n_needed)
    return out


def zone_chain_kw(snap, batch, gen):
    """K2's arguments as the zone gates of a NUMA step (core.py:617-622):
    one level a zone, each pod's take in that zone from K5 as the
    level's request, segments the chosen node, each level's base and
    limit a zone's columns of the [N, Z * 2] zone tables; 90 % of the
    pods trying, 80 % of those K5 admits accepted by the earlier gates
    (`k2_switch` applied)."""
    dev = batch.valid.device
    n, z = snap.num_nodes, snap.nodes.numa_cap.shape[1]
    args = k5_args(snap, batch, gen, trying_frac=0.9)
    adm = topology_admit(*args, "most")
    choice, trying, used = args[0], args[1], args[5]
    accept = trying & adm.admit & (
        torch.rand(trying.shape, generator=gen, device=dev) < 0.8)
    used_flat = used.view(n, z * 2)
    cap_flat = snap.nodes.numa_cap.view(n, z * 2)
    return k2_switch(dict(
        seg=choice[None].expand(z, -1).contiguous(),
        rank=rank_by_priority(batch), req=adm.take.transpose(0, 1),
        active=accept & adm.engaged,
        tables=[(used_flat[:, 2 * i:2 * i + 2],
                 cap_flat[:, 2 * i:2 * i + 2], n) for i in range(z)],
        eps=EPS))


def check_k2_zones(dev, gen):
    """K2 as the zone gates of a NUMA step run it: 2 levels (one a zone),
    per-level requests (each pod's take in that zone, from K5), segments
    the chosen node, each level's base and limit a zone's columns of the
    [N, Z * 2] zone tables; at a config-2 chunk (P=2000, N=1000), and
    untimed at Z=4. Equal to the plain version."""
    out = {}
    for label, z, timed in (("zones", 2, True), ("zones Z=4", 4, False)):
        snap, pods = numa_state(dev, gen, 1000, z)
        batch = slice_batch(pods, 4000, 2000)
        kw = zone_chain_kw(snap, batch, gen)
        got = segment_prefix_chain(**kw)
        want = segment_prefix_chain_plain(**kw)
        err = float((got.int() - want.int()).abs().max())
        if not torch.equal(got, want):
            raise SystemExit(f"K2 segment_prefix_chain ({label}) differs "
                             f"from its plain version")
        if not timed:
            out[label] = dict(max_abs_err=err, active=int(kw["active"].sum()),
                              accepted=int(got.sum()))
            continue
        # as check_k2, level by level, with the level's own requests
        p, r, n = batch.num_pods, 2, snap.num_nodes
        alive = kw["active"]
        nbytes, ops = 2 * p + 4 * int(alive.sum()), 0
        for level, req_l, (base, limit, s) in zip(kw["seg"], kw["req"],
                                                  kw["tables"]):
            inr = alive & (level < s)
            n_in = int(inr.sum())
            n_seg = int(torch.unique(level[inr]).numel())
            nbytes += 4 * int(alive.sum()) + 2 * n_seg * r * 4 + 4 * r * n_in
            ops += n_in * r * 4
            alive = alive & segment_prefix_ok_plain(
                torch.where(alive, level, s).to(torch.int32), kw["rank"],
                torch.where(alive[:, None], req_l, 0.0), base, limit, s, EPS)
        b_ms, b_by = bound(nbytes, ops)
        out[label] = dict(
            ms=cuda_ms(lambda: segment_prefix_chain(**kw)),
            device_ms=device_ms(lambda: segment_prefix_chain(**kw),
                                "segment_prefix_chain_kernel"),
            plain_ms=cuda_ms(lambda: segment_prefix_chain_plain(**kw)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"P={p} L={z} R=2 S=[{n}]*{z} per-level req",
            active=int(kw["active"].sum()), accepted=int(got.sum()))
    return out


# --- the DeviceShare path's kernels (K6, K7, K5's GPU provider, K1's two
# addends) ------------------------------------------------------------------


def gpu_state(dev, gen, n_nodes, p0=0, p=2000, edge=False, gpus=8):
    """gpu_share_100kx10k's pods [p0, p0 + p) against n_nodes of its nodes
    (a quarter GPU nodes with `gpus` instances over two zones: 8 on the
    flagship, more where a node's GPUs are split into MIG slices), the
    instances
    partly used (integer shares of their totals, half untouched) and the
    zones partly used. With `edge`: 60 % GPU pods, a quarter of the pods
    asking for GPU memory in odd MiB, ratios 100 does not divide (150,
    250, 333) and larger multiples (300, 800); a third of the nodes with
    an odd per-GPU memory, 10 % of the instances invalid, 10 % of zone
    -1, and nodes on which no instance, one, or all fit. Returns
    (snapshot, batch)."""
    snap, pods = gpu_share_inputs(max(p0 + p, 10_000), n_nodes, device=dev,
                                  gpus_per_node=gpus)
    batch = slice_batch(pods, p0, p)
    d = snap.devices
    n, i, _ = d.gpu_free.shape
    total, valid, numa = d.gpu_total.clone(), d.gpu_valid, d.gpu_numa
    if edge:
        total[::3, 1] = torch.where(total[::3, 1] > 0, 40007.0, 0.0)
    full = total[:, None, :].expand(n, i, 3)
    free = torch.floor(full * torch.rand((n, i, 1), generator=gen,
                                         device=dev))
    keep = torch.rand((n, i), generator=gen, device=dev) < 0.5
    free = torch.where(keep[..., None], full, free)
    if edge:
        group = torch.arange(n, device=dev) % 7
        free = torch.where((group == 0)[:, None, None], 0.0, free)
        free = torch.where((group == 1)[:, None, None], full, free)
        one = (group == 2)[:, None] & (torch.arange(i, device=dev) > 0)
        free = torch.where(one[..., None], 0.0, free)
        valid = valid & (torch.rand((n, i), generator=gen, device=dev) < 0.9)
        numa = torch.where(torch.rand((n, i), generator=gen, device=dev)
                           < 0.1, -1, numa).to(torch.int32)
        req, ratio = batch.requests.clone(), batch.gpu_ratio.clone()
        shapes = torch.tensor([50.0, 100.0, 200.0, 400.0], device=dev)
        gpu = torch.rand((p,), generator=gen, device=dev) < 0.6
        ratio = torch.where(gpu, shapes[torch.randint(
            0, 4, (p,), generator=gen, device=dev)], 0.0)
        odd = torch.tensor([150.0, 250.0, 300.0, 333.0, 800.0], device=dev)
        ratio = torch.where(
            torch.rand((p,), generator=gen, device=dev) < 0.15,
            odd[torch.randint(0, 5, (p,), generator=gen, device=dev)], ratio)
        req[:, deviceshare.GPU_CORE] = ratio
        mem = torch.rand((p,), generator=gen, device=dev) < 0.25
        req[:, deviceshare.GPU_MEMORY] = torch.where(
            mem, torch.randint(1, 90_000, (p,), generator=gen,
                               device=dev).to(torch.float32), 0.0)
        batch = batch.replace(requests=req, gpu_ratio=ratio)
    cap = snap.nodes.numa_cap
    used = torch.floor(cap * torch.rand((n, cap.shape[1], 1), generator=gen,
                                        device=dev) * 0.8 / 500.0) * 500.0
    snap = snap.replace(
        nodes=snap.nodes.replace(numa_free=(cap - used).contiguous()),
        devices=d.replace(gpu_total=total, gpu_free=free.contiguous(),
                          gpu_valid=valid, gpu_numa=numa))
    return snap, batch


def gpu_req_of(batch):
    return deviceshare.gpu_request(batch.requests,
                                   batch.gpu_ratio).contiguous()


def check_k6(dev, gen):
    """K6 at a gpu_share chunk (P=2000 against N=10 000 nodes, I=8),
    ANDing into a pair mask in place, both strategies; untimed, the edge
    state at N=1000 (odd memory, invalid and zone -1 instances, nodes
    where none, one or all fit, memory-specified and non-divisible
    requests), without a mask, and P=1; timed at I=56 against N=1000
    (8 GPUs in 7 MIG slices: the wide build). Equal to the plain version
    (bools, scores bit for bit)."""
    out = {}
    for label, n, edge, strategy, p, mask, timed, gpus in (
            ("gpu_share least", 10_000, False, "least", 2000, True, True, 8),
            ("gpu_share most", 10_000, False, "most", 2000, True, False, 8),
            ("edge least", 1000, True, "least", 2000, True, False, 8),
            ("edge most, no mask", 1000, True, "most", 2000, False, False,
             8),
            ("P=1", 1000, True, "least", 1, True, False, 8),
            ("I=56 least", 1000, False, "least", 2000, True, True, 56)):
        snap, batch = gpu_state(dev, gen, n, 2000, p, edge, gpus)
        n, p = snap.num_nodes, batch.num_pods
        gpu_req, d = gpu_req_of(batch), snap.devices
        pair = (torch.rand((p, n), generator=gen, device=dev) < 0.8
                if mask else None)
        ok, score = device_pair_terms(
            gpu_req, d, strategy, None if pair is None else pair.clone())
        want_ok, want_score = device_pair_terms_plain(gpu_req, d, strategy,
                                                      pair)
        err = float((score - want_score).abs().max())
        if not (torch.equal(ok, want_ok) and torch.equal(
                score.view(torch.int32), want_score.view(torch.int32))):
            raise SystemExit(f"K6 device_pair_terms ({label}) differs from "
                             f"its plain version, max abs err {err}")
        n_gpu = int((gpu_req > 0).any(dim=1).sum())
        if not timed:
            out[label] = dict(max_abs_err=err, pairs_ok=int(ok.sum()),
                              gpu_pods=n_gpu)
            continue
        # bytes: the pod columns (3 floats), the node columns (total,
        # and each instance's free and valid byte) once, the mask read
        # and written and the score written. Operations this data needs:
        # one for each pair of a pod without a GPU request; for each
        # pair of a GPU pod, the per-instance request (20), each
        # instance's fit (7) and the pool score (25)
        i = d.gpu_free.shape[1]
        nbytes = p * 12 + n * (12 + i * 13) + p * n * 6
        ops = (p - n_gpu) * n + n_gpu * n * (45 + 7 * i)
        b_ms, b_by = bound(nbytes, ops)
        buf = pair.clone()
        out[label] = dict(
            ms=cuda_ms(lambda: device_pair_terms(gpu_req, d, strategy, buf)),
            device_ms=device_ms(
                lambda: device_pair_terms(gpu_req, d, strategy, buf),
                "device_pair_terms_kernel"),
            plain_ms=cuda_ms(lambda: device_pair_terms_plain(
                gpu_req, d, strategy, pair), reps=3),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"P={p} N={n} I={i} and-into mask", gpu_pods=n_gpu,
            pairs_ok=int(ok.sum()))
    return out


def gpu_step(snap, batch, gen):
    """One inner step's K5/K7 operands at a gpu_share state: GPU pods
    choose GPU nodes (half of them among 16 popular ones, so shared and
    multi-GPU pods contend for instances), the others any node; 90 % of
    the pods trying and 85 % of those admitted by the node and quota
    gates; every topology policy code on the nodes. Returns a dict."""
    dev = batch.valid.device
    p, n = batch.num_pods, snap.num_nodes
    gpu_nodes = snap.devices.gpu_valid.any(dim=1).nonzero()[:, 0]
    gpu = (gpu_req_of(batch) > 0).any(dim=1)
    g = gpu_nodes[torch.where(
        torch.rand((p,), generator=gen, device=dev) < 0.5,
        torch.randint(0, 16, (p,), generator=gen, device=dev),
        torch.randint(0, gpu_nodes.numel(), (p,), generator=gen,
                      device=dev))]
    choice = torch.where(gpu, g, torch.randint(0, n, (p,), generator=gen,
                                               device=dev))
    trying = torch.rand((p,), generator=gen, device=dev) < 0.9
    nodes = snap.nodes.replace(numa_policy=torch.randint(
        0, 4, (n,), generator=gen, device=dev, dtype=torch.int32))
    return dict(
        choice=torch.where(trying, choice, n).to(torch.int32), trying=trying,
        accept=trying & (torch.rand((p,), generator=gen, device=dev) < 0.85),
        nodes=nodes, rank=rank_by_priority(batch),
        gpu_req=gpu_req_of(batch), demand=numaaware.zone_demand(batch),
        numa_single=batch.numa_single.contiguous())


def k5_gpu_args(snap, st, strategy):
    nodes = st["nodes"]
    return (st["choice"], st["trying"], st["numa_single"], st["demand"],
            nodes.numa_cap, (nodes.numa_cap - nodes.numa_free).contiguous(),
            nodes.numa_valid, nodes.numa_policy, strategy, st["gpu_req"],
            snap.devices)


def same_outputs(name, got, want):
    """Every field equal (f32 bit for bit); a field the plain version
    leaves None is the kernel's scratch (K7's take words) and is not
    compared."""
    for field, g, w in zip(got._fields, got, want):
        if w is None:
            continue
        ok = (torch.equal(g.view(torch.int32), w.view(torch.int32))
              if g.dtype == torch.float32 else torch.equal(g, w))
        if not ok:
            raise SystemExit(f"{name} differs from its plain version in "
                             f"{field}")


def check_k5_gpu(dev, gen):
    """K5 with DeviceShare's hint provider at a gpu_share step (P=2000,
    S=10 000, Z=2, I=8), both strategies, every policy code, and over
    the extended rows of the 64 reservation slots holding zones and
    instances (S=10 064; timed too); untimed, the edge state (zone -1
    and invalid instances, nodes where none, one or all fit) and P=1.
    Equal to the plain version."""
    out = {}
    for label, n, edge, strategy, p, timed, slots in (
            ("gpu_share most", 10_000, False, "most", 2000, True, False),
            ("gpu_share + slot rows", 10_000, False, "most", 2000, True,
             True),
            ("gpu_share least", 10_000, False, "least", 2000, False, False),
            ("edge most", 1000, True, "most", 2000, False, False),
            ("P=1", 1000, True, "least", 1, False, False)):
        snap, batch = gpu_state(dev, gen, n, 4000, p, edge)
        n, p = snap.num_nodes, batch.num_pods
        st = gpu_step(snap, batch, gen)
        if slots:
            snap, st = with_slot_rows(snap, st, gen)
            n = snap.devices.gpu_free.shape[0]
        args = k5_gpu_args(snap, st, strategy)
        got, want = topology_admit(*args), topology_admit_plain(*args)
        same_outputs(f"K5 topology_admit with the GPU provider ({label})",
                     got, want)
        err = float((got.take - want.take).abs().max())
        engaged = int(got.engaged.sum())
        gpu_engaged = int((got.engaged & (st["gpu_req"] > 0).any(1)).sum())
        if not timed:
            out[label] = dict(max_abs_err=err, engaged=engaged,
                              gpu_engaged=gpu_engaged,
                              admitted=int((got.admit & got.engaged).sum()))
            continue
        # as check_k5, plus the pods' GPU requests (12 bytes), the chosen
        # nodes' instance rows (13 bytes an instance, once a node), and
        # for each engaged pod the per-instance request (20), each
        # instance's fit (8) and the count provider over the M masks
        # (Z + 3 a mask)
        z = snap.nodes.numa_cap.shape[1]
        i = snap.devices.gpu_free.shape[1]
        m = 1 << z
        n_rows = int(torch.unique(st["choice"][st["trying"]]).numel())
        nbytes = (p * 14 + n_rows * (z * 17 + 4) + p * (z * 17 + 6)
                  + p * 12 + n_rows * (12 + 13 * i))
        ops = (engaged * (m * (8 * z + 13) + 10 * z + 2 + 20 + 8 * i
                          + m * (z + 3)) + (p - engaged) * 2)
        b_ms, b_by = bound(nbytes, ops)
        out[label] = dict(
            ms=cuda_ms(lambda: topology_admit(*args)),
            device_ms=device_ms(lambda: topology_admit(*args),
                                "topology_admit_kernel"),
            plain_ms=cuda_ms(lambda: topology_admit_plain(*args), reps=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"P={p} S={n} Z={z} I={i}", engaged=engaged,
            gpu_engaged=gpu_engaged)
    return out


def k7_chain(label, snap, st, strategy, numa=True):
    """K7's choose launch, the K2 gate and K7's take launch of one inner
    step on a gpu_step state `st` (the affinity from K5 with `numa`, the
    topology manager off without), each held to its plain version (the
    take on the kernel's K2 result, which is held to K2's plain version
    too). Returns the operands and results by name."""
    dev = st["trying"].device
    d = snap.devices
    n, i = d.gpu_valid.shape
    zone = (None, None)
    if numa:
        adm = topology_admit(*k5_gpu_args(snap, st, "most"))
        zone = (adm.affinity, adm.engaged)
    base = (st["choice"], st["accept"], st["gpu_req"], d, *zone, strategy)
    pick = gpu_instance_pick(*base)
    same_outputs(f"K7 gpu_instance_pick choose ({label})", pick,
                 gpu_choose_plain(*base))
    gate_base = torch.zeros((n * i, 3), device=dev)
    one_pod = torch.zeros((n, 3), device=dev)
    one_pod[:, 0] = 1.0
    chain = dict(seg=pick.seg, rank=st["rank"], req=pick.req,
                 active=pick.gate_active,
                 tables=[(gate_base, d.gpu_free.view(n * i, 3), n * i),
                         (gate_base[:n], one_pod, n)], eps=EPS)
    chain = k2_switch(chain)
    alive = segment_prefix_chain(**chain)
    if not torch.equal(alive, segment_prefix_chain_plain(**chain)):
        raise SystemExit(f"K2 as the GPU gate ({label}) differs from its "
                         "plain version")
    take_args = (st["choice"], alive, st["gpu_req"], d, *zone, strategy)
    fin = gpu_instance_pick(*take_args, chosen=pick)
    same_outputs(f"K7 gpu_instance_pick take ({label})", fin,
                 gpu_take_plain(st["choice"], alive, pick, d, *zone))
    count = pick.count
    stats = dict(
        shared_tried=int((st["accept"] & (count == 1)).sum()),
        shared_took=int((fin.accept & (count == 1)).sum()),
        multi_tried=int((st["accept"] & (count > 1)).sum()),
        multi_took=int((fin.accept & (count > 1)).sum()),
        instances_taken=int(fin.take.sum()))
    return dict(base=base, pick=pick, chain=chain, alive=alive,
                take_args=take_args, fin=fin, zone=zone, stats=stats)


# K7's kernels by symbol: its choose launch, and its take launch (one
# kernel since the take's redesign)
K7_CHOOSE = "gpu_choose_kernel"
K7_TAKE = "gpu_take_kernel"


def k7_take_cost(st, pick, alive, i):
    """(bytes, operations) of K7's take: the pods' columns and the
    multi-GPU pods' node rows, the outputs (1 + I bytes a pod); per
    multi-GPU pod 9 operations an instance, and one OR a surviving
    shared pod."""
    p = st["choice"].shape[0]
    count = pick.count
    multi = st["accept"] & (count > 1)
    rows_multi = int(torch.unique(st["choice"][multi]).numel())
    n_shared = int((alive & (count == 1)).sum())
    return (p * 25 + rows_multi * 13 * i + p * (1 + i),
            int(multi.sum()) * 9 * i + n_shared)


def check_k7(dev, gen):
    """K7's two launches and the K2 gate between them at a gpu_share
    step (P=2000, N=10 000, I=8, the affinity from K5), both strategies,
    and over the extended rows of the 64 reservation slots holding
    instances and zones (N + V = 10 064; timed too); untimed, the edge
    state (none, one or all instances fitting, zone -1 and invalid
    instances), the topology manager off, and P=1; then each of those
    untimed at I = 24 and 56 (MIG slices; the lanes' second instance
    word past 32). Each launch equal to its plain version on the same
    inputs (`k7_chain`)."""
    out = {}
    cases = [
        ("gpu_share least", 10_000, False, "least", True, 2000, True,
         False, 8),
        ("gpu_share + slot rows", 10_000, False, "least", True, 2000,
         True, True, 8),
        ("gpu_share most", 10_000, False, "most", True, 2000, False,
         False, 8),
        ("edge least", 1000, True, "least", True, 2000, False, False, 8),
        ("edge most, NUMA off", 1000, True, "most", False, 2000, False,
         False, 8),
        ("P=1", 1000, True, "least", True, 1, False, False, 8)]
    for gpus in C8_GPUS:
        cases += [(f"I={gpus} {label}", n, edge, strategy, numa, p, False,
                   False, gpus)
                  for label, n, edge, strategy, numa, p, _, _, _ in cases[2:6]]
        cases.append((f"I={gpus} gpu_share least", 1000, False, "least",
                      True, 2000, False, False, gpus))
    for label, n, edge, strategy, numa, p, timed, slots, gpus in cases:
        snap, batch = gpu_state(dev, gen, n, 6000, p, edge, gpus)
        n, p = snap.num_nodes, batch.num_pods
        st = gpu_step(snap, batch, gen)
        if slots:
            snap, st = with_slot_rows(snap, st, gen)
            n = snap.devices.gpu_free.shape[0]
        r = k7_chain(label, snap, st, strategy, numa)
        if not timed:
            out[label] = dict(max_abs_err=0.0, **r["stats"])
            continue
        activities = k7_activities(r)
        # choose: the pods' columns (choice, active, GPU request,
        # affinity, engaged) and the chosen nodes' instance rows once a
        # node, the outputs (45 bytes a pod); per GPU pod the
        # per-instance request (20) and 9 a fitting test and key per
        # instance
        d, pick, base = snap.devices, r["pick"], r["base"]
        take_args, alive, chain = r["take_args"], r["alive"], r["chain"]
        i = d.gpu_free.shape[1]
        n_gpu = int((pick.count > 0).sum())
        rows = int(torch.unique(st["choice"][pick.count > 0]).numel())
        b_choose = bound(p * 21 + rows * (12 + 13 * i) + p * 45,
                         n_gpu * (20 + 9 * i))
        b_take = bound(*k7_take_cost(st, pick, alive, i))
        chosen = gpu_instance_pick(*base)
        ms_c = cuda_ms(lambda: gpu_instance_pick(*base))
        ms_t = cuda_ms(lambda: gpu_instance_pick(*take_args, chosen=chosen))
        dev_c = device_ms(lambda: gpu_instance_pick(*base), K7_CHOOSE)
        dev_t = device_ms(lambda: gpu_instance_pick(*take_args,
                                                    chosen=chosen), K7_TAKE)
        plain_c = cuda_ms(lambda: gpu_choose_plain(*base), reps=5)
        plain_t = cuda_ms(lambda: gpu_take_plain(
            st["choice"], alive, pick, d, *r["zone"]), reps=5)
        by = b_choose[1] if b_choose[0] >= b_take[0] else b_take[1]
        out[label] = dict(
            ms=ms_c + ms_t, device_ms=dev_c + dev_t,
            plain_ms=plain_c + plain_t, library_ms=None,
            bound_ms=b_choose[0] + b_take[0], bound_by=by, max_abs_err=0.0,
            shape=f"P={p} N={n} I={i}, choose + take",
            choose=dict(ms=ms_c, device_ms=dev_c, plain_ms=plain_c,
                        bound_ms=b_choose[0], bound_by=b_choose[1]),
            take=dict(ms=ms_t, device_ms=dev_t, plain_ms=plain_t,
                      bound_ms=b_take[0], bound_by=b_take[1]),
            gpu_gate=dict(
                ms=cuda_ms(lambda: segment_prefix_chain(**chain)),
                device_ms=device_ms(lambda: segment_prefix_chain(**chain),
                                    "segment_prefix_chain_kernel"),
                shape=f"P={p} L=2 R=3 S=[{n * i}, {n}]"),
            activities=activities, **r["stats"])
    return out


def k7_activities(r, reps=10):
    """The device activities of K7's launches on a `k7_chain` result,
    from torch.profiler's device trace of `reps` calls: a take launch
    alone must be one activity (its kernel) and a step's K7 work (the
    choose launch, then the take on its result) two; anything else on
    the device (a memset, a second kernel) fails the run. Returns the
    activities a call."""
    base, take_args = r["base"], r["take_args"]
    chosen = gpu_instance_pick(*base)
    out = {}
    for label, fn, want in (
            ("take", lambda: gpu_instance_pick(*take_args, chosen=chosen), 1),
            ("step", lambda: gpu_instance_pick(
                *take_args, chosen=gpu_instance_pick(*base)), 2)):
        fn()
        torch.cuda.synchronize()
        # the tracer may miss launches (device_ms): trace again when it
        # saw fewer than it must, never accept more
        for _ in range(6):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            other = [x for x in names if K7_CHOOSE not in x
                     and K7_TAKE not in x]
            if len(names) > want * reps or other:
                raise SystemExit(f"K7's {label}: {len(names)} device "
                                 f"activities in {reps} calls, not "
                                 f"{want * reps}: {sorted(set(names))}")
            if len(names) == want * reps:
                break
        else:
            raise SystemExit(f"K7's {label}: six traces missed launches")
        out[label] = len(names) / reps
    return out


def check_k1_gpu(dev, gen):
    """K1 with two pair addends, K4's zone score then K6's pool score,
    and both gates in its pair mask, at a gpu_share chunk (P=2000,
    N=10 000, k=8, jitter on; timed); untimed, the tail's k=32 without
    jitter, negative estimates, and the NUMA path off (K6's score the
    only addend). Equal to the plain version."""
    out = {}
    cfg = loadaware.LoadAwareConfig.make(device=dev)
    for label, n, p, k, tie_break, numa in (
            ("gpu_share", 10_000, 2000, 8, True, True),
            ("k=32, no jitter", 10_000, 512, 32, False, True),
            ("negative estimates", 1000, 2000, 8, True, True),
            ("NUMA off", 1000, 2000, 8, True, False)):
        snap, batch = gpu_state(dev, gen, n, 8000, p)
        n, p = snap.num_nodes, batch.num_pods
        alloc = snap.nodes.allocatable
        load = torch.rand(alloc.shape, generator=gen, device=dev) * 0.9
        snap = snap.replace(nodes=snap.nodes.replace(
            requested=torch.floor(alloc * load / 500.0) * 500.0))
        kw = k1_case(snap, batch, cfg, 0, p, k, gen, FIT_DIMS, SCORE_DIMS,
                     tie_break=tie_break)
        mask = None
        if numa:
            mask, kw["pair_score"] = numa_pair_terms(
                *k4_args(snap, batch, "most"))
        mask, dev_score = device_pair_terms(gpu_req_of(batch), snap.devices,
                                            "least", mask)
        kw["pair_ok"] = mask
        if numa:
            kw["pair_score2"] = dev_score
        else:
            kw["pair_score"] = dev_score
        if label == "negative estimates":
            kw["est"][::3, 0] -= 3000.0
        (val, idx), err = k1_equal(f"two addends, {label}", kw)
        if label != "gpu_share":
            out[label] = dict(max_abs_err=err,
                              feasible_pairs=int((val >= 0).sum()))
            continue
        gates = kw["gates"]
        f, d = kw["req_fit"].shape[1], kw["est"].shape[1]
        checked = expand_gates(gates) & kw["pair_ok"] & kw["row_ok"][:, None]
        fit = torch.all(kw["req_fit"][:, None, :] + kw["requested_fit"][None]
                        <= kw["alloc_fit"][None] + EPS, dim=-1)
        n_rows = int(kw["row_ok"].sum())
        n_checked = int(checked.sum())
        n_feasible = int((checked & fit).sum())
        n_needed, n_terms = k1_needed_pairs(kw, checked, val, idx)
        active = int((kw["row_ok"] & gates.device_ok).sum())
        # as K1 with one addend (check_k1_numa), with the second addend
        # read (4 bytes) and added (one operation) wherever the first is,
        # and the taint term (`k1_taint_cost`)
        t_bytes, t_ops = k1_taint_cost(kw, n_checked)
        shared = p * (f + d) * 4 + n * (2 * f + 3 * d) * 4 + d * 4 \
            + p * k * 8 + p * 9 + n * 8 + gates.selector_match.numel() \
            + t_bytes
        nbytes = shared + active * n + n_checked * 8
        ops = active * n + 2 * n_checked + n * (3 + n_terms * (5 * d + 3)) \
            + n_needed * (2 * f + 8 * d + 6) + t_ops
        ops_all = (n_rows * n + n_checked * 2 * f + n * (f + 2 * d)
                   + n_feasible * (8 * d + 6))
        b_ms, b_by = bound(nbytes, ops)
        masked = k1_masked(kw)
        out[label] = dict(
            ms=cuda_ms(lambda: score_topk(**kw)),
            device_ms=device_ms(lambda: score_topk(**kw),
                                "score_topk_kernel"),
            plain_ms=cuda_ms(lambda: score_topk_plain(**kw), reps=3),
            library_ms=cuda_ms(lambda: torch.topk(masked, k, dim=1)),
            bound_ms=b_ms, bound_by=b_by,
            bound_ms_all_pairs=bound(shared + p * n * 9, ops_all)[0],
            max_abs_err=err,
            shape=f"P={p} N={n} k={k} F={f} D={d} + two pair scores",
            feasible_pairs=n_feasible, needed_pairs=n_needed,
            both_addends=int(((kw["pair_score"] > 0)
                              & (kw["pair_score2"] > 0) & checked).sum()))
    return out


def k1_masked(kw):
    """The masked [P, N + V] matrix of K1's arguments `kw`, which one
    `torch.topk` call selects from (the library yardstick)."""
    return masked_scores(**{key: x for key, x in kw.items() if key != "k"})


def k1_taint_cost(kw, n_checked):
    """(bytes, operations) the taint term adds to K1's bound: the pods'
    toleration ids and the nodes' taint groups (4 bytes each) and both
    tables (5 bytes an entry) read once; a subtraction and a floor for
    each pair that passes the gates (`n_checked`)."""
    gates = kw["gates"]
    if gates.tol_forbid is None:
        return 0, 0
    p, n = gates.toleration_id.shape[0], gates.taint_group.shape[0]
    return p * 4 + n * 4 + gates.tol_forbid.numel() * 5, 2 * n_checked


def with_slots(snap, batch, kw, gen, owners=0.3, block=0.3):
    """K1's arguments `kw` (from k1_case on snap and batch) with the
    snapshot's V reservation slots as columns N..N+V-1, as
    schedule_batch forms them (`slot_columns`): a share `owners` of the
    pods owning a random slot, each slot's free partly used (integer
    shares), a share `block` of them taken once slots."""
    dev = batch.valid.device
    p, v = batch.num_pods, snap.reservations.valid.shape[0]
    owner = torch.where(
        torch.rand((p,), generator=gen, device=dev) < owners,
        torch.randint(0, v, (p,), generator=gen, device=dev,
                      dtype=torch.int32), batch.reservation_owner)
    slot_ok, free, _ = slot_columns(
        snap, batch.replace(reservation_owner=owner), kw["gates"])
    used = torch.floor(free * torch.rand((v, 1), generator=gen, device=dev)
                       / 500.0) * 500.0
    kw.update(
        slot_ok=slot_ok,
        slot_block=torch.rand((v,), generator=gen, device=dev) < block,
        requested_fit=torch.cat([kw["requested_fit"],
                                 used[:, FIT_DIMS]]).contiguous(),
        alloc_fit=torch.cat([kw["alloc_fit"],
                             free[:, FIT_DIMS]]).contiguous())
    return kw


def check_k1_slots(dev, gen):
    """K1 with the taint term and the reservation slot columns at a
    gpu_share chunk (P=2000 against N=10 000 nodes and V=64 slots, both
    addends, a third of the slots taken once slots; timed), and
    untimed: the tail's setting (P=512, N=10 000, V=64, k=32, jitter,
    both addends), the taint term with no addend and with one, k=32
    without jitter, N=16 with k=24 (the selection reaches into the
    slot columns), toleration ids and taint groups out of the tables'
    range, a penalty table of zeros, and slots without taints. Equal to
    the plain version."""
    out = {}
    cfg = loadaware.LoadAwareConfig.make(device=dev)
    for label, n, p, k, tie_break, adds, slots, edit in (
            ("gpu_share", 10_000, 2000, 8, True, 2, True, None),
            ("gpu_share tail", 10_000, 512, 32, True, 2, True, None),
            ("taints, no addend", 10_000, 2000, 8, True, 0, False, None),
            ("taints, NUMA addend", 1000, 2000, 8, True, 1, False, None),
            ("k=32, no jitter", 1000, 512, 32, False, 2, True, None),
            ("N=16, k=24", 16, 512, 24, True, 2, True, None),
            ("taint indices out of range", 1000, 2000, 8, True, 2, True,
             "wild"),
            ("penalties all zero", 1000, 2000, 8, True, 2, True, "zero"),
            ("slots, no taints", 1000, 2000, 8, True, 0, True,
             "no taints")):
        snap, batch = gpu_state(dev, gen, n, 8000, p)
        n, p = snap.num_nodes, batch.num_pods
        alloc = snap.nodes.allocatable
        load = torch.rand(alloc.shape, generator=gen, device=dev) * 0.9
        snap = snap.replace(nodes=snap.nodes.replace(
            requested=torch.floor(alloc * load / 500.0) * 500.0))
        if edit == "wild":
            t, g = batch.tol_forbid.shape
            batch = batch.replace(toleration_id=torch.randint(
                -3, t + 3, (p,), generator=gen, device=dev,
                dtype=torch.int32))
            snap = snap.replace(nodes=snap.nodes.replace(
                taint_group=torch.randint(-g - 3, g + 3, (n,), generator=gen,
                                          device=dev, dtype=torch.int32)))
        if edit == "zero":
            batch = batch.replace(tol_prefer=torch.zeros_like(
                batch.tol_prefer))
        if edit == "no taints":
            batch = batch.replace(has_taints=False)
        kw = k1_case(snap, batch, cfg, 0, p, k, gen, FIT_DIMS, SCORE_DIMS,
                     tie_break=tie_break)
        mask = None
        if adds:
            mask, kw["pair_score"] = numa_pair_terms(
                *k4_args(snap, batch, "most"))
        if adds == 2:
            mask, kw["pair_score2"] = device_pair_terms(
                gpu_req_of(batch), snap.devices, "least", mask)
        kw["pair_ok"] = mask
        if slots:
            kw = with_slots(snap, batch, kw, gen)
        (val, idx), err = k1_equal(f"taints and slots, {label}", kw)
        on_slot = int((idx >= n).sum())
        stats = dict(max_abs_err=err, feasible=int((val >= 0).sum()),
                     on_slot=on_slot, floored=int((
                         (val >= 0) & (val < 0.5)).sum()))
        if label != "gpu_share":
            out[label] = stats
            continue
        gates = kw["gates"]
        f, d = kw["req_fit"].shape[1], kw["est"].shape[1]
        v = kw["slot_ok"].shape[1]
        checked = expand_gates(gates) & kw["pair_ok"] & kw["row_ok"][:, None]
        n_checked = int(checked.sum())
        n_needed, n_terms = k1_needed_pairs(kw, checked, val, idx)
        active = int((kw["row_ok"] & gates.device_ok).sum())
        t_bytes, t_ops = k1_taint_cost(kw, n_checked)
        # check_k1_gpu's count (two addends, the taint term), and the slot
        # columns: slot_ok (a byte a pair), the taken flags, the slots'
        # fit rows (8 bytes a dim) read once; the fit and a compare for
        # each slot pair of an active row
        nbytes = (p * (f + d) * 4 + n * (2 * f + 3 * d) * 4 + d * 4
                  + p * k * 8 + p * 9 + n * 8 + gates.selector_match.numel()
                  + t_bytes + active * n + n_checked * 8
                  + p * v + v + v * f * 8)
        ops = (active * n + 2 * n_checked + n * (3 + n_terms * (5 * d + 3))
               + n_needed * (2 * f + 8 * d + 6) + t_ops
               + active * v * (2 * f + 2))
        b_ms, b_by = bound(nbytes, ops)
        masked = k1_masked(kw)
        out[label] = dict(
            ms=cuda_ms(lambda: score_topk(**kw)),
            device_ms=device_ms(lambda: score_topk(**kw),
                                "score_topk_kernel"),
            plain_ms=cuda_ms(lambda: score_topk_plain(**kw), reps=3),
            library_ms=cuda_ms(lambda: torch.topk(masked, k, dim=1)),
            bound_ms=b_ms, bound_by=b_by,
            shape=(f"P={p} N={n} V={v} k={k} F={f} D={d} + two pair "
                   "scores, taints"),
            needed_pairs=n_needed, **stats)
    return out


def check_k2_once(dev, gen):
    """K2 as the AllocateOnce level of a gpu_share step (P=2000, V=64
    once-slot segments, a request of one against a capacity of one; 5 %
    of the pods accepted on a once slot, many on the same ones), and
    with every pod on one slot, and P=1. Equal to the plain version;
    the first case timed."""
    out = {}
    snap, pods = gpu_share_inputs(10_000, 1000, device=dev)
    v = snap.reservations.valid.shape[0]
    for label, p, share, timed in (("gpu_share", 2000, 0.05, True),
                                   ("all on one slot", 2000, 1.0, False),
                                   ("P=1", 1, 1.0, False)):
        batch = slice_batch(pods, 0, p)
        here = torch.rand((p,), generator=gen, device=dev) < share
        slot = torch.randint(0, 8 if share < 1 else 1, (p,), generator=gen,
                             device=dev, dtype=torch.int32)
        chain = dict(
            seg=torch.where(here, slot, v).to(torch.int32)[None],
            rank=rank_by_priority(batch),
            req=torch.ones((p, 1), device=dev), active=here,
            tables=[(torch.zeros((v, 1), device=dev),
                     torch.ones((v, 1), device=dev), v)], eps=EPS)
        chain = k2_switch(chain)
        got = segment_prefix_chain(**chain)
        if not torch.equal(got, segment_prefix_chain_plain(**chain)):
            raise SystemExit(f"K2 as the AllocateOnce level ({label}) "
                             "differs from its plain version")
        stats = dict(max_abs_err=0.0, once_here=int(here.sum()),
                     won=int(got.sum()))
        if not timed:
            out[label] = stats
            continue
        # the pods' segment, rank, request and flag, the tables and the
        # result once; one add and three compares for each pod on a slot
        b_ms, b_by = bound(p * 14 + v * 8, int(here.sum()) * 4)
        out[label] = dict(
            ms=cuda_ms(lambda: segment_prefix_chain(**chain)),
            device_ms=device_ms(lambda: segment_prefix_chain(**chain),
                                "segment_prefix_chain_kernel"),
            plain_ms=cuda_ms(lambda: segment_prefix_chain_plain(**chain)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            shape=f"P={p} L=1 R=1 S={v}", **stats)
    return out


# --- the pod topology families (K1's topology term, K8, K2's mask, K3's
# count commits) ------------------------------------------------------------


def topo_state(snap, batch, gen, slots=True):
    """A round's topology at a gpu_share state: the counts (COUNT_FIELDS
    order) after the first 8000 pods of the workload placed on random
    nodes, the affinity counts of the odd groups cleared (their
    self-matching carriers may open a zone), and every other zone
    spread group's skew set to 1 (so that the spread gate bites); then
    the batch's families over the node and slot columns (only the node
    columns where `slots` is False) and the round's terms for its
    valid rows. Returns (batch, topo, counts, terms, lim)."""
    dev = batch.valid.device
    n = snap.num_nodes
    _, pods = gpu_share_inputs(10_000, n, device=dev)
    past = slice_batch(pods, 0, 8000)
    skew = batch.spread_max_skew.clone()
    skew[0:8:2] = 1.0
    batch = batch.replace(spread_max_skew=skew)
    assign = torch.randint(0, n, (8000,), generator=gen, device=dev,
                           dtype=torch.int32)
    counts = list(domains.charge_all_counts(domains.batch_counts(batch),
                                            past, assign))
    counts[3] = counts[3].clone()
    counts[3][1::2] = 0.0
    slot_node = snap.reservations.node
    topo = domains.batch_topology(batch, slot_node if slots
                                  else slot_node[:0], n)
    terms, lim = domains.round_terms(topo, counts, batch.valid)
    return batch, topo, tuple(counts), terms, lim


def k1_topo_cost(terms, n_checked, n_ext, spread_pairs):
    """(bytes, operations) the topology term adds to K1's bound: the
    pods' words (20 bytes a pod), the columns' words (20 bytes a column)
    and the penalty map (4 bytes a group and column) read once; an AND
    and a test of each family for each pair that passes the other gates
    (`n_checked`), one add for each carried spread group of a pair
    (`spread_pairs`) and a subtraction and a floor for each node pair."""
    p = terms.pod_words.shape[0]
    pen = 0 if terms.penalty is None else terms.penalty.numel() * 4
    return (p * 20 + n_ext * 20 + pen,
            10 * n_checked + spread_pairs + 2 * n_checked)


def check_k1_topo(dev, gen):
    """K1 with the topology term: the factored gate (node and slot
    columns) and the spread penalty, beside the taint term, the two
    addends and the 64 slot columns, at a gpu_share chunk (P=2000, N=10
    000, k=8, jitter; timed) and the tail's setting (P=512, k=32,
    jitter); untimed, with no addend and with one, no taints, no slots,
    no spread family (no penalty, no floor), pods carrying three spread
    groups, k=32 without jitter. Equal to the plain version."""
    out = {}
    cfg = loadaware.LoadAwareConfig.make(device=dev)
    for label, n, p, k, tie_break, adds, slots, edit in (
            ("gpu_share", 10_000, 2000, 8, True, 2, True, None),
            ("gpu_share tail", 10_000, 512, 32, True, 2, True, None),
            ("no addend", 1000, 2000, 8, True, 0, True, None),
            ("one addend", 1000, 2000, 8, True, 1, True, None),
            ("no taints, no slots", 1000, 2000, 8, True, 0, False,
             "no taints"),
            ("no spread family", 1000, 2000, 8, True, 2, True, "no spread"),
            ("three spread groups", 1000, 2000, 8, True, 2, True, "wide"),
            ("k=32, no jitter", 1000, 512, 32, False, 2, True, None)):
        snap, batch = gpu_state(dev, gen, n, 8000, p)
        n, p = snap.num_nodes, batch.num_pods
        alloc = snap.nodes.allocatable
        load = torch.rand(alloc.shape, generator=gen, device=dev) * 0.9
        snap = snap.replace(nodes=snap.nodes.replace(
            requested=torch.floor(alloc * load / 500.0) * 500.0))
        if edit == "no taints":
            batch = batch.replace(has_taints=False)
        if edit == "no spread":
            batch = batch.replace(has_spread=False)
        if edit == "wide":
            extra = torch.rand(batch.spread_carrier.shape, generator=gen,
                               device=dev) < 0.15
            batch = batch.replace(spread_carrier=batch.spread_carrier
                                  | (extra & batch.spread_carrier.any(
                                      dim=1, keepdim=True)))
        batch, _, _, terms, _ = topo_state(snap, batch, gen, slots=slots)
        kw = k1_case(snap, batch, cfg, 0, p, k, gen, FIT_DIMS, SCORE_DIMS,
                     tie_break=tie_break)
        mask = None
        if adds:
            mask, kw["pair_score"] = numa_pair_terms(
                *k4_args(snap, batch, "most"))
        if adds == 2:
            mask, kw["pair_score2"] = device_pair_terms(
                gpu_req_of(batch), snap.devices, "least", mask)
        kw["pair_ok"] = mask
        if slots:
            kw = with_slots(snap, batch, kw, gen)
        v = kw["slot_ok"].shape[1] if slots else 0
        kw["topo"] = terms
        (val, idx), err = k1_equal(f"topology, {label}", kw)
        blocked = topo_blocked(terms)
        stats = dict(max_abs_err=err, feasible=int((val >= 0).sum()),
                     blocked_pairs=int(blocked.sum()),
                     on_slot=int((idx >= n).sum()),
                     floored=int(((val >= 0) & (val < 0.5)).sum()))
        if not stats["blocked_pairs"]:
            raise SystemExit(f"K1 topology ({label}): the gate blocks no "
                             "pair")
        if label not in ("gpu_share",):
            out[label] = stats
            continue
        gates = kw["gates"]
        f, d = kw["req_fit"].shape[1], kw["est"].shape[1]
        checked = (expand_gates(gates) & kw["pair_ok"]
                   & kw["row_ok"][:, None] & ~blocked[:, :n])
        n_checked = int(checked.sum())
        n_needed, n_terms = k1_needed_pairs(kw, checked, val, idx)
        active = int((kw["row_ok"] & gates.device_ok).sum())
        t_bytes, t_ops = k1_taint_cost(kw, n_checked)
        words = terms.pod_words[:, 0]
        carried = torch.stack([(words >> g) & 1 for g in range(32)]).sum(0)
        spread_pairs = int((checked.sum(dim=1) * carried).sum())
        o_bytes, o_ops = k1_topo_cost(terms, n_checked, n + v, spread_pairs)
        # check_k1_slots' count, and the topology term
        nbytes = (p * (f + d) * 4 + n * (2 * f + 3 * d) * 4 + d * 4
                  + p * k * 8 + p * 9 + n * 8 + gates.selector_match.numel()
                  + t_bytes + active * n + n_checked * 8
                  + p * v + v + v * f * 8 + o_bytes)
        ops = (active * n + 2 * n_checked + n * (3 + n_terms * (5 * d + 3))
               + n_needed * (2 * f + 8 * d + 6) + t_ops
               + active * v * (2 * f + 2) + o_ops)
        b_ms, b_by = bound(nbytes, ops)
        masked = k1_masked(kw)
        out[label] = dict(
            ms=cuda_ms(lambda: score_topk(**kw)),
            device_ms=device_ms(lambda: score_topk(**kw),
                                "score_topk_kernel"),
            plain_ms=cuda_ms(lambda: score_topk_plain(**kw), reps=3),
            library_ms=cuda_ms(lambda: torch.topk(masked, k, dim=1)),
            bound_ms=b_ms, bound_by=b_by,
            shape=(f"P={p} N={n} V={v} k={k} F={f} D={d} + two pair "
                   "scores, taints, topology"),
            needed_pairs=n_needed, **stats)
    return out


def k8_step(snap, batch, gen, trying_frac=0.7):
    """One step's K8 operands at a gpu_share state: each trying pod's
    extended column (a third of them among 32 popular nodes, 5 % on a
    slot column), the pods' priority order."""
    dev = batch.valid.device
    p, n = batch.num_pods, snap.num_nodes
    v = snap.reservations.valid.shape[0]
    choice = torch.randint(0, n, (p,), generator=gen, device=dev)
    r = torch.rand((p,), generator=gen, device=dev)
    choice = torch.where(r < 0.33, torch.randint(
        0, 32, (p,), generator=gen, device=dev), choice)
    choice = torch.where(r > 0.95, n + torch.randint(
        0, v, (p,), generator=gen, device=dev), choice)
    trying = torch.rand((p,), generator=gen, device=dev) < trying_frac
    return (torch.where(trying, choice, n + v).to(torch.int32), trying,
            rank_by_priority(batch))


def k8_cost(choice, trying, families):
    """(bytes, operations) of one K8 call on these inputs: the pods'
    choice, trying flag and rank and each family's charge and gate words
    read once, each trying pod's domain of each group and each gated
    pod's count read once (an opener group's counts all), the result
    written; a domain lookup a trying pod and group, and two operations
    for each gated pod and earlier-or-not charging pod of its group."""
    p = choice.shape[0]
    nbytes, ops = p * 10 + len(families) * p * 8, 0
    n_try = int(trying.sum())
    for fam in families:
        x = fam.dom_x.shape[1]
        c = choice.clamp(0, x - 1).long()
        for g in range(fam.dom_x.shape[0]):
            dom = fam.dom_x[g, c]
            has = trying & (dom >= 0)
            if fam.kind == OPENER:
                at = fam.counts[g, dom.clamp_min(0).long()]
                charge = gate = has & (((fam.gate >> g) & 1) != 0) & (at < 0.5)
                nbytes += fam.counts.shape[1] * 4
            else:
                charge = has & (((fam.charge >> g) & 1) != 0)
                gate = has & (((fam.gate >> g) & 1) != 0)
            n_gate = int(gate.sum())
            nbytes += n_try * 4 + n_gate * 4
            ops += n_try + 2 * n_gate * int(charge.sum())
    return nbytes, ops


def k8_full_gate_step(dev, gen):
    """K8's operands at the full gate's first packed chunk (the
    workload's own packing of 100 000 pods, chunk 2000, N = 10 000 and
    64 slots; topo_state's counts, k8_step's choices) on its first
    topo_prefix rows, as schedule_batch passes them: the rows' stable
    rank (`rank_of`) and step_families over those rows. Returns
    (choice, trying, rank, families, columns X)."""
    snap, batch, prefixes, _ = fullgate_state(dev, gen, 10_000,
                                              num_pods=100_000)
    batch, topo, counts, _, lim = topo_state(snap, batch, gen)
    choice, trying, rank = k8_step(snap, batch, gen)
    pc = prefixes["topo"]
    return (choice[:pc].contiguous(), trying[:pc].contiguous(),
            stable_rank(rank[:pc]),
            domains.step_families(topo, counts, lim, pc),
            snap.num_nodes + snap.reservations.valid.shape[0])


def k8_edit(edit, choice, trying, rank, fams, gen):
    """check_k8's edits of a gpu_share step: every pod trying on one
    column; keyless columns; soft spread groups; one family kind alone;
    95 % of the pods carrying and matching spread group 3 with 60 % on
    two columns (segments of more than 64 charging pods); ranks in the
    reverse of index order; the affinity openers over the spread groups'
    10 000 node domains (a few counts set in the odd groups)."""
    dev = choice.device
    p = choice.shape[0]
    if edit == "one column":
        trying = torch.ones_like(trying)
        choice = torch.full_like(choice, 7)
    if edit == "keyless":
        fams = [PrefixFamily(torch.full_like(f.dom_x, -1), f.counts,
                             f.charge, f.gate, f.kind, f.lim) for f in fams]
    if edit == "soft":
        fams = [PrefixFamily(f.dom_x, f.counts, f.charge, f.gate, f.kind,
                             torch.full_like(f.lim, float("inf")))
                if f.kind == CAP else f for f in fams]
    if edit in ("spread", "anti", "aff"):
        fams = {"spread": fams[:1], "anti": fams[1:3], "aff": fams[3:]}[edit]
    if edit == "crowded":
        many = torch.rand((p,), generator=gen, device=dev) < 0.95
        bit = torch.where(many, 1 << 3, 0).to(torch.int32)
        fams = [PrefixFamily(f.dom_x, f.counts, f.charge | bit, f.gate | bit,
                             f.kind, f.lim) if f.kind == CAP else f
                for f in fams]
        hot = torch.rand((p,), generator=gen, device=dev) < 0.6
        choice = torch.where(hot & trying, 7 + torch.randint(
            0, 2, (p,), generator=gen, device=dev, dtype=torch.int32),
            choice)
    if edit == "reversed":
        rank = torch.arange(p - 1, -1, -1, dtype=torch.int32, device=dev)
    if edit == "wide opener":
        spread, aff = fams[0], fams[3]
        g = aff.dom_x.shape[0]
        counts = (torch.rand((g, spread.counts.shape[1]), generator=gen,
                             device=dev) < 0.0005).float()
        counts[0::2] = 0.0
        fams = fams[:3] + [PrefixFamily(spread.dom_x[:g].contiguous(), counts,
                                        aff.charge, aff.gate, OPENER)]
    return choice, trying, rank, fams


def check_k8(dev, gen):
    """K8 at a gpu_share step (P=2000 against N=10 000 nodes and 64
    slots, the workload's 16 spread, 16 anti-affinity and 8 affinity
    groups, every other zone group's skew 1, the odd affinity groups
    empty; timed), the tail's (P=512; timed) and the full gate's first
    packed chunk on its topo_prefix rows (`k8_full_gate_step`; timed),
    each beside the launch floor (an empty kernel on K8's grid and block,
    device time); untimed, the edits of `k8_edit` and P=1, P=33. Equal
    to the plain version."""
    out = {}
    for label, p, edit in (("gpu_share", 2000, None),
                           ("gpu_share tail", 512, None),
                           ("full gate topo_prefix", None, None),
                           ("one column", 2000, "one column"),
                           ("keyless", 2000, "keyless"),
                           ("soft spread", 2000, "soft"),
                           ("spread alone", 2000, "spread"),
                           ("anti-affinity alone", 2000, "anti"),
                           ("affinity alone", 2000, "aff"),
                           ("crowded segments", 2000, "crowded"),
                           ("ranks reversed", 2000, "reversed"),
                           ("opener over 10^4 domains", 2000, "wide opener"),
                           ("P=1", 1, None), ("P=33", 33, None)):
        if p is None:
            choice, trying, rank, fams, x = k8_full_gate_step(dev, gen)
        else:
            snap, batch = gpu_state(dev, gen, 10_000, 8000, p)
            batch, topo, counts, _, lim = topo_state(snap, batch, gen)
            choice, trying, rank = k8_step(snap, batch, gen)
            fams = domains.step_families(topo, counts, lim)
            x = snap.num_nodes + 64
            choice, trying, rank, fams = k8_edit(edit, choice, trying, rank,
                                                 fams, gen)
        got = topology_prefix_gate(choice, trying, rank, fams)
        want = topology_prefix_gate_plain(choice, trying, rank, fams)
        if not torch.equal(got, want):
            raise SystemExit(f"K8 topology_prefix_gate ({label}) differs "
                             f"from its plain version at "
                             f"{(got != want).nonzero()[:5, 0].tolist()}")
        stats = dict(max_abs_err=0.0, trying=int(trying.sum()),
                     rejected=int((trying & ~got).sum()))
        if label not in ("gpu_share", "gpu_share tail",
                         "full gate topo_prefix"):
            out[label] = stats
            continue
        if not stats["rejected"]:
            raise SystemExit(f"K8 ({label}): the gates reject no pod")
        nbytes, ops = k8_cost(choice, trying, fams)
        b_ms, b_by = bound(nbytes, ops)
        columns = sum(f.dom_x.shape[0] for f in fams)
        n_pods = choice.shape[0]
        out[label] = dict(
            ms=cuda_ms(lambda: topology_prefix_gate(choice, trying, rank,
                                                    fams)),
            device_ms=device_ms(
                lambda: topology_prefix_gate(choice, trying, rank, fams),
                "topology_prefix_kernel"),
            floor_device_ms=device_ms(
                lambda: launch_floor(n_pods, columns, dev),
                "topology_prefix_floor_kernel"),
            plain_ms=cuda_ms(lambda: topology_prefix_gate_plain(
                choice, trying, rank, fams), reps=3),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            shape=f"P={n_pods} X={x} columns={columns}", **stats)
    return out


def check_k2_mask(snap, pods, gen):
    """K2's chained gate (node + 2 quota levels) with the step's
    topology verdict ANDed in after the node level, at P=2000 with 70 %
    trying and a random verdict (80 % pass; timed), and with the node
    level alone (the mask on the output). Equal to the plain version."""
    out = {}
    for label, p0, levels in (("chain + mask", 8000, None),
                              ("node level + mask", 10_000, 1)):
        kw = k2_case(snap, pods, gen, p0, 0.7, FIT_DIMS)
        if levels:
            kw["seg"], kw["tables"] = kw["seg"][:levels], kw["tables"][:levels]
        kw["mask"] = torch.rand((2000,), generator=gen,
                                device=kw["rank"].device) < 0.8
        kw = k2_switch(kw)
        got = segment_prefix_chain(**kw)
        want = segment_prefix_chain_plain(**kw)
        if not torch.equal(got, want):
            raise SystemExit(f"K2 with a mask ({label}) differs from its "
                             "plain version")
        stats = dict(max_abs_err=0.0, accepted=int(got.sum()))
        if levels:
            out[label] = stats
            continue
        out[label] = dict(
            ms=cuda_ms(lambda: segment_prefix_chain(**kw)),
            device_ms=device_ms(lambda: segment_prefix_chain(**kw),
                                "segment_prefix_chain_kernel"),
            plain_ms=cuda_ms(lambda: segment_prefix_chain_plain(**kw)),
            shape=f"P=2000 L={len(kw['tables'])} R=4 + mask", **stats)
    return out


def with_slot_rows(snap, st, gen):
    """A gpu_step state `st` on `snap` with the snapshot's V reservation
    slots as extended pool rows N..N+V-1, as schedule_batch forms them
    (core.py:406-449): each slot's zone hold (half its host node's
    capacity of one zone) as a zone row with policy none and nothing
    used, its reserved instances (about 40 % of its GPU host's valid
    instances, at their live free) as an instance row with the host's
    totals and topology; 20 % of the trying pods choose a slot row."""
    dev = st["trying"].device
    n, v = snap.num_nodes, snap.reservations.valid.shape[0]
    host = snap.reservations.node.long()
    nodes, d = st["nodes"], snap.devices
    z = nodes.numa_cap.shape[1]
    zone = torch.randint(0, z, (v,), generator=gen, device=dev)
    zmask = torch.arange(z, device=dev)[None, :] == zone[:, None]
    hold = torch.floor(nodes.numa_cap[host] / 2.0) * zmask[..., None]
    resv_valid = d.gpu_valid[host] & (torch.rand(
        d.gpu_valid[host].shape, generator=gen, device=dev) < 0.4)
    nodes = nodes.replace(
        numa_cap=torch.cat([nodes.numa_cap, hold]),
        numa_free=torch.cat([nodes.numa_free, hold]),
        numa_valid=torch.cat([nodes.numa_valid, zmask]),
        numa_policy=torch.cat([nodes.numa_policy, torch.zeros(
            (v,), dtype=torch.int32, device=dev)]))
    devices = d.replace(
        gpu_total=torch.cat([d.gpu_total, d.gpu_total[host]]),
        gpu_free=torch.cat([d.gpu_free, d.gpu_free[host]
                            * resv_valid[..., None]]),
        gpu_valid=torch.cat([d.gpu_valid, resv_valid]),
        gpu_numa=torch.cat([d.gpu_numa, d.gpu_numa[host]]),
        gpu_pcie=torch.cat([d.gpu_pcie, d.gpu_pcie[host]]))
    p = st["trying"].shape[0]
    to_slot = st["trying"] & (torch.rand((p,), generator=gen, device=dev)
                              < 0.2)
    choice = torch.where(st["trying"], st["choice"], n + v)
    choice = torch.where(to_slot, n + torch.randint(
        0, v, (p,), generator=gen, device=dev), choice).to(torch.int32)
    return snap.replace(devices=devices), dict(st, nodes=nodes,
                                               choice=choice)


def config_2_phase():
    """BASELINE config 2 (10 000 pods x 1000 nodes, chunks of 2000, the
    NUMA path) on the card after a warm-up run, then on the host: the
    bench line with the measured run's launch counts, the card's results
    against the host's, and the invariants. Returns (line, launches)."""
    run_config_2_numa(device="cuda")                     # warm-up
    kernels.reset_launch_counts()
    line, run = run_config_2_numa(device="cuda")
    launches = kernels.launch_counts()
    line["launches"] = launches
    t0 = time.perf_counter()
    _, host = run_config_2_numa(device="cpu")
    line["host_s"] = time.perf_counter() - t0
    fields = {"assignment": (run.assignment, host.assignment),
              "numa_zone": (run.numa_zone, host.numa_zone),
              "numa_take": (run.numa_take, host.numa_take),
              "numa_free": (run.snapshot.nodes.numa_free,
                            host.snapshot.nodes.numa_free),
              "requested": (run.snapshot.nodes.requested,
                            host.snapshot.nodes.requested)}
    line["equal_to_host"] = {f: torch.equal(a.cpu(), b)
                             for f, (a, b) in fields.items()}
    print("config 2: " + json.dumps(line), flush=True)
    if not all(line["equal_to_host"].values()):
        raise SystemExit("config 2: the card's results differ from the "
                         f"host's: {line['equal_to_host']}")
    check_config_2(run, line, launches)
    return line, launches


def check_config_2(run, line, launches):
    """Config 2's invariants: each zone's takes (from the placed pods)
    within its capacity and equal to capacity minus zone free; no
    overcommit; quota within runtime; K4 once a chunk, K5 once an inner
    step, K2 twice an inner step, K1 once a round, K3 by `k3_formula`,
    K2's order switch once a chunk (the zone levels' launches decide
    their own)."""
    snap = run.snapshot
    n = snap.num_nodes
    ok = run.assignment >= 0
    z = snap.nodes.numa_cap.shape[1]
    tgt = torch.where(ok, run.assignment, n).long()
    used = torch.zeros((n + 1, z * 2), device=tgt.device).index_add_(
        0, tgt, run.numa_take.reshape(-1, z * 2))[:n].view(n, z, 2)
    if not bool((used <= snap.nodes.numa_cap + EPS).all()):
        raise SystemExit("config 2: a zone's takes exceed its capacity")
    if not torch.equal(snap.nodes.numa_free,
                       torch.clamp_min(snap.nodes.numa_cap - used, 0.0)):
        raise SystemExit("config 2: zone free differs from capacity minus "
                         "the takes")
    if not (overcommit_ok(snap) and quota_ok(snap)):
        raise SystemExit("config 2: overcommit or quota over runtime")
    if not 0 < line["numa_bound_placed"] <= line["placed"]:
        raise SystemExit(f"config 2: placed {line['placed']} pods, "
                         f"{line['numa_bound_placed']} NUMA-bound")
    chunks = line["num_pods"] // line["chunk"]
    rounds = chunks * CONFIG_2_KW["num_rounds"]
    steps = rounds * CONFIG_2_KW["k_choices"]
    want = {"numa_pair_terms": chunks, "topology_admit": steps,
            "segment_prefix_ok": 2 * steps, "score_topk": rounds,
            "order_switch": chunks,
            "device_pair_terms": 0, "gpu_instance_pick": 0,
            "topology_prefix_gate": 0, "stage1_mask": 0}
    for name, count in want.items():
        if launches[name] != count:
            raise SystemExit(f"config 2: {name} launched {launches[name]} "
                             f"times, not {count}")
    k3_want = k3_formula(steps, rounds, chunks)
    if launches["ordered_scatter_add"] != k3_want:
        raise SystemExit(f"config 2: K3 launched "
                         f"{launches['ordered_scatter_add']} times, not "
                         f"{k3_want} ({K3_FORMULA})")


GPU_SHARE_FIELDS = ("assignment", "stats", "gpu_take", "res_slot",
                    "nodes.requested", "nodes.numa_free", "devices.gpu_free",
                    "quotas.used", "gangs.assumed",
                    "nodes.assigned_estimated", "reservations.free",
                    "reservations.valid", "reservations.gpu_free",
                    "reservations.numa_free") + tuple(
                        f"counts.{f}" for f in domains.COUNT_FIELDS)
# the line's topology fields, card against host
GPU_SHARE_TOPO_LINE = ("spread_placed", "anti_placed", "aff_placed")


def _run_field(run, path):
    if path in ("assignment", "stats", "gpu_take", "res_slot"):
        return getattr(run, path).cpu()
    part, field = path.split(".")
    if part == "counts":
        return run.counts[domains.COUNT_FIELDS.index(field)].cpu()
    return getattr(getattr(run.snapshot, part), field).cpu()


def gpu_share_phase():
    """gpu_share_100kx10k: at GPU_SHARE_COMPARED_PODS pods x 1000 nodes
    on the card and on the host (every result field equal), then at
    100 000 x 10 000 on the card, counting launches, with its invariants.
    Returns (line, launches, small-run summary)."""
    small = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        line, run = run_gpu_share(GPU_SHARE_COMPARED_PODS, 1000, chunk=2000,
                                  device=d)
        small[d] = (line, run, time.perf_counter() - t0)
    equal = {f: torch.equal(_run_field(small["cuda"][1], f),
                            _run_field(small["cpu"][1], f))
             for f in GPU_SHARE_FIELDS}
    equal.update({f: small["cuda"][0][f] == small["cpu"][0][f]
                  for f in GPU_SHARE_TOPO_LINE})
    summary = {"equal_to_host": equal, "cuda_s": small["cuda"][2],
               "cpu_s": small["cpu"][2],
               **{k: small["cuda"][0][k] for k in (
                   "placed", "gpu_pods_placed", "numa_bound_placed",
                   "slot_consumers", "once_slots_taken",
                   "stragglers_after_sweep", "stragglers_final",
                   "tail_passes") + GPU_SHARE_TOPO_LINE}}
    print(f"gpu_share {GPU_SHARE_COMPARED_PODS}x1000: "
          + json.dumps(summary), flush=True)
    if not all(equal.values()):
        raise SystemExit(f"gpu_share: the card's results differ from the "
                         f"host's: {equal}")
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    line, run = run_gpu_share(device="cuda")
    launches = kernels.launch_counts()
    line["launches"] = launches
    line["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    print("gpu_share: " + json.dumps(line), flush=True)
    check_gpu_share(run, line, launches)
    return line, launches, summary


def check_gpu_share(run, line, launches, snap0=None, pods=None,
                    step_kw=GPU_SHARE_KW, tail_kw=GPU_SHARE_TAIL_KW,
                    name="gpu_share"):
    """gpu_share's invariants (and the full gate's: `snap0` and the
    packed `pods` given, the full gate's kwargs, `name`): the launch
    counts its design fixes (K4 and K6 once a batch, K1 once a round, K5
    once an inner step, K7 twice, K2 four times an inner step: node and
    quotas (with K8's verdict), zones, GPU instances, AllocateOnce; K8
    once an inner step; K3 by `k3_formula`: one grouped launch an inner
    step (node, quotas, zones, instances, aux pools and the four count
    tables), one a round and two a batch (the rebuild with the
    reservation draw-downs, then the count charges after it); K9 once a
    batch with the cascade on, else never; on a snapshot with aux pools
    K17 once an inner step and K2 once more an inner step); K2's order
    switch twice a batch (the pods' requests and AllocateOnce; three
    times with aux pools), none a step: the GPU, zone and amplified
    levels' K2 launches decide it themselves; every
    placed GPU pod holds
    `count` instances of its node, the takes times the per-instance
    requests equal each valid instance's total minus its final free,
    and no free is negative; every slot consumer owns its slot, each
    AllocateOnce slot has at most one consumer (and is closed if it has
    one), each slot's free is its initial free less its consumers'
    requests and not negative, the nodes' requested is their initial
    requested plus the placed pods' that consumed no slot; no pod sits
    on a node whose taints its toleration set forbids; no overcommit,
    quota within runtime. Without the tail's topology budget every pass
    retried a full window of never-retried stragglers while any
    remained, so never_retried is what the pass budget leaves:
    max(0, stragglers_after_sweep - passes * window); with it, the run
    must leave none."""
    chunks = line["num_pods"] // line["chunk"]
    passes = line["tail_passes"]
    batches = chunks + passes
    rounds = (chunks * step_kw["num_rounds"]
              + passes * tail_kw["num_rounds"])
    steps = (chunks * step_kw["num_rounds"] * step_kw["k_choices"]
             + passes * tail_kw["num_rounds"] * tail_kw["k_choices"])
    aux = int(snap0 is not None and snap0.devices.aux_free.shape[2] > 0)
    want = {"numa_pair_terms": batches, "device_pair_terms": batches,
            "score_topk": rounds, "topology_admit": steps,
            "gpu_instance_pick": 2 * steps,
            "segment_prefix_ok": (4 + aux) * steps,
            "topology_prefix_gate": steps,
            "ordered_scatter_add": k3_formula(steps, rounds, batches,
                                              charged=batches),
            "stage1_mask": batches if step_kw["cascade"] else 0,
            "aux_instance_pick": aux * steps,
            "order_switch": (2 + aux) * batches}
    print(f"{name}: K3 launches " + json.dumps({
        "formula": K3_FORMULA, "steps": steps, "rounds": rounds,
        "batches": batches, "charged": batches,
        "expected": want["ordered_scatter_add"],
        "measured": launches["ordered_scatter_add"]}), flush=True)
    for kernel, count in want.items():
        if launches[kernel] != count:
            raise SystemExit(f"{name}: {kernel} launched {launches[kernel]} "
                             f"times, not {count}")
    if snap0 is None:
        snap0, pods = gpu_share_inputs(line["num_pods"], line["num_nodes"],
                                       device="cuda")
    dev0 = snap0.devices
    assign, take = run.assignment, run.gpu_take
    count, per = deviceshare.per_instance_at(dev0, gpu_req_of(pods), assign)
    placed = assign >= 0
    if not torch.equal(take.sum(dim=1), torch.where(placed, count, 0)):
        raise SystemExit(f"{name}: a placed GPU pod holds other than its "
                         "count of instances")
    n, i, _ = dev0.gpu_free.shape
    used = torch.zeros((n + 1, i, 3), device=assign.device).index_add_(
        0, torch.where(placed, assign, n).long(),
        take[:, :, None] * per[:, None, :])[:n]
    free = run.snapshot.devices.gpu_free
    valid = dev0.gpu_valid[:, :, None]
    if not bool((free >= 0).all()):
        raise SystemExit(f"{name}: an instance's free is negative")
    if not torch.equal((dev0.gpu_free - free) * valid, used * valid):
        raise SystemExit(f"{name}: instance takes differ from total minus "
                         "free")
    check_slots_and_taints(snap0, pods, run, line,
                           step_kw.get("enable_amplification", False))
    check_topology(pods, run, line)
    if not (overcommit_ok(run.snapshot) and quota_ok(run.snapshot)):
        raise SystemExit(f"{name}: overcommit or quota over runtime")
    window = min(line["chunk"], 512)
    left = (max(0, line["stragglers_after_sweep"] - passes * window)
            if tail_kw.get("topo_prefix") is None else 0)
    if line["never_retried"] != left:
        raise SystemExit(f"{name}: {line['never_retried']} stragglers "
                         f"never retried, not {left}")
    if not (0 < line["gpu_pods_placed"] <= line["placed"]
            and 0 < line["numa_bound_placed"] <= line["placed"]
            and 0 < line["once_slots_taken"] <= line["slot_consumers"]):
        raise SystemExit(f"{name}: placed {line['placed']}, GPU "
                         f"{line['gpu_pods_placed']}, NUMA-bound "
                         f"{line['numa_bound_placed']}, slot consumers "
                         f"{line['slot_consumers']}, once slots taken "
                         f"{line['once_slots_taken']}")


def check_topology(pods, run, line):
    """The pod topology invariants of a gpu_share run: no node holds two
    placed carriers of one anti-affinity group; the final counts the
    run carried equal the counts recounted on the host from the final
    assignment; the line's placed counts of each family. Prints each
    hard spread group's final skew over its eligible domains and each
    affinity group's zones."""
    assign = run.assignment.cpu()
    hpods = pods.to("cpu")
    placed = assign >= 0
    carrier = hpods.anti_carrier & placed[:, None]
    for g in range(carrier.shape[1]):
        nodes = assign[carrier[:, g]]
        if nodes.numel() != torch.unique(nodes).numel():
            raise SystemExit(f"gpu_share: two carriers of anti-affinity "
                             f"group {g} share a node")
    recount = domains.charge_all_counts(domains.batch_counts(hpods), hpods,
                                        assign)
    for f, got, want in zip(domains.COUNT_FIELDS, run.counts, recount):
        if not torch.equal(got.cpu(), want):
            raise SystemExit(f"gpu_share: the carried {f} differ from the "
                             "recount of the final assignment")
    for fam in ("spread", "anti", "aff"):
        want = int((placed & getattr(hpods, f"{fam}_carrier").any(
            dim=1)).sum())
        if line[f"{fam}_placed"] != want or not want:
            raise SystemExit(f"gpu_share: {fam}_placed "
                             f"{line[f'{fam}_placed']}, not {want}")
    counts = recount[0]
    skew = {}
    for g in range(counts.shape[0]):
        if torch.isfinite(hpods.spread_max_skew[g]):
            c = counts[g][hpods.spread_dvalid[g]]
            skew[g] = [float(c.max() - c.min()),
                       float(hpods.spread_max_skew[g])]
    zones = {g: sorted(set(hpods.aff_domain[g][
        assign[hpods.aff_member[:, g] & placed].long()].tolist()))
        for g in range(hpods.aff_member.shape[1])}
    print("gpu_share topology: " + json.dumps(
        {"spread_skew_and_bound": skew, "affinity_zones": zones}),
        flush=True)


def check_slots_and_taints(snap0, pods, run, line, amplified=False):
    """The reservation and taint invariants of a gpu_share run (see
    `check_gpu_share`), on the host: integer-valued sums, exact in any
    order (with `amplified`, a CPU-bind pod's node charge is its CPU
    times its node's ratio: 1.5, 2 or 3 times a multiple of 500 mC, a
    whole number too)."""
    assign = run.assignment.cpu().long()
    res_slot = run.res_slot.cpu().long()
    req = pods.requests.cpu()
    resv0 = snap0.reservations.to("cpu")
    resv = run.snapshot.reservations.to("cpu")
    v = resv0.valid.shape[0]
    placed = assign >= 0
    consumer = res_slot >= 0
    if bool((consumer & ~placed).any()):
        raise SystemExit("gpu_share: an unplaced pod holds a slot")
    slot = res_slot.clamp_min(0)
    owner = pods.reservation_owner.cpu()
    if not bool((owner[consumer] == resv0.owner_group[slot[consumer]]).all()
                and (assign[consumer]
                     == resv0.node[slot[consumer]].long()).all()):
        raise SystemExit("gpu_share: a slot consumer does not own its slot "
                         "or sits off its node")
    per_slot = torch.bincount(res_slot[consumer], minlength=v)
    once = resv0.allocate_once
    if bool((per_slot[once] > 1).any()) or not torch.equal(
            resv.valid, resv0.valid & ~(once & (per_slot > 0))):
        raise SystemExit("gpu_share: an AllocateOnce slot has two consumers "
                         "or its state is off")
    consumed = torch.zeros((v, req.shape[1])).index_add_(
        0, res_slot[consumer], req[consumer])
    if not (torch.equal(resv.free, resv0.free - consumed)
            and bool((resv.free >= 0).all())):
        raise SystemExit("gpu_share: a slot's free is not its initial free "
                         "less its consumers' requests")
    n = snap0.num_nodes
    on_node = placed & ~consumer
    if amplified:
        ratio = snap0.nodes.cpu_amplification.cpu()[assign.clamp(0, n - 1)]
        req = req.clone()
        req[:, CPU] = req[:, CPU] * torch.where(
            pods.numa_single.cpu() & on_node, ratio, 1.0)
    requested = snap0.nodes.requested.cpu().index_add(
        0, assign[on_node], req[on_node])
    if not torch.equal(run.snapshot.nodes.requested.cpu(), requested):
        raise SystemExit("gpu_share: node requested is not the initial one "
                         "plus the non-consumers' requests")
    t, g = pods.tol_forbid.shape
    tol = _table_index(pods.toleration_id.cpu().clamp_min(0), t)
    taint = _table_index(snap0.nodes.taint_group.cpu(), g)
    forbid = pods.tol_forbid.cpu()[tol, taint[assign.clamp(0, n - 1)]]
    if bool((forbid & placed).any()):
        raise SystemExit("gpu_share: a pod sits on a node whose taints its "
                         "toleration set forbids")
    if int(consumer.sum()) != line["slot_consumers"]:
        raise SystemExit("gpu_share: slot_consumers disagrees with res_slot")


def fullgate_state(dev, gen, n_nodes, p=2000, num_pods=10_000):
    """The full-gate workload's pods packed in chunks of p
    (`configs.pack_full_gate`) against n_nodes of its nodes, its first
    chunk: the nodes partly filled (multiples of 500), every quota at
    half its runtime but the first pod's, which is at its ceiling.
    Returns (snapshot, batch, prefixes, the full quota's id)."""
    snap, pods = gpu_share_inputs(num_pods, n_nodes, device=dev)
    packed, prefixes, _, _, _ = pack_full_gate(snap, pods, p)
    batch = slice_batch(packed, 0, p)
    alloc = snap.nodes.allocatable
    load = torch.rand(alloc.shape, generator=gen, device=dev) * 0.95
    runtime = snap.quotas.runtime
    finite = torch.isfinite(runtime)
    used = torch.where(finite, torch.floor(runtime * 0.5 / 500.0) * 500.0,
                       0.0)
    qid = int(batch.quota_id[0])
    used[qid] = torch.where(finite[qid], runtime[qid], 0.0)
    snap = snap.replace(
        nodes=snap.nodes.replace(
            requested=torch.floor(alloc * load / 500.0) * 500.0),
        quotas=snap.quotas.replace(used=used))
    return snap, batch, prefixes, qid


def k9_args(snap, batch, gates, fit_dims, depth=QUOTA_DEPTH):
    """K9's operands as cascade.stage1_mask forms them."""
    def dims(x):
        return (x if fit_dims is None else x[:, fit_dims]).contiguous()
    return (gates, dims(batch.requests), dims(snap.nodes.requested),
            dims(snap.nodes.allocatable),
            feasibility.pod_ancestors(snap.quotas, batch),
            dims(snap.quotas.used), dims(snap.quotas.runtime), depth, EPS)


def check_k9(dev, gen):
    """K9 at a full-gate chunk (the first packed chunk, P=2000 against
    N=10 000 nodes, the taint tables in, a quota at its ceiling; timed),
    and untimed at N=1001 (not a multiple of 32), with fit_dims None (all
    11 dims, quota depth 6) and on an all-dead batch (every device term
    off), then the edits of `k9_edge_args`. Equal to the plain version;
    the full quota's pods that ask for a capped dim have no candidate."""
    out = {}
    cfg = loadaware.LoadAwareConfig.make(device=dev)
    for label, n, fit_dims, depth, dead, timed in (
            ("full gate", 10_000, FIT_DIMS, QUOTA_DEPTH, False, True),
            ("N=1001", 1001, FIT_DIMS, QUOTA_DEPTH, False, False),
            ("fit_dims=None", 1000, None, 6, False, False),
            ("all dead", 1000, FIT_DIMS, QUOTA_DEPTH, True, False)):
        snap, batch, _, qid = fullgate_state(dev, gen, n)
        n = snap.num_nodes
        gates = static_gate_terms(snap.nodes, batch, cfg, snap.devices)
        if dead:
            gates = gates.replace(device_ok=torch.zeros_like(gates.device_ok))
        args = k9_args(snap, batch, gates, fit_dims, depth)
        got = stage1_mask(*args)
        want = stage1_mask_plain(*args)
        err = float((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if not torch.equal(got, want):
            raise SystemExit(f"K9 stage1_mask ({label}) differs from its "
                             f"plain version in {int((got != want).sum())} "
                             "pairs")
        p = batch.num_pods
        fd = ALL_DIMS if fit_dims is None else fit_dims
        capped = torch.isfinite(snap.quotas.runtime[qid, fd])
        full = (batch.quota_id == qid) & (
            batch.requests[:, fd][:, capped] > 0.5).any(dim=1)
        if bool(got[full].any()) or (dead and bool(got.any())):
            raise SystemExit(f"K9 stage1_mask ({label}): a row that its "
                             "quota ceiling or device term kills survives")
        counts = cascade.candidate_counts(got)
        summary = dict(max_abs_err=err, pairs_ok=int(got.sum()),
                       ceiling_rows=int(full.sum()),
                       empty_rows=int((counts == 0).sum()))
        if not timed:
            out[label] = summary
            continue
        # bytes: the pod columns (ids, flags, requests, ancestor chain)
        # and node columns (label and taint group, flags, requested,
        # allocatable) once, the selector, forbid and quota tables once,
        # the [P, N] mask written. Operations this data needs: a pair's
        # F adds and compares and its gate terms (6); each pod's quota
        # ceiling (an add and a compare a dim a level); alloc + eps once
        # a node
        f = args[1].shape[1]
        d = args[4].shape[1]
        q = args[5].shape[0]
        nbytes = (p * (11 + 4 * f + 4 * d) + n * (12 + 8 * f)
                  + gates.selector_match.numel() + gates.tol_forbid.numel()
                  + q * f * 8 + p * n)
        ops = p * n * (2 * f + 6) + p * depth * f * 2 + n * f
        b_ms, b_by = bound(nbytes, ops)
        out[label] = dict(
            summary, ms=cuda_ms(lambda: stage1_mask(*args)),
            device_ms=device_ms(lambda: stage1_mask(*args),
                                "stage1_mask_kernel"),
            plain_ms=cuda_ms(lambda: stage1_mask_plain(*args), reps=3),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            shape=f"P={p} N={n} F={f} D={d} quota depth {depth}, taints")
    for label in ("N=1", "N=17", "N=10003", "P=65", "quota depth 0",
                  "ids out of range", "wide tables", "fractional",
                  "mixed values"):
        args = k9_edge_args(dev, gen, cfg, label)
        got = stage1_mask(*args)
        if not torch.equal(got, stage1_mask_plain(*args)):
            raise SystemExit(f"K9 stage1_mask ({label}) differs from its "
                             "plain version")
        out[label] = dict(max_abs_err=0.0, pairs=got.numel(),
                          pairs_ok=int(got.sum()))
    return out


def k9_edge_args(dev, gen, cfg, label):
    """K9's operands at a full-gate chunk edited so that P and N fall off
    K9's tiles and store widths (N = 1 and 17: the first nodes of 1000;
    N = 10 003; P = 65: the chunk's first pods), with no quota level,
    with table ids out of range (selector ids below -1 and past the
    table, label and taint groups counted from the end and past it,
    toleration ids below 0 and past the table), with tables too wide
    for K9's shared-memory words (3000 label groups), with every pod's
    first request a quarter off a whole number ("fractional": no tile
    takes K9's one-compare fit), or with a few pods fractional and a
    few nodes' requested +-inf, NaN, -0 or above 2^22 ("mixed
    values": some tiles take it, some do not)."""
    n = 10_003 if label == "N=10003" else 1000
    snap, batch, _, _ = fullgate_state(dev, gen, n)
    gates = static_gate_terms(snap.nodes, batch, cfg, snap.devices)
    args = list(k9_args(snap, batch, gates, FIT_DIMS,
                        0 if label == "quota depth 0" else QUOTA_DEPTH))
    g = args[0]

    def some(x, values):
        hit = torch.rand(x.shape, generator=gen, device=dev) < 0.3
        pick = torch.tensor(values, dtype=x.dtype, device=dev)[torch.randint(
            0, len(values), x.shape, generator=gen, device=dev)]
        return torch.where(hit, pick, x)

    if label in ("N=1", "N=17"):
        k = int(label[2:])
        g = g.replace(**{f: getattr(g, f)[:k].contiguous() for f in (
            "label_group", "node_ok", "prod_node_ok", "metric_fresh",
            "schedulable", "taint_group")})
        args[2], args[3] = args[2][:k].contiguous(), args[3][:k].contiguous()
    if label == "P=65":
        g = g.replace(**{f: getattr(g, f)[:65].contiguous() for f in (
            "selector_id", "prod_gate", "daemonset", "device_ok",
            "toleration_id")})
        args[1], args[4] = args[1][:65].contiguous(), args[4][:65].contiguous()
    if label == "ids out of range":
        s_, l_ = g.selector_match.shape
        t_, g_ = g.tol_forbid.shape
        g = g.replace(
            selector_id=some(g.selector_id, [-3, s_, s_ + 5, s_ - 1]),
            label_group=some(g.label_group, [-1, -l_, l_, l_ + 7]),
            toleration_id=some(g.toleration_id, [-2, t_, t_ + 4]),
            taint_group=some(g.taint_group, [-1, -g_, g_, g_ + 3]))
    if label == "wide tables":
        s_ = max(g.selector_match.shape[0], 4)
        g = g.replace(
            selector_match=torch.rand((s_, 3000), generator=gen,
                                      device=dev) < 0.7,
            selector_id=some(g.selector_id, list(range(-1, s_))),
            label_group=torch.randint(-100, 3100, g.label_group.shape,
                                      generator=gen, device=dev,
                                      dtype=torch.int32))
    if label == "fractional":
        args[1] = args[1].clone()
        args[1][:, 0] += 0.25
    if label == "mixed values":
        args[1] = args[1].clone()
        args[1][::97, 1] += 0.75
        args[2] = args[2].clone()
        odd = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.0,
                            2.0 ** 23 + 1.0], device=dev)
        args[2][torch.arange(5, device=dev) * 211, 0] = odd
    args[0] = g
    return tuple(args)


def check_prefix_rows(dev, gen):
    """K4, K6 and K1 with the cascade's row counts at the flagship's
    first packed full-gate chunk (P=2000, N=10 000): K4 on the numa
    prefix's rows and
    K6 on the gpu prefix's (timed), then 0 and P rows, each ANDing into
    K9's mask in place; K1 with the two addends of those rows (timed at
    the prefixes), of no rows, and of P rows. Equal to the plain
    versions."""
    out = {}
    cfg = loadaware.LoadAwareConfig.make(device=dev)
    # the flagship's own packing (100 000 pods): its prefixes' rows
    snap, batch, prefixes, _ = fullgate_state(dev, gen, 10_000,
                                              num_pods=100_000)
    nodes, devices = snap.nodes, snap.devices
    p, n = batch.num_pods, snap.num_nodes
    gates = static_gate_terms(nodes, batch, cfg, devices)
    base = stage1_mask(*k9_args(snap, batch, gates, FIT_DIMS))
    demand, gpu_req = numaaware.zone_demand(batch), gpu_req_of(batch)
    rn, rg = prefixes["numa"], prefixes["gpu"]
    terms = {}
    for rows in sorted({rn, rg, 0, p}):
        k4 = (demand[:rows], batch.numa_single[:rows], nodes.numa_cap,
              nodes.numa_free, nodes.numa_valid, nodes.numa_policy, "most")
        k6 = (gpu_req[:rows], devices, "least")
        for name, fn, plain, a in (
                ("K4", numa_pair_terms, numa_pair_terms_plain, k4),
                ("K6", device_pair_terms, device_pair_terms_plain, k6)):
            ok, score = fn(*a, base.clone())
            want_ok, want_score = plain(*a, base)
            if not (torch.equal(ok, want_ok) and torch.equal(
                    score.view(torch.int32), want_score.view(torch.int32))):
                raise SystemExit(f"{name} with {rows} rows differs from its "
                                 "plain version")
            terms[name, rows] = (ok, score)
    for name, fn, plain, kernel, rows, a in (
            ("numa_pair_terms", numa_pair_terms, numa_pair_terms_plain,
             "numa_pair_terms_kernel", rn,
             (demand[:rn], batch.numa_single[:rn], nodes.numa_cap,
              nodes.numa_free, nodes.numa_valid, nodes.numa_policy,
              "most")),
            ("device_pair_terms", device_pair_terms, device_pair_terms_plain,
             "device_pair_terms_kernel", rg,
             (gpu_req[:rg], devices, "least"))):
        buf = base.clone()
        z = nodes.numa_cap.shape[1]
        i = devices.gpu_free.shape[1]
        # as check_k4 / check_k6: the rows' pod columns and the node
        # columns once, the rows' mask bytes read and written and their
        # scores written; a few operations a pair (the per-zone fit or
        # per-instance fit and the score of the pods that ask)
        per_node = n * (z * 17 + 4) if name == "numa_pair_terms" \
            else n * (12 + i * 13)
        nbytes = rows * 12 + per_node + rows * n * 6
        ops = rows * n * (4 * z + 12 if name == "numa_pair_terms"
                          else 1 + 7 * i)
        b_ms, b_by = bound(nbytes, ops)
        out[name] = dict(
            ms=cuda_ms(lambda: fn(*a, buf)),
            device_ms=device_ms(lambda: fn(*a, buf), kernel),
            plain_ms=cuda_ms(lambda: plain(*a, base), reps=3),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
            shape=f"{rows} of P={p} rows, N={n}, and-into K9's mask")
    for r1, r2, timed in ((rn, rg, True), (0, 0, False), (p, p, False),
                          (0, rg, False)):
        kw = k1_case(snap, batch, cfg, 0, p, 8, gen, FIT_DIMS, SCORE_DIMS,
                     tie_break=True)
        kw["pair_ok"] = terms["K4", r1][0] & terms["K6", r2][0]
        kw["pair_score"], kw["pair_score2"] = (terms["K4", r1][1],
                                               terms["K6", r2][1])
        (val, idx), err = k1_equal(f"addend rows {r1}, {r2}", kw)
        label = f"addend rows {r1}, {r2}"
        if not timed:
            out[label] = dict(max_abs_err=err,
                              feasible_pairs=int((val >= 0).sum()))
            continue
        f, d = kw["req_fit"].shape[1], kw["est"].shape[1]
        checked = expand_gates(kw["gates"]) & kw["pair_ok"] \
            & kw["row_ok"][:, None]
        n_checked = int(checked.sum())
        n_needed, n_terms = k1_needed_pairs(kw, checked, val, idx)
        active = int((kw["row_ok"] & kw["gates"].device_ok).sum())
        # as check_k1_gpu, the addends read and added on their rows only
        added = int(checked[:r1].sum()) + int(checked[:r2].sum())
        t_bytes, t_ops = k1_taint_cost(kw, n_checked)
        shared = p * (f + d) * 4 + n * (2 * f + 3 * d) * 4 + d * 4 \
            + p * 8 * 8 + p * 9 + n * 8 + kw["gates"].selector_match.numel() \
            + t_bytes
        nbytes = shared + active * n + added * 4
        ops = active * n + n_checked + added \
            + n * (3 + n_terms * (5 * d + 3)) \
            + n_needed * (2 * f + 8 * d + 6) + t_ops
        b_ms, b_by = bound(nbytes, ops)
        masked = k1_masked(kw)
        out[label] = dict(
            ms=cuda_ms(lambda: score_topk(**kw)),
            device_ms=device_ms(lambda: score_topk(**kw),
                                "score_topk_kernel"),
            plain_ms=cuda_ms(lambda: score_topk_plain(**kw), reps=3),
            library_ms=cuda_ms(lambda: torch.topk(masked, 8, dim=1)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"P={p} N={n} k=8, addends of {r1} and {r2} rows, "
                  "K9's mask, taints")
    return out


def flat_run(run):
    """{name: np.ndarray} of a full-gate run: the per-pod results, the
    carried counts and every leaf of the final snapshot."""
    out = {f: getattr(run, f).cpu().numpy()
           for f in ("assignment", "stats", "gpu_take", "res_slot",
                     "numa_zone", "aux_inst") if getattr(run, f) is not None}
    out.update({f"counts.{f}": c.cpu().numpy()
                for f, c in zip(domains.COUNT_FIELDS, run.counts)})

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            elif isinstance(v, np.ndarray):
                out[prefix + k] = v
    walk(to_numpy(run.snapshot), "snapshot.")
    return out


def full_gate_phase():
    """score_bind_100k_pods_10k_nodes_full_gate: the packed full gate at
    8000 pods x 1000 nodes on the card with the cascade on and off and on
    the host with it on, every field equal; then at 100 000 x 10 000 on
    the card after a warm-up run, counting launches, with gpu_share's
    invariants and launch formulas (and K9 once a batch). Returns (line,
    launches, small-run summary)."""
    small = {}
    for label, d, on in (("cuda", "cuda", True), ("cuda off", "cuda", False),
                         ("cpu", "cpu", True)):
        snap, pods = gpu_share_inputs(8000, 1000, device=d)
        packed, prefixes, masks, step_kw, tail_kw = pack_full_gate(
            snap, pods, 2000)
        if not on:
            step_kw = dict(step_kw, cascade=False)
            tail_kw = dict(tail_kw, cascade=False)
        t0 = time.perf_counter()
        run = full_gate_sweep(snap, packed,
                              loadaware.LoadAwareConfig.make(device=d), 2000,
                              prefixes, masks, step_kw, tail_kw)
        small[label] = (flat_run(run), time.perf_counter() - t0, prefixes)
    ref = small["cuda"][0]
    equal = {other: [f for f in ref if not (
        ref[f].dtype == small[other][0][f].dtype
        and np.array_equal(ref[f], small[other][0][f]))]
        for other in ("cuda off", "cpu")}
    assign = ref["assignment"]
    summary = {"differing_fields": equal, "fields": len(ref),
               "prefixes": small["cuda"][2],
               "seconds": {k: v[1] for k, v in small.items()},
               "placed": int((assign >= 0).sum()),
               "stats": ref["stats"].tolist()}
    print("full gate 8000x1000: " + json.dumps(summary), flush=True)
    if any(equal.values()):
        raise SystemExit(f"full gate: the card with the cascade on differs "
                         f"from the card with it off or the host: {equal}")
    dev = torch.device("cuda")
    run_full_gate(device="cuda")                       # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    line, run, setup = run_full_gate(device="cuda")
    launches = kernels.launch_counts()
    line["launches"] = launches
    line["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    # the first chunk's candidate counts (observability, after the run's
    # counts are read)
    snap0, pods = setup["snap"], setup["pods"]
    batch0 = slice_batch(pods, 0, line["chunk"])
    gates = static_gate_terms(snap0.nodes, batch0,
                              loadaware.LoadAwareConfig.make(device=dev),
                              snap0.devices)
    cand = cascade.candidate_counts(cascade.stage1_mask(
        snap0, batch0, gates, FIT_DIMS, QUOTA_DEPTH))[batch0.valid].float()
    line["candidates_first_chunk"] = {
        "min": float(cand.min()), "median": float(cand.median()),
        "max": float(cand.max())}
    print("full gate: " + json.dumps(line), flush=True)
    check_gpu_share(run, line, launches, snap0, pods, setup["step_kw"],
                    setup["tail_kw"], name="full gate")
    return line, launches, summary


# --- the descheduler: K10-K13 and BASELINE config 5 ------------------------

LNL_KERNELS = ("lnl_node_fit", "lnl_eviction_order", "lnl_plan_prefix",
               "lnl_plan_capped")
# the device symbols of each kernel (K10 is two launches on the stream)
LNL_SYMBOLS = {"lnl_node_fit": ("low_node_rows", "pod_fits"),
               "lnl_eviction_order": ("k11_coop",),
               "lnl_plan_prefix": ("plan_prefix_kernel",),
               "lnl_plan_capped": ("plan_capped_kernel",)}
DEVIATION_THRESHOLDS = dict(
    low_thresholds={ResourceKind.CPU: 10.0, ResourceKind.MEMORY: 10.0},
    high_thresholds={ResourceKind.CPU: 10.0, ResourceKind.MEMORY: 10.0})


def lnl_columns(dev, deviation=False, n_nodes=10_000, every_node=False):
    """Config 5's plan inputs (the columns DeviceLowNodeLoad.balance_once
    hands the plan) on `dev`, with the threshold dims as `rdims`; in
    deviation mode with thresholds of 10/10 around the average (the
    defaults leave no source there); with `every_node` the cluster that
    lists pods on every node. Returns (columns, fit_dims)."""
    nodes, metrics, by_node = config_5_cluster(n_nodes, every_node)
    args = LowNodeLoadArgs(consecutive_abnormalities=1,
                           use_deviation_thresholds=deviation,
                           **(DEVIATION_THRESHOLDS if deviation else {}))
    plugin = LowNodeLoad(args)
    usage, capacity, fresh = plugin.node_columns(nodes, metrics,
                                                 CONFIG_5_NOW)
    _, _, _, high, _ = plugin.classify_columns(usage, capacity, fresh)
    source = plugin._gate_anomalies([n.meta.name for n in nodes], high)
    cols = columnarize(nodes, metrics, by_node, args, usage, capacity, fresh)
    cols.pop("pods")
    fit_dims = cols.pop("fit_dims")
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in cols.items()}
    t["source_mask"] = torch.from_numpy(source).to(dev)
    t["rdims"] = t.pop("rdims_onehot").argmax(dim=1).to(torch.int32)
    return t, fit_dims


def lnl_k11_args(t, deviation):
    return (t["usage"], t["capacity"], t["fresh"], t["source_mask"],
            t["pod_node"], t["pod_usage_r"], t["pod_eligible"], t["low"],
            t["high"], t["weights"], t["rdims"], deviation)


def lnl_host(x):
    return tuple(v.cpu() if isinstance(v, torch.Tensor) else v for v in x)


def lnl_equal(label, name, got, want):
    """Max abs difference of the kernel's outputs and the plain
    version's (bools as 0/1); raises unless they are equal."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        g = g.cpu()
        if not torch.equal(g, w):
            raise SystemExit(f"{name} ({label}) differs from its plain "
                             f"version on the host")
        err = max(err, float((g.double() - w.double()).abs().max())
                  if g.numel() else 0.0)
    return err


def lnl_pod_keys(t):
    """K11's sort keys of the pods outside deviation mode, int64, from
    the plain version's terms on the host: the rank of the pod's node
    (sources by weighted usage% descending, stable; non-sources after in
    index order; n for a nodeless pod) above the order bits of -pod_w
    (-0.0 as +0.0). A stable argsort of them is K11's order."""
    t = {k: v.cpu() for k, v in t.items()}
    n = t["usage"].shape[0]
    rd = t["rdims"].long()
    cap = torch.maximum(t["capacity"][:, rd] + 0.0,
                        torch.tensor(LNL_EPS, dtype=torch.float32))
    pct = 100.0 * (t["usage"][:, rd] + 0.0) / cap
    source = t["source_mask"] & t["fresh"] & (pct > t["high"]).any(1)
    node_key = torch.where(source, -weighted_sum(pct, t["weights"]),
                           float("inf"))
    src_rank = torch.empty(n, dtype=torch.int64)
    src_rank[torch.argsort(node_key, stable=True)] = torch.arange(n)
    pn = t["pod_node"].long()
    pod_rank = torch.where(pn >= 0, src_rank[pn.clamp_min(0)], n)
    neg_w = -weighted_sum(t["pod_usage_r"], t["weights"]) + 0.0
    bits = neg_w.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where(bits >= 1 << 31, bits ^ 0xFFFFFFFF,
                          bits | 1 << 31)
    return pod_rank << 32 | ordered


def lnl_bounds(t, eo, fits, fit_dims, ns_n):
    """(bytes, operations) of each kernel on these inputs: each input
    column it needs read once, each output written once; operations as
    this data needs them: K10 the requests of the pods on low nodes
    added, one compare of the fit dims a pod that fits (its first
    candidate can fit) and one a low node for a pod that fits none; K11
    about 8 a node and dim (pct, masks, high_abs, budget term, weight),
    2 a pod and dim, and a comparison sort's N log2 N + P log2 P; K12
    two scan adds and four more a pod and dim; K13 the same and six a
    pod for the caps."""
    n, rd = t["usage"].shape[0], t["pod_usage_r"].shape[1]
    p = t["pod_node"].shape[0]
    f = len(fit_dims)
    low = int(eo.low_mask.sum())
    on_low = int(eo.low_mask.cpu()[t["pod_node"].cpu().clamp_min(0).long()]
                 .logical_and(t["pod_node"].cpu() >= 0).sum())
    n_fit = int(fits.sum())
    k10 = (p * (4 * f + 4) + n * (4 * f + 1) + p,
           on_low * f + low * 2 * f + n_fit * f + (p - n_fit) * low * f)
    k11 = (n * (16 * rd + 3) + p * (10 + 4 * rd) + 20 * rd,
           8 * n * rd + 2 * p * rd + n * np.log2(max(n, 2))
           + p * np.log2(max(p, 2)))
    plan_bytes = p * (4 + 1 + 4 + 4 * rd) + n * 8 * rd + rd * 4 + p
    k12 = (plan_bytes, 6 * p * rd)
    k13 = (plan_bytes + p * 4 + ns_n * 4 + n * 4, 6 * p * rd + 6 * p)
    return {"lnl_node_fit": k10, "lnl_eviction_order": k11,
            "lnl_plan_prefix": k12, "lnl_plan_capped": k13}


def check_lnl(dev, gen, every_node=False):
    """K10-K13 against their plain versions on the host, chained as the
    plan chains them: at config 5's shape (10 000 nodes, the hot nodes'
    pods; timed, with the capped plan's caps), in deviation mode, at
    P = 1, with every pod nodeless, with a budget that binds (a
    thousandth of config 5's), and with every cap binding (8
    namespaces, per-node 1, per-namespace 5, per-cycle 30, seeded
    counts). K11's order, flags and floats bit for bit, the takes
    equal. With `every_node`, the one case of the cluster listing pods
    on every node (40 000 pods: the sorts and scans in device memory),
    timed. Returns {case: result}."""
    base, fit_dims = lnl_columns(dev, every_node=every_node)
    dev_cols, _ = lnl_columns(dev, deviation=True)
    p0, n0 = base["pod_node"].shape[0], base["usage"].shape[0]
    one = dict(base, **{k: base[k][:1].contiguous() for k in (
        "pod_node", "pod_usage_r", "pod_req", "pod_eligible")})
    nodeless = dict(base, pod_node=torch.full_like(base["pod_node"], -1))
    ns8 = torch.randint(0, 8, (p0,), generator=gen, device=dev).to(
        torch.int32)
    caps_cfg5 = (torch.zeros(p0, dtype=torch.int32, device=dev),
                 torch.zeros(8, dtype=torch.int32, device=dev),
                 torch.zeros(n0, dtype=torch.int32, device=dev),
                 4000, 2, 2000)
    caps_bind = (ns8, torch.tensor([1, 0, 2, 0, 0, 1, 0, 0],
                                   dtype=torch.int32, device=dev),
                 torch.randint(0, 2, (n0,), generator=gen, device=dev).to(
                     torch.int32), 30, 1, 5)
    cases = (("config 5", base, False, None, caps_cfg5, True),
             ("deviation", dev_cols, True, None, caps_cfg5, False),
             ("P=1", one, False, None,
              (caps_cfg5[0][:1].contiguous(),) + caps_cfg5[1:], False),
             ("nodeless", nodeless, False, None, caps_cfg5, False),
             ("budget binds", base, False, 0.001, caps_cfg5, False),
             ("caps bind", base, False, None, caps_bind, False))
    if every_node:
        cases = (("every node", base, False, None, caps_cfg5, True),)
    out = {}
    for label, t, deviation, budget_scale, caps, timed in cases:
        k11_args = lnl_k11_args(t, deviation)
        eo = lnl_eviction_order(*k11_args)
        eo_h = lnl_eviction_order_plain(*lnl_host(k11_args))
        err = {"lnl_eviction_order": lnl_equal(label, "K11", tuple(eo),
                                               tuple(eo_h))}
        fit_args = (t["pod_req"], t["pod_node"], t["capacity"], eo.low_mask,
                    fit_dims)
        fits = lnl_node_fit(*fit_args)
        err["lnl_node_fit"] = lnl_equal(
            label, "K10", fits, lnl_node_fit_plain(*lnl_host(fit_args)))
        budget0 = eo.budget0 if budget_scale is None else \
            eo.budget0 * budget_scale
        plan = (eo.order, eo.active & fits, t["pod_node"], t["pod_usage_r"],
                eo.usage_sel, eo.high_abs, budget0)
        take = lnl_plan_prefix(*plan, 1 << 30)
        err["lnl_plan_prefix"] = lnl_equal(
            label, "K12", take, lnl_plan_prefix_plain(*lnl_host(plan),
                                                      1 << 30))
        capped = plan + caps
        take_c = lnl_plan_capped(*capped)
        err["lnl_plan_capped"] = lnl_equal(
            label, "K13", take_c, lnl_plan_capped_plain(*lnl_host(capped)))
        summary = {"max_abs_err": err, "pods": int(t["pod_node"].shape[0]),
                   "fits": int(fits.sum()), "take": int(take.sum()),
                   "take_capped": int(take_c.sum()),
                   "sources": int(t["source_mask"].sum()),
                   "low_nodes": int(eo.low_mask.sum())}
        if budget_scale is not None:
            unbound = lnl_plan_prefix(*plan[:6], eo.budget0, 1 << 30)
            summary["take_unbound"] = int(unbound.sum())
            if not summary["take"] < summary["take_unbound"]:
                raise SystemExit("K12 (budget binds): the budget did not "
                                 "bind")
        if not timed:
            out[label] = summary
            continue
        calls = {
            "lnl_eviction_order": (lambda: lnl_eviction_order(*k11_args),
                                   lambda: lnl_eviction_order_plain(
                                       *k11_args)),
            "lnl_node_fit": (lambda: lnl_node_fit(*fit_args),
                             lambda: lnl_node_fit_plain(*fit_args)),
            "lnl_plan_prefix": (lambda: lnl_plan_prefix(*plan, 1 << 30),
                                lambda: lnl_plan_prefix_plain(
                                    *plan, 1 << 30)),
            "lnl_plan_capped": (lambda: lnl_plan_capped(*capped),
                                lambda: lnl_plan_capped_plain(*capped))}
        bounds = lnl_bounds(t, eo, fits, fit_dims, 8)
        # the one PyTorch call that computes K11's pod order from its
        # keys: a stable argsort of the pods' (node rank, -weight) keys
        # (the node ranks' own sort not counted)
        keys = lnl_pod_keys(t).to(dev)
        if not torch.equal(torch.argsort(keys, stable=True).int(),
                           eo.order):
            raise SystemExit("K11: argsort of its keys differs from its "
                             "order")
        # and K12's: torch.cumsum of its usage columns in plan order (the
        # running sums without the per-node budget and the stops)
        ordered_usage = t["pod_usage_r"][eo.order.long()].contiguous()
        library = {"lnl_eviction_order": cuda_ms(
            lambda: torch.argsort(keys, stable=True)),
            "lnl_plan_prefix": cuda_ms(
                lambda: torch.cumsum(ordered_usage, dim=0))}
        timing = {}
        for name, (kern, plain) in calls.items():
            b_ms, b_by = bound(*bounds[name])
            timing[name] = dict(
                ms=cuda_ms(kern),
                device_ms=device_ms(kern, LNL_SYMBOLS[name]),
                plain_ms=cuda_ms(plain, reps=3),
                library_ms=library.get(name), bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err[name],
                shape=f"N={n0} P={p0} Rd={t['pod_usage_r'].shape[1]} "
                      f"F={len(fit_dims)}")
        out[label] = dict(summary, timing=timing)
    return out


def check_lnl_cases(dev):
    """K11 on `testing/lnl_cases`'s edge cases at config 5's size (N =
    10 000, P = 11 796), on the shape past the old kernel's 32-bit key
    field (N = 10 000, P = 300 000) and on pending pods where the N + 1
    buckets fill whole blocks (N = 1023, 2047), against the plain
    version on the host: order, active, budget0, high_abs, low_mask and
    usage_sel bit for bit. Returns {case: summary}."""
    cases = {name: fn(*lnl_cases.CARD, 7)
             for name, fn in lnl_cases.CASES.items()}
    cases["N=10000 P=300000"] = lnl_cases.big(7)
    for n, p in lnl_cases.BLOCK_EDGES:
        cases[f"pending N={n} P={p}"] = lnl_cases.pending(n, p, 7)
    out = {}
    for label, c in cases.items():
        arrays, deviation = lnl_cases.k11_args(c)
        args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays) + (deviation,)
        want = lnl_eviction_order_plain(*lnl_host(args))
        lnl_equal(label, "K11", tuple(lnl_eviction_order(*args)),
                  tuple(want))
        out[label] = dict(max_abs_err=0.0, nodes=int(c["usage"].shape[0]),
                          pods=int(c["pod_node"].shape[0]),
                          active=int(want.active.sum()),
                          low_nodes=int(want.low_mask.sum()))
    return out


def check_descheduler(line, run, host_names, golden_names, capped):
    """Config 5's plan on the card against the host's (the port's plan
    through the plain versions, and the host loop): equal names in
    order; every evicted pod on a source node; in the capped run the
    caps held; and no node losing a pod once its usage, less the pods
    already taken from it, is at or under high_abs on every threshold
    dim."""
    got = [e.pod.meta.namespaced_name for e in run.evictor.evictions]
    if got != host_names or got != golden_names:
        raise SystemExit(f"{line['metric']}: the card's plan differs from "
                         "the host's")
    if line["evictions_planned"] != len(host_names):
        raise SystemExit(f"{line['metric']}: evictions_planned differs")
    plugin = LowNodeLoad(LowNodeLoadArgs(consecutive_abnormalities=1))
    usage, capacity, low, high, rdims = plugin.classify(
        run.nodes, run.metrics, CONFIG_5_NOW)
    names_ = [n.meta.name for n in run.nodes]
    index = {n: i for i, n in enumerate(names_)}
    sources = {names_[i] for i in np.flatnonzero(high)}
    high_t = np.array([plugin.args.high_thresholds[ResourceKind(d)]
                       for d in rdims], np.float32)
    high_abs = (capacity[:, rdims] * high_t).astype(np.float32) * \
        np.float32(0.01)
    removed = {}
    per_ns = {}
    for e in run.evictor.evictions:
        node = e.pod.node_name
        if node not in sources:
            raise SystemExit(f"{line['metric']}: {e.pod.meta.name} evicted "
                             f"from {node}, not a source node")
        i = index[node]
        rem = removed.get(node, np.zeros(len(rdims), np.float32))
        if not ((usage[i, rdims] - rem) > high_abs[i]).any():
            raise SystemExit(f"{line['metric']}: {node} lost "
                             f"{e.pod.meta.name} below its high threshold")
        req = np.array([e.pod.requests.get(ResourceKind(d), 0.0)
                        for d in rdims], np.float32)
        removed[node] = rem + req
        per_ns[e.pod.meta.namespace] = per_ns.get(e.pod.meta.namespace,
                                                  0) + 1
    if capped:
        caps = CONFIG_5_CAPS
        per_node = {}
        for e in run.evictor.evictions:
            per_node[e.pod.node_name] = per_node.get(e.pod.node_name, 0) + 1
        if (len(got) > caps["max_per_cycle"]
                or max(per_node.values()) > caps["max_per_node"]
                or max(per_ns.values()) > caps["max_per_namespace"]):
            raise SystemExit(f"{line['metric']}: a cap did not hold")


def descheduler_phase(every_node=False):
    """BASELINE config 5 plain and capped at 10 000 nodes on the card
    (`configs.run_config_5_descheduler`: a warm plan, then the timed
    one), counting launches over both plans, then on the host (the
    port's plan through the plain versions, and the host loop LowNodeLoad
    with the same evictor): the plans equal and the invariants held;
    with `every_node`, on the cluster listing pods on every node (40 000
    pods). Returns ({metric: line}, {metric: launches})."""
    lines, launches = {}, {}
    for capped in (False, True):
        kernels.reset_launch_counts()
        line, run = run_config_5_descheduler(capped, device="cuda",
                                             every_node=every_node)
        counts = kernels.launch_counts()
        host_line, host_run = run_config_5_descheduler(
            capped, device="cpu", every_node=every_node)
        evictor = RecordingEvictor(
            EvictionLimiter(**CONFIG_5_CAPS) if capped else None)
        t0 = time.perf_counter()
        LowNodeLoad(LowNodeLoadArgs(consecutive_abnormalities=1),
                    evictor).balance_once(run.nodes, run.metrics,
                                          run.pods_by_node, CONFIG_5_NOW)
        loop_s = time.perf_counter() - t0
        host_names = [e.pod.meta.namespaced_name
                      for e in host_run.evictor.evictions]
        check_descheduler(line, run, host_names,
                          [e.pod.meta.namespaced_name
                           for e in evictor.evictions], capped)
        # two plans a run (the warm one and the timed one): K10 and K11
        # once a plan, K12 once a plain plan, K13 once a capped plan
        want = {"lnl_node_fit": 2, "lnl_eviction_order": 2,
                "lnl_plan_prefix": 0 if capped else 2,
                "lnl_plan_capped": 2 if capped else 0}
        got = {k: counts[k] for k in want}
        others = {k: v for k, v in counts.items() if k not in want and v}
        if got != want or others:
            raise SystemExit(f"{line['metric']}: launches {counts}, "
                             f"expected {want}")
        line.update(launches=got, plans=2, host_value=host_line["value"],
                    host_loop_value=loop_s)
        print(json.dumps(line), flush=True)
        lines[line["metric"]] = line
        launches[line["metric"]] = got
    return lines, launches


# --- the guarded cycle: K14-K16, deltas, forget, the store -----------------

GUARD_SYMBOLS = {"guard_nodes": "guard_nodes_kernel",
                 "guard_pods": ("guard_groups_kernel", "guard_pod_rows_kernel"),
                 "delta_rows": ("delta_winner_kernel", "delta_copy_kernel")}
# gpu_free after a forget against the host's recount: the per-instance
# amounts are floors of whole numbers, so the sums are exact; the bound
# leaves room for one rounding of a 81 920 MiB instance
GPU_FREE_TOL = 1e-2
OVERHEAD_PAIRS = 10


def diff_fields(got, want, path=""):
    """The dotted names of the leaves where two port structs (or
    tensors) differ: f32 bit for bit, other tensors exactly, plain
    values by ==."""
    if isinstance(want, torch.Tensor):
        same = (got.dtype == want.dtype and got.shape == want.shape
                and torch.equal(got.cpu().view(torch.int32)
                                if got.dtype == torch.float32 else got.cpu(),
                                want.cpu().view(torch.int32)
                                if want.dtype == torch.float32
                                else want.cpu()))
        return [] if same else [path]
    if dataclasses.is_dataclass(want):
        out = []
        for f in dataclasses.fields(want):
            out += diff_fields(getattr(got, f.name), getattr(want, f.name),
                               f"{path}.{f.name}" if path else f.name)
        return out
    if isinstance(want, (tuple, list)):
        return sum((diff_fields(g, w, f"{path}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))), [])
    return [] if got == want else [path]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def guard_state(dev, gen):
    """A full-gate batch for K14 and K15: the first packed chunk
    (P = 2000, three families) against 10 000 nodes, partly filled."""
    snap, batch, _, _ = fullgate_state(dev, gen, 10_000)
    return snap, batch


def check_guard_pair(label, snap, batch, force_nodes=None, force_pods=None):
    """K14 and K15 against their plain versions on the card (outputs,
    masks and health bit for bit); returns (node health, pod health)."""
    n_gangs = snap.gangs.min_member.shape[0]
    n_quotas = snap.quotas.parent.shape[0]
    dev = snap.nodes.allocatable.device

    def zeros():
        return torch.zeros(3, dtype=torch.int32, device=dev)
    got_n, got_nb, h_n = guard_nodes(snap.nodes, force_nodes, zeros())
    want_h_n = zeros()
    want_n, want_nb = guard_nodes_plain(snap.nodes, force_nodes, want_h_n)
    bad = diff_fields((got_n, got_nb, h_n), (want_n, want_nb, want_h_n))
    got_p, got_pb, h_p = guard_pods(batch, n_gangs, n_quotas, force_pods,
                                    zeros())
    want_h_p = zeros()
    want_p, want_pb = guard_pods_plain(batch, n_gangs, n_quotas, force_pods,
                                       want_h_p)
    bad += diff_fields((got_p, got_pb, h_p), (want_p, want_pb, want_h_p))
    if bad:
        raise SystemExit(f"K14/K15 ({label}) differ from their plain "
                         f"versions in {bad}")
    return h_n.cpu(), h_p.cpu(), got_n, got_p


def check_guards(dev, gen):
    """K14 guard_nodes and K15 guard_pods at a full-gate batch (N =
    10 000, P = 2000, spread, anti-affinity and affinity), healthy
    (outputs equal to the inputs, health zero; timed, and K14 again at
    Z = 8) and under each of the eight column faults (its bit set, its
    rows in the mask); untimed
    edges: every row bad, N = 1 and P = 1, a family absent, a NaN in an
    invalid pod row, signed zeros and NaN payloads in scrubbed rows, the
    caller's masks (apply_quarantine). Each bit for bit against its plain
    version."""
    out = {}
    snap, batch = guard_state(dev, gen)
    h_n, h_p, q_n, q_p = check_guard_pair("healthy", snap, batch)
    if h_n.any() or h_p.any() or diff_fields(q_n, snap.nodes) or \
            diff_fields(q_p, batch):
        raise SystemExit("K14/K15: a healthy batch changed or scanned bad")
    for i, kind in enumerate(faults.SNAPSHOT_FAULTS + faults.BATCH_FAULTS):
        inj = faults.FaultInjector(100 + i)
        s, b = snap, batch
        if kind in faults.SNAPSHOT_FAULTS:
            s, rows = inj.corrupt_snapshot(snap, kind, 3)
        else:
            b, rows = inj.corrupt_batch(batch, kind, 3)
        h_n, h_p, q_n, q_p = check_guard_pair(kind, s, b)
        word = int(h_n[0]) | int(h_p[0])
        mask = (q_n.schedulable if kind in faults.SNAPSHOT_FAULTS
                else q_p.valid).cpu()
        if not word & faults.EXPECTED_BIT[kind] or mask[rows].any():
            raise SystemExit(f"K14/K15 ({kind}): bit or quarantine missing")
        out[kind] = dict(word=word, bad_nodes=int(h_n[1]),
                         bad_pods=int(h_p[2]), max_abs_err=0.0)
    # edges
    n_gangs = snap.gangs.min_member.shape[0]
    nodes = snap.nodes
    all_bad = snap.replace(nodes=nodes.replace(
        usage=torch.full_like(nodes.usage, float("nan"))))
    pods_bad = batch.replace(requests=-batch.requests - 1.0)
    check_guard_pair("every row bad", all_bad, pods_bad)
    one = snap.replace(nodes=type(nodes)(**{
        f.name: getattr(nodes, f.name)[:1].contiguous()
        for f in dataclasses.fields(nodes)}))
    one_pod = slice_batch(batch, 0, 1).replace(**{
        f: getattr(batch, f)[:, :1].contiguous()
        for f in ("spread_domain", "anti_domain", "aff_domain")})
    check_guard_pair("N = 1, P = 1", one, one_pod)
    check_guard_pair("no anti family", snap, batch.replace(has_anti=False))
    pad = batch.valid.clone()
    pad[-1] = False
    req = batch.requests.clone()
    req[-1, 0] = float("nan")
    h_n, h_p, _, _ = check_guard_pair(
        "NaN in an invalid row", snap, batch.replace(valid=pad, requests=req))
    if not int(h_p[0]) & guards.POD_NONFINITE:
        raise SystemExit("K15 missed a NaN in an invalid pod row")
    special = torch.tensor([-0.0, 0.0, float("nan"), float("inf"),
                            -float("inf"), -2.5, 3.0, -0.0, 1e-30, -1e-30,
                            7.0], device=dev)
    signed = snap.replace(nodes=nodes.replace(
        usage=torch.cat([special[None].expand(4, -1), nodes.usage[4:]]),
        requested=torch.cat([special[None].expand(4, -1),
                             nodes.requested[4:]])))
    spods = batch.replace(requests=torch.cat(
        [special[None].expand(4, -1), batch.requests[4:]]))
    check_guard_pair("signed zeros", signed, spods)
    force_n = torch.rand(snap.num_nodes, generator=gen, device=dev) < 0.3
    force_p = torch.rand(batch.num_pods, generator=gen, device=dev) < 0.3
    check_guard_pair("caller's masks", signed, spods, force_n, force_p)
    out["edges"] = dict(cases=7, max_abs_err=0.0, gangs=n_gangs)
    # timed: the healthy batch
    n, p = snap.num_nodes, batch.num_pods
    health = torch.zeros(3, dtype=torch.int32, device=dev)
    k14_bytes, k14_ops = k14_cost(nodes)
    n_q = snap.quotas.parent.shape[0]
    fams = [(getattr(batch, d), getattr(batch, c))
            for d, c in (("spread_domain", "spread_carrier"),
                         ("anti_domain", "anti_carrier"),
                         ("aff_domain", "aff_carrier"))]
    rows = [batch.requests, batch.estimated, batch.gpu_ratio, batch.valid]
    k15_bytes = (nbytes(*rows) * 2 + p
                 + nbytes(batch.gang_id, batch.quota_id, batch.selector_id,
                          batch.toleration_id)
                 + sum(2 * nbytes(d) + nbytes(c) for d, c in fams))
    k15_ops = (sum(d.numel() for d, _ in fams) * 2
               + sum(t.numel() for t in rows) * 2 + p * 8)
    for name, call, plain, nb, ops in (
            ("guard_nodes",
             lambda: guard_nodes(nodes, None, health),
             lambda: guard_nodes_plain(nodes, None, health),
             k14_bytes, k14_ops),
            ("guard_pods",
             lambda: guard_pods(batch, n_gangs, n_q, None, health),
             lambda: guard_pods_plain(batch, n_gangs, n_q, None, health),
             k15_bytes, k15_ops)):
        b_ms, b_by = bound(nb, ops)
        out[f"{name} full gate"] = dict(
            ms=cuda_ms(call), device_ms=device_ms(call, GUARD_SYMBOLS[name]),
            plain_ms=cuda_ms(plain, reps=5), library_ms=None,
            bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
            shape=f"N={n} P={p} R={nodes.allocatable.shape[1]} "
                  f"Z={nodes.numa_cap.shape[1]} groups "
                  f"{[d.shape[0] for d, _ in fams]}")
    # K14 at Z = 8 (fault C8's width), the same nodes re-split
    wide = with_zones(snap, gen, C8_ZONES).nodes
    zeros = [torch.zeros(3, dtype=torch.int32, device=dev) for _ in range(2)]
    got = guard_nodes(wide, None, zeros[0])
    want = guard_nodes_plain(wide, None, zeros[1])
    if diff_fields(got, (*want, zeros[1])):
        raise SystemExit("K14 at Z=8 differs from its plain version")
    b_ms, b_by = bound(*k14_cost(wide))
    out["guard_nodes Z=8"] = dict(
        ms=cuda_ms(lambda: guard_nodes(wide, None, health)),
        device_ms=device_ms(lambda: guard_nodes(wide, None, health),
                            GUARD_SYMBOLS["guard_nodes"]),
        plain_ms=cuda_ms(lambda: guard_nodes_plain(wide, None, health),
                         reps=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
        shape=f"N={n} R={wide.allocatable.shape[1]} Z={C8_ZONES}")
    return out


def k14_cost(nodes):
    """(bytes, operations) of one K14 call: the scrubbed columns and
    schedulable read once and written once, numa_cap and numa_valid read
    once, the mask written; two operations an entry read."""
    cols = [getattr(nodes, f) for f in guard.NODE_COLUMNS] + [
        nodes.schedulable]
    nb = (nbytes(*cols) * 2 + nbytes(nodes.numa_cap, nodes.numa_valid)
          + nodes.schedulable.shape[0])
    cols += [nodes.numa_cap, nodes.numa_valid]
    return nb, sum(t.numel() for t in cols) * 2


def with_repeats(idx):
    """idx with three rows naming one node (the last wins), a -1 pad and
    indices out of range (dropped)."""
    out = idx.clone()
    out[1] = out[0]
    out[7] = out[0]
    out[2] = -1
    out[3] = 1 << 30
    out[5] = -9
    return out


def delta_columns(snap, d):
    """K16's (column, rows, set) table and index sets of a delta, as
    `snapshot.delta.apply_*` form them."""
    nodes, devices = snap.nodes, snap.devices
    if isinstance(d, NodeTopologyDelta):
        cols = ([(getattr(nodes, f), getattr(d, f), 0)
                 for f in snapshot_delta.TOPOLOGY_NODE_FIELDS]
                + [(getattr(devices, f), getattr(d, f), 0)
                   for f in snapshot_delta.TOPOLOGY_DEVICE_FIELDS]
                + [(getattr(nodes, f), getattr(d.metric, f), 1)
                   for f in snapshot_delta.METRIC_FIELDS])
        return cols, [d.idx, d.metric.idx]
    return ([(getattr(nodes, f), getattr(d, f), 0)
             for f in snapshot_delta.METRIC_FIELDS], [d.idx])


def check_k16(dev, gen):
    """K16 delta_rows at 10 000 nodes: a metric delta of 1000 rows and a
    topology delta of 64 (its nested metric delta too), each timed
    without repeats (beside index_copy_ over the same columns, which
    computes the same rows when no index repeats) and untimed with
    repeated, -1 and out-of-range indices, K = 1 and an empty delta;
    every column bit for bit against the plain version."""
    out = {}
    snap = gpu_share_inputs(2000, 10_000, device=dev)[0]
    n = snap.num_nodes
    for label, make, k in (
            ("metric 1000", synthetic.metric_delta_rows, 1000),
            ("topology 64", synthetic.topology_delta_rows, 64)):
        d = make(snap, k, 7, 1).to(dev)
        for case, dd in (("", d), (" repeats", d.replace(
                idx=with_repeats(d.idx)) if label.startswith("metric")
                else d.replace(idx=with_repeats(d.idx),
                               metric=d.metric.replace(
                                   idx=with_repeats(d.idx)))),
                          (" K=1", None)):
            if dd is None:
                one = make(snap, 1, 8, 1).to(dev)
                cols, idx = delta_columns(snap, one)
            else:
                cols, idx = delta_columns(snap, dd)
            got = delta_rows(cols, idx)
            want = delta_rows_plain(cols, idx)
            bad = [i for i, (g, w) in enumerate(zip(got, want))
                   if diff_fields(g, w)]
            if bad:
                raise SystemExit(f"K16 delta_rows ({label}{case}) differs "
                                 f"from its plain version in columns {bad}")
        cols, idx = delta_columns(snap, d)
        touched = nbytes(*(c for c, _, _ in cols))
        rows_b, idx_b = nbytes(*(r for _, r, _ in cols)), nbytes(*idx)
        ops = len(idx) * k + len(cols) * k
        # the kernels (delta_rows_into on given columns): every row lands
        # (no repeats), so each delta row is read once and written once,
        # each index set read once, and the winner table's K entries of
        # each set written once and read once
        b_ms, b_by = bound(2 * rows_b + idx_b + 2 * 4 * k * len(idx), ops)
        # the whole wrapper (its clones included): each column read once
        # and its new copy written once, the rows and index sets read once
        w_ms, w_by = bound(2 * touched + rows_b + idx_b, ops)
        long_idx = [x.long() for x in idx]
        out_k = [c.clone() for c, _, _ in cols]
        out_p = [c.clone() for c, _, _ in cols]
        out_l = [c.clone() for c, _, _ in cols]

        def library(out=out_l, cols=cols, long_idx=long_idx):
            for o, (_, r, s) in zip(out, cols):
                o.index_copy_(0, long_idx[s], r)

        def library_clones(cols=cols, long_idx=long_idx):
            return [c.clone().index_copy_(0, long_idx[s], r)
                    for c, r, s in cols]
        library()
        want = delta_rows(cols, idx)
        if any(diff_fields(a, b) for a, b in zip(out_l, want)) or any(
                diff_fields(a, b) for a, b in zip(library_clones(), want)):
            raise SystemExit(f"K16 ({label}): index_copy_ differs without "
                             "repeats")
        out[label] = dict(
            ms=cuda_ms(lambda: delta_rows_into(out_k, cols, idx)),
            device_ms=device_ms(lambda: delta_rows_into(out_k, cols, idx),
                                GUARD_SYMBOLS["delta_rows"]),
            plain_ms=cuda_ms(lambda: delta_rows_into_plain(out_p, cols, idx),
                             reps=5),
            library_ms=cuda_ms(library), bound_ms=b_ms, bound_by=b_by,
            max_abs_err=0.0,
            shape=f"N={n} K={k}, {len(cols)} columns, "
                  f"{len(idx)} index sets (rows only: the kernels)",
            with_clones=dict(
                ms=cuda_ms(lambda: delta_rows(cols, idx)),
                plain_ms=cuda_ms(lambda: delta_rows_plain(cols, idx),
                                 reps=5),
                library_ms=cuda_ms(library_clones), bound_ms=w_ms,
                bound_by=w_by))
        if any(diff_fields(a, b) for a, b in zip(out_k, want)) or any(
                diff_fields(a, b) for a, b in zip(out_p, want)):
            raise SystemExit(f"K16 ({label}): the timed in-place calls "
                             "left other columns")
    empty = synthetic.metric_delta_rows(snap, 1, 9, 1).to(dev)
    empty = snapshot_delta.NodeMetricDelta(**{
        f.name: (getattr(empty, f.name)[:0] if f.name != "source_version"
                 else None) for f in dataclasses.fields(empty)})
    cols, idx = delta_columns(snap, empty)
    if any(diff_fields(g, c) for g, (c, _, _) in
           zip(delta_rows(cols, idx), cols)):
        raise SystemExit("K16: an empty delta changed a column")
    return out


def forget_recount(b):
    """The host's numpy recount of a forget: (requested, used, assumed,
    gpu_free) expected from the committed snapshot less the charges of
    the forgotten pods (placed and masked), clamped at 0."""
    res, batch = b["result"], b["batch"]
    snap = res.snapshot
    h = lambda x: x.cpu().numpy()  # noqa: E731
    assign, slot = h(res.assignment), h(res.res_slot)
    und = h(b["forget"]) & (assign >= 0)
    node = und & (slot < 0)
    req = h(batch.requests)
    requested = h(snap.nodes.requested).astype(np.float64)
    np.add.at(requested, assign[node], -req[node])
    used = h(snap.quotas.used).astype(np.float64)
    anc = h(snap.quotas.depth_ancestor)
    qid = h(batch.quota_id)
    for p in np.flatnonzero(und & (qid >= 0)):
        for q in anc[qid[p]]:
            if q >= 0:
                used[q] -= req[p]
    assumed = h(snap.gangs.assumed).astype(np.int64)
    gid = h(batch.gang_id)
    np.add.at(assumed, gid[und & (gid >= 0)], -1)
    _, per = deviceshare.per_instance_at(
        snap.devices, gpu_req_of(batch), res.assignment)
    take = h(res.gpu_take).astype(np.float64)[:, :, None] * h(per)[:, None]
    gpu_free = h(snap.devices.gpu_free).astype(np.float64)
    np.add.at(gpu_free, assign[node], take[node])
    return (np.maximum(requested, 0.0), np.maximum(used, 0.0),
            np.maximum(assumed, 0), gpu_free)


def forget_launches(run):
    """K3's launches in one `store.forget` on the card, counted around a
    forget of the first batch's failed binds on a store holding its
    committed snapshot, which must end equal to the cycle's; every
    other kernel must stay at 0. It must equal the code's count: one
    grouped launch for all its scatters (requested, two estimates, the
    quota levels, gang count, NUMA free of nodes and slots, GPU free of
    nodes and slots, aux free, slot free)."""
    b = run.batches[0]
    res, batch = b["result"], b["batch"]
    store = SnapshotStore(device=res.assignment.device)
    store.publish(res.snapshot)
    kernels.reset_launch_counts()
    store.forget(batch, res, b["forget"])
    counts = kernels.launch_counts()
    want = 1
    others = {k: v for k, v in counts.items()
              if v and k != "ordered_scatter_add"}
    print("forget launches (one store.forget, N = "
          f"{res.snapshot.num_nodes}, P = {batch.num_pods}): "
          + json.dumps({"measured": counts["ordered_scatter_add"],
                        "expected": want}), flush=True)
    if counts["ordered_scatter_add"] != want or others:
        raise SystemExit(f"forget: launches {counts}, expected K3 {want} "
                         "and nothing else")
    if diff_fields(store.current(), b["forgotten"]):
        raise SystemExit("forget: a lone store.forget differs from the "
                         "cycle's")
    return want


def guarded_phase():
    """The guarded cycle (`configs.run_guarded_cycles`: 10 000 nodes, 10
    batches of 2000 full-gate pods, the deltas, the eight column faults,
    the forgets, the checkpoint and restore) on the card, counting
    launches, then on the host: every result, health vector, mask and
    snapshot equal; each fault's bit, quarantine and the masked oracle;
    the clean batches equal to the unguarded program; the rejections;
    forget's return of capacity against the host's recount; the restore.
    Then the guard's overhead on a clean batch. Returns (line,
    launches)."""
    kernels.reset_launch_counts()
    line, run = run_guarded_cycles(device="cuda")
    launches = kernels.launch_counts()
    line["launches"] = launches
    t0 = time.perf_counter()
    host_line, host = run_guarded_cycles(device="cpu")
    host_s = time.perf_counter() - t0
    # two runs, each: K14 once and K15 twice a batch, K16 twice a delta
    # applied (two), the full gate's batch formulas of `check_gpu_share`
    # (no tail), K3 `forget_launches` times a forget, once a batch, and
    # K2's order switch twice a batch (the pods' requests, AllocateOnce;
    # the zone and GPU levels' K2 launches decide their own)
    batches = line["batches"]
    rounds = batches * FULL_GATE_KW["num_rounds"]
    steps = rounds * FULL_GATE_KW["k_choices"]
    per_forget = forget_launches(run)
    want = {"guard_nodes": batches, "guard_pods": 2 * batches,
            "delta_rows": 4, "stage1_mask": batches,
            "numa_pair_terms": batches, "device_pair_terms": batches,
            "score_topk": rounds, "topology_admit": steps,
            "gpu_instance_pick": 2 * steps, "segment_prefix_ok": 4 * steps,
            "topology_prefix_gate": steps,
            "order_switch": 2 * batches,
            "ordered_scatter_add": k3_formula(
                steps, rounds, batches, charged=(1 + per_forget) * batches)}
    want = {k: 2 * v for k, v in want.items()}
    got = {k: launches[k] for k in want}
    if got != want or any(v for k, v in launches.items() if k not in want):
        raise SystemExit(f"guarded cycle: launches {launches}, expected "
                         f"{want} (two runs)")
    diffs = []
    for i, (b, hb) in enumerate(zip(run.batches, host.batches)):
        for key in ("snapshot", "result", "health", "node_bad", "pod_bad",
                    "forgotten"):
            diffs += [f"batch {i} {key}{'.' + f if f else ''}"
                      for f in diff_fields(b[key], hb[key])]
    diffs += [f"final.{f}" for f in diff_fields(run.store.current(),
                                                host.store.current())]
    if diffs or run.rejections != host.rejections:
        raise SystemExit(f"guarded cycle: card differs from host in "
                         f"{diffs[:20]}")
    if [None if r is None else r.value for r in run.rejections] != [
            None, "duplicate_version", "stale_version", None]:
        raise SystemExit(f"guarded cycle: rejections {run.rejections}")
    cfg, step_kw = run.setup["cfg"], run.setup["step_kw"]
    checks = {"oracle": 0, "clean": 0, "forget_pods": 0}
    gpu_err = 0.0
    for i, b in enumerate(run.batches):
        res, kind, rows = b["result"], b["kind"], b["rows"]
        if kind is not None:
            if not int(b["health"][0]) & faults.EXPECTED_BIT[kind]:
                raise SystemExit(f"guarded cycle: {kind} set no bit")
            snap, batch = b["snapshot"], b["batch"]
            at = torch.as_tensor(rows, dtype=torch.long,
                                 device=res.assignment.device)
            if kind in faults.SNAPSHOT_FAULTS:
                if res.snapshot.nodes.schedulable[at].any():
                    raise SystemExit(f"{kind}: a quarantined node is "
                                     "schedulable")
                sched = snap.nodes.schedulable.clone()
                sched[at] = False
                snap = snap.replace(nodes=snap.nodes.replace(
                    schedulable=sched))
            else:
                if (res.assignment[at] >= 0).any():
                    raise SystemExit(f"{kind}: a quarantined pod placed")
                valid = batch.valid.clone()
                valid[at] = False
                batch = batch.replace(valid=valid)
            oracle = schedule_batch(snap, batch, cfg, **step_kw)
            if not torch.equal(oracle.assignment, res.assignment):
                raise SystemExit(f"{kind}: placements differ from the "
                                 "masked oracle")
            checks["oracle"] += 1
        else:
            plain = schedule_batch(b["snapshot"], b["batch"], cfg, **step_kw)
            bad = diff_fields(res, plain)
            if bad or b["health"].any():
                raise SystemExit(f"clean batch {i}: guarded differs from "
                                 f"unguarded in {bad}")
            checks["clean"] += 1
        requested, used, assumed, gpu_free = forget_recount(b)
        f = b["forgotten"]
        got = (f.nodes.requested.cpu().numpy(), f.quotas.used.cpu().numpy(),
               f.gangs.assumed.cpu().numpy())
        if not (np.array_equal(got[0], requested.astype(np.float32))
                and np.array_equal(got[1], used.astype(np.float32))
                and np.array_equal(got[2], assumed.astype(np.int32))):
            raise SystemExit(f"batch {i}: forget's requested, quota used or "
                             "gang assumed differ from the host's recount")
        gpu_err = max(gpu_err, float(np.abs(
            f.devices.gpu_free.cpu().numpy() - gpu_free).max()))
        checks["forget_pods"] += int((b["forget"]
                                      & (res.assignment >= 0)).sum())
    if gpu_err > GPU_FREE_TOL:
        raise SystemExit(f"forget: gpu_free off the recount by {gpu_err}")
    if diff_fields(run.restored.current(), run.store.current()) or (
            run.restored.version != run.store.version
            or run.restored.applied_delta_version
            != run.store.applied_delta_version):
        raise SystemExit("the restored store differs from the checkpointed")
    # the guard's overhead on a clean batch: the guarded and the
    # unguarded batch in OVERHEAD_PAIRS pairs, the order alternating
    # (host dispatch makes a batch's time spread by several ms), and
    # K14 and K15 alone on the same inputs
    b = run.batches[-1]
    snap, batch = b["snapshot"], b["batch"]
    sizes = (snap.gangs.min_member.shape[0], snap.quotas.parent.shape[0])

    def plain_call():
        return schedule_batch(snap, batch, cfg, **step_kw)

    def guard_call():
        return guarded_schedule_batch(snap, batch, cfg, **step_kw)

    def guards_only():
        return guard_nodes(snap.nodes), guard_pods(batch, *sizes)
    times = {"unguarded": [], "guarded": []}
    for i in range(OVERHEAD_PAIRS):
        order = (("unguarded", plain_call), ("guarded", guard_call))
        for side, fn in (order if i % 2 == 0 else order[::-1]):
            times[side].append(cuda_ms(fn, reps=2))
    med = {k: float(np.median(v)) for k, v in times.items()}
    q1, q3 = np.percentile(times["unguarded"], [25, 75])
    line.update(host_value=host_line["value"], host_s=host_s,
                checks=checks, gpu_free_max_err=gpu_err,
                gpu_free_tol=GPU_FREE_TOL,
                guard_overhead_ms=med["guarded"] - med["unguarded"],
                batch_ms_median=med,
                unguarded_iqr_ms=float(q3 - q1),
                guarded_slower_pairs=sum(
                    g > u for g, u in zip(times["guarded"],
                                          times["unguarded"])),
                pairs=OVERHEAD_PAIRS,
                guards_only_ms=cuda_ms(guards_only))
    print("guarded cycle: " + json.dumps(line), flush=True)
    return line, launches


# --- batches above one block, fractional requests, amplified CPU ----------
# K2, K5, K7's take and K8 at P = 2500 (a config-4 chunk) and 4096 against
# their plain versions; K2 on fractional requests at gate boundaries
# (ROADMAP check C-a, fault C7); K1 with the amplified CPU fit; K11 and
# K12 at the every-node config 5 (40 000 pods)

BIG_PODS = (2500, 4096)


def k2_cost(kw):
    """(bytes, operations) of one K2 call on kw, level by level: each pod
    alive and in range sums its earlier same-segment pods (one
    add a column) and compares (3 a column); bytes: active and the
    result, the rank of the active pods, the seg of the pods alive at
    each level, the req of the pods some level gates (once), the base
    and limit rows of the segments in range."""
    p, r = kw["req"].shape[-2:]
    alive = kw["active"]
    nbytes, ops = 2 * p + 4 * int(alive.sum()), 0
    gated = torch.zeros_like(alive)
    for l, (level, (base, limit, s)) in enumerate(zip(kw["seg"],
                                                      kw["tables"])):
        inr = alive & (level < s)
        gated |= inr
        n_in = int(inr.sum())
        n_seg = int(torch.unique(level[inr]).numel())
        nbytes += 4 * int(alive.sum()) + 2 * n_seg * r * 4
        ops += n_in * r * 4
        req = (kw["req0"] if l == 0 and kw.get("req0") is not None
               else kw["req"][l] if kw["req"].dim() == 3 else kw["req"])
        alive = alive & segment_prefix_ok_plain(
            torch.where(alive, level, s).to(torch.int32), kw["rank"],
            torch.where(alive[:, None], req, 0.0), base, limit, s, EPS)
        if l == 0 and kw.get("mask") is not None:
            alive = alive & kw["mask"]
    return nbytes + 4 * r * int(gated.sum()), ops


def check_k2_big(snap, pods, gen):
    """K2 at P = 2500 and 4096 (the tiled walk: 2 tiles of 2048) on the
    flagship's loaded state, as check_k2 at P = 2000: the chain with 70 %
    and 8 % trying, over all 11 dims, one level, the topology mask after
    level 0, and level 0's own requests (an amplified node level: a
    third of the pods CPU-bound, their CPU times 1.5, 2 or 3). Equal to
    the plain version; the chain and the amplified chain timed."""
    dev = snap.nodes.allocatable.device
    out = {}
    for p in BIG_PODS:
        for label, p0, frac, fd, variant, timed in (
                ("chain", 20_000, 0.7, FIT_DIMS, None, True),
                ("chain 8% trying", 30_000, 0.08, FIT_DIMS, None, False),
                ("chain R=11", 40_000, 0.7, ALL_DIMS, None, False),
                ("node level", 50_000, 0.7, FIT_DIMS, "level", False),
                ("chain + mask", 60_000, 0.7, FIT_DIMS, "mask", False),
                ("amplified node level", 70_000, 0.7, FIT_DIMS, "req0",
                 True)):
            kw = k2_case(snap, pods, gen, p0, frac, fd, p=p)
            if variant == "level":
                kw["seg"], kw["tables"] = kw["seg"][:1], kw["tables"][:1]
            if variant == "mask":
                kw["mask"] = torch.rand((p,), generator=gen, device=dev) < 0.8
            if variant == "req0":
                ratios = torch.tensor([1.0, 1.5, 2.0, 3.0], device=dev)
                ratio = ratios[torch.randint(0, 4, (snap.num_nodes + 1,),
                                             generator=gen, device=dev)]
                bind = torch.rand((p,), generator=gen, device=dev) < 0.33
                f = torch.where(bind, ratio[kw["seg"][0].long()], 1.0)
                req0 = kw["req"].clone()
                req0[:, 0] = req0[:, 0] * f
                kw["req0"] = req0
            kw = k2_switch(kw)
            got = segment_prefix_chain(**kw)
            want = segment_prefix_chain_plain(**kw)
            if not torch.equal(got, want):
                raise SystemExit(
                    f"K2 segment_prefix_chain ({label}, P={p}) differs from "
                    f"its plain version at "
                    f"{(got != want).nonzero()[:5, 0].tolist()}")
            stats = dict(max_abs_err=0.0, trying=int(kw["active"].sum()),
                         accepted=int(got.sum()))
            if not 0 < stats["accepted"] < stats["trying"]:
                raise SystemExit(f"K2 ({label}, P={p}): the gate admits "
                                 f"{stats['accepted']} of "
                                 f"{stats['trying']}")
            key = f"{label} P={p}"
            if not timed:
                out[key] = stats
                continue
            b_ms, b_by = bound(*k2_cost(kw))
            out[key] = dict(
                ms=cuda_ms(lambda: segment_prefix_chain(**kw)),
                device_ms=device_ms(lambda: segment_prefix_chain(**kw),
                                    "segment_prefix_chain_kernel"),
                plain_ms=cuda_ms(lambda: segment_prefix_chain_plain(**kw)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                shape=f"P={p} L={len(kw['tables'])} R={kw['req'].shape[1]}",
                **stats)
    return out


def fractional_case(p, seed, offset, segments=40, r=4):
    """K2's single level on fractional requests (tests/
    test_torch_bigbatch.py's case): requests in fractional MiB and mC,
    each segment's memory limit set by its middle pod in rank order so
    that the limit plus EPS is that pod's left side summed in rank order
    in f32, plus `offset`; r = 1 keeps the memory column alone, r > 4
    adds fractional columns whose limits do not bite. Returns the arrays
    and the boundary pods."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, segments, p).astype(np.int32)
    rank = rng.permutation(p).astype(np.int32)
    req = np.zeros((p, max(r, 4)), np.float32)
    req[:, 0] = rng.integers(1, 4000, p) / np.float32(3.0)
    req[:, 1] = rng.uniform(0.1, 2048.0, p)
    req[:, 2] = rng.integers(1, 64, p) / np.float32(8.0)
    req[:, 3] = rng.uniform(0.0, 1.0, p)
    base = rng.uniform(0.0, 5000.0, (segments, max(r, 4))).astype(np.float32)
    if r > 4:
        req[:, 4:] = rng.uniform(0.0, 3000.0, (p, r - 4))
    limit = np.full((segments, max(r, 4)), np.float32(3.0e7))
    order = np.argsort(rank)
    boundary = []
    for s in range(segments):
        pods = order[seg[order] == s]
        if not len(pods):
            continue
        at = pods[len(pods) // 2]
        cum = np.float32(0.0)
        for q in pods[:len(pods) // 2]:
            cum = np.float32(cum + req[q, 1])
        lhs = np.float32(np.float32(base[s, 1] + cum) + req[at, 1])
        limit[s, 1] = np.float32(lhs - np.float32(EPS) + np.float32(offset))
        boundary.append(int(at))
    if r == 1:
        req, base, limit = (np.ascontiguousarray(x[:, 1:2])
                            for x in (req, base, limit))
    return seg, rank, req, base, limit, boundary


def check_k2_fractional(dev):
    """ROADMAP fault C7 on the card: K2 at one level on fractional
    requests, off and on the gate boundaries, at R = 4 for P = 250 (the
    unsorted path's size), 2048 and 2500 (the tiled size), at R = 1 for
    P = 20, 30, 50, 64, 300, 2000, 2500 and 4100 (every form of the
    fused loop's order, `_xla.fused_matvec_form`) and at R = 11: the
    launch finds its sums inexact and takes the pinned form (the
    reference's XLA:CPU order), which must equal the plain version
    (`_xla.xla_mask_dot`) in every verdict. Then the pinned form's time
    at P = 2000 and 2500 (R = 4) beside the scan's on the same case with
    whole-number requests and bases (the launch then keeps the scan).
    Each case also goes through the launch that decides the switch
    itself (`k2_switch`): at P = 2000, 2500 and 4100, R = 1 and 4, its
    verdict is False (the pinned form) and its gate the plain
    version's."""
    out = {}
    for p, r in ((250, 4), (2000, 4), (2048, 4), (2500, 4), (4100, 4),
                 (20, 1), (30, 1), (50, 1), (64, 1), (300, 1), (2000, 1),
                 (2500, 1), (4100, 1), (300, 11), (2048, 11)):
        for offset in (4.0, 0.0):
            seg, rank, req, base, limit, boundary = fractional_case(
                p, p, offset, r=r)
            t = [torch.from_numpy(x).to(dev)
                 for x in (seg, rank, req, base, limit)]
            kw = dict(seg=t[0][None].contiguous(), rank=t[1], req=t[2],
                      active=torch.ones(p, dtype=torch.bool, device=dev),
                      tables=[(t[3], t[4], base.shape[0])], eps=EPS)
            kw = k2_switch(kw)
            if bool(kw["exact"]):
                raise SystemExit(f"K2 on fractional requests (P={p}, R={r}): "
                                 "the order switch kept the scan")
            got = segment_prefix_chain(**kw).cpu()
            want = segment_prefix_chain_plain(**kw).cpu()
            differ = int((got != want).sum())
            out[f"P={p} R={r} {'off' if offset else 'on'} the boundaries"] = \
                dict(differ=differ, boundary_pods=len(boundary),
                     accepted=int(got.sum()),
                     boundary_accepted=int(got[boundary].sum()),
                     max_abs_err=float(differ > 0))
            if differ:
                raise SystemExit(f"K2 on fractional requests (P={p}, R={r}) "
                                 f"differs from its plain version at "
                                 f"{differ} pods")
    for p in (2000, 2500):
        seg, rank, req, base, limit, _ = fractional_case(p, p, 4.0)
        for form, (rq, bs) in (("pinned", (req, base)),
                               ("scan", (np.round(req), np.round(base)))):
            t = [torch.from_numpy(x).to(dev)
                 for x in (seg, rank, rq, bs, limit)]
            kw = dict(seg=t[0][None].contiguous(), rank=t[1], req=t[2],
                      active=torch.ones(p, dtype=torch.bool, device=dev),
                      tables=[(t[3], t[4], base.shape[0])], eps=EPS)
            kw = k2_switch(kw)
            if not torch.equal(segment_prefix_chain(**kw).cpu(),
                               segment_prefix_chain_plain(**kw).cpu()):
                raise SystemExit(f"K2 {form} (P={p}) differs from its plain "
                                 f"version")
            nbytes, ops = k2_cost(kw)
            if form == "pinned":
                # the function's sums in the reference's order: no pod
                # can reuse another's, so each adds the requests of its
                # earlier same-segment pods, n_s (n_s - 1) / 2 pods of
                # R columns a segment of n_s pods (the pinned form's own
                # walk over all P^2 pairs is its cost, not the work's)
                n_s = torch.bincount(t[0].long(), minlength=base.shape[0])
                ops += int((n_s * (n_s - 1) // 2).sum()) * rq.shape[1]
            b_ms, b_by = bound(nbytes, ops)
            out[f"{form} P={p}"] = dict(
                ms=cuda_ms(lambda: segment_prefix_chain(**kw)),
                device_ms=device_ms(lambda: segment_prefix_chain(**kw),
                                    "segment_prefix_chain_kernel"),
                plain_ms=cuda_ms(lambda: segment_prefix_chain_plain(**kw),
                                 reps=3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=0.0, shape=f"P={p} L=1 R=4 S=40")
    return out


# --- the aux (RDMA/FPGA) pools: K17, K6's aux part, K2's aux levels --------


def aux_state(dev, n_nodes=10_000, p=2000, j=8):
    """The aux full gate's first packed chunk of p pods against n_nodes
    (`aux_full_gate_inputs` with j VFs a GPU node, packed by
    `pack_full_gate`): (snapshot, batch, prefixes)."""
    snap, pods = aux_full_gate_inputs(5 * p, n_nodes, device=dev,
                                      aux_instances=j)
    packed, prefixes, _, _, _ = pack_full_gate(snap, pods, p)
    return snap, slice_batch(packed, 0, p), prefixes


def aux_choice(snap, batch, gen):
    """Chosen nodes as a step sees them: an aux pod on a node with a VF
    of its pool (half of them among 16 popular ones, so pods contend
    for one VF), the others on any node."""
    dev = batch.valid.device
    n, p = snap.num_nodes, batch.num_pods
    req = deviceshare.aux_request(batch.requests)
    has_vf = snap.devices.aux_valid.any(dim=2)                 # [N, 2]
    pool = (req[:, 1] > 0).long()
    choice = torch.randint(0, n, (p,), generator=gen, device=dev)
    for t in range(2):
        nodes = torch.nonzero(has_vf[:, t])[:, 0]
        if not nodes.numel():
            continue
        pick = nodes[torch.randint(0, nodes.numel(), (p,), generator=gen,
                                   device=dev)]
        popular = nodes[torch.randint(0, min(16, nodes.numel()), (p,),
                                      generator=gen, device=dev)]
        hot = torch.rand(p, generator=gen, device=dev) < 0.5
        on = (req > 0).any(dim=1) & (pool == t)
        choice = torch.where(on, torch.where(hot, popular, pick), choice)
    return choice.to(torch.int32), req.contiguous()


def check_k17(dev, gen):
    """K17 aux_instance_pick against its plain version: on random pools
    with ties (a node whose VFs all hold the same free), invalid VFs, a
    node with none, zero and oversize requests and choices out of range,
    both strategies and P = 1, untimed; then at the aux full gate's
    first chunk (P = 2000 against N = 10 000, J = 8), both strategies,
    and with 64 VFs a GPU node ("least"), timed. Instances and ok must
    be equal."""
    out = {}
    rng = np.random.default_rng(17)
    n, j, p = 64, 8, 4096
    free = rng.choice(np.asarray([0.0, 25.0, 50.0, 100.0], np.float32),
                      size=(n, 2, j))
    valid = rng.uniform(size=(n, 2, j)) < 0.8
    valid[2] = False
    free[3] = 50.0
    edge = None  # the aux full gate's devices with these pools, below
    choice = torch.from_numpy(rng.integers(-3, n + 3, p).astype(
        np.int32)).to(dev)
    req = torch.from_numpy(rng.choice(np.asarray(
        [0.0, 25.0, 50.0, 60.0, 100.0, 150.0], np.float32),
        size=(p, 2))).to(dev)
    cases = [(f"edge {s}", choice, req, edge, s) for s in ("least", "most")]
    cases.append(("P=1", choice[:1].clone(), req[:1].clone(), edge, "most"))
    snap, batch, _ = aux_state(dev)
    ch, rq = aux_choice(snap, batch, gen)
    cases += [(f"aux full gate {s}", ch, rq, snap.devices, s)
              for s in ("least", "most")]
    wide, wbatch, _ = aux_state(dev, j=C8_VFS)
    wch, wrq = aux_choice(wide, wbatch, gen)
    cases.append((f"aux full gate J={C8_VFS} least", wch, wrq, wide.devices,
                  "least"))
    edge = snap.devices.replace(aux_free=torch.from_numpy(free).to(dev),
                                aux_valid=torch.from_numpy(valid).to(dev))
    cases = [(lb, c, r, edge if d is None else d, st)
             for lb, c, r, d, st in cases]
    for label, c, r, d, strategy in cases:
        got = aux_instance_pick(c, r, d.aux_free, d, strategy)
        want = aux_instance_pick_plain(c, r, d.aux_free, d, strategy)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise SystemExit(f"K17 aux_instance_pick ({label}) differs from "
                             f"its plain version")
        res = dict(max_abs_err=0.0, ok=int(got[1].sum()),
                   asking=int((r > 0).sum()))
        if label.startswith("aux full gate"):
            # bytes: choice and req read, the chosen nodes' VF rows (free
            # and valid) once, inst and ok written; operations: an add, two
            # compares and a select a VF of each (pod, pool)
            nodes = int(torch.unique(c.clamp(0, d.aux_free.shape[0] - 1)
                                     .long()).numel())
            jj = d.aux_free.shape[2]
            nbytes = c.numel() * (4 + 8 + 10) + nodes * 2 * jj * 5
            ops = c.numel() * 2 * jj * 4
            b_ms, b_by = bound(nbytes, ops)
            res.update(
                ms=cuda_ms(lambda: aux_instance_pick(c, r, d.aux_free, d,
                                                     strategy)),
                device_ms=device_ms(lambda: aux_instance_pick(
                    c, r, d.aux_free, d, strategy),
                    "aux_instance_pick_kernel"),
                plain_ms=cuda_ms(lambda: aux_instance_pick_plain(
                    c, r, d.aux_free, d, strategy), reps=5),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                shape=f"P={c.numel()} N={d.aux_free.shape[0]} J={jj}")
        out[label] = res
    return out


def check_k6_aux(dev, gen):
    """K6 with its aux part at the aux full gate's first chunk (its gpu
    prefix's rows against N = 10 000, ANDed into a pair mask in place,
    both strategies), timed beside K6 on the same rows without it, and
    untimed on the same cluster with no GPU instance (the aux part
    alone, no score). Equal to the plain version (bools, scores bit for
    bit)."""
    out = {}
    snap, batch, prefixes = aux_state(dev)
    rows = prefixes["gpu"]
    d = snap.devices
    g = gpu_req_of(batch)[:rows].contiguous()
    a = deviceshare.aux_request(batch.requests)[:rows].contiguous()
    n = snap.num_nodes
    pair = torch.rand((batch.num_pods, n), generator=gen, device=dev) < 0.8
    no_gpu = d.replace(gpu_free=d.gpu_free[:, :0].contiguous(),
                       gpu_valid=d.gpu_valid[:, :0].contiguous())
    for label, dd, aux, strategy, timed in (
            ("aux full gate least", d, a, "least", True),
            ("aux full gate most", d, a, "most", False),
            ("without the aux part", d, None, "least", True),
            ("no GPU instance", no_gpu, a, "least", False)):
        ok, score = device_pair_terms(g, dd, strategy, pair.clone(), aux)
        want_ok, want_score = device_pair_terms_plain(g, dd, strategy, pair,
                                                      aux)
        same = torch.equal(ok, want_ok) and (
            score is None and want_score is None or torch.equal(
                score.view(torch.int32), want_score.view(torch.int32)))
        if not same:
            raise SystemExit(f"K6 with the aux part ({label}) differs from "
                             f"its plain version")
        res = dict(max_abs_err=0.0, pairs_ok=int(ok[:rows].sum()))
        if timed:
            i = d.gpu_free.shape[1]
            jj = d.aux_free.shape[2]
            nbytes = rows * (12 + (8 if aux is not None else 0)) + n * (
                12 + i * 13 + (2 * jj * 5 if aux is not None else 0)
            ) + rows * n * 6
            n_gpu = int((g > 0).any(dim=1).sum())
            ops = (rows - n_gpu) * n + n_gpu * n * (45 + 7 * i) + (
                rows * n * 4 if aux is not None else 0)
            b_ms, b_by = bound(nbytes, ops)
            buf = pair.clone()
            res.update(
                ms=cuda_ms(lambda: device_pair_terms(g, dd, strategy, buf,
                                                     aux)),
                device_ms=device_ms(lambda: device_pair_terms(
                    g, dd, strategy, buf, aux), "device_pair_terms_kernel"),
                plain_ms=cuda_ms(lambda: device_pair_terms_plain(
                    g, dd, strategy, pair, aux), reps=3),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                shape=f"rows={rows} N={n} I={i} "
                      f"J={jj if aux is not None else 0} and-into mask")
        out[label] = res
    return out


def check_k2_aux(dev, gen):
    """K2 as the step's two aux levels (core.py:1020-1039) at the aux full
    gate's first chunk: K17's choice on the chunk's chosen nodes, the
    (node, pool, instance) segments, pool 1's fit ANDed in after pool 0's
    gate, against the live free; 90 % of the pods arriving accepted.
    Equal to the plain version; timed."""
    snap, batch, _ = aux_state(dev)
    d = snap.devices
    choice, req = aux_choice(snap, batch, gen)
    inst, ok = aux_instance_pick(choice, req, d.aux_free, d, "least")
    p, n, jj = batch.num_pods, snap.num_nodes, d.aux_free.shape[2]
    s = n * 2 * jj
    has = req > 0
    seg = deviceshare.aux_segments(choice, inst, has, jj, s).T.contiguous()
    fit = ~has | ok
    accept = torch.rand(p, generator=gen, device=dev) < 0.9
    kw = dict(seg=seg, rank=rank_by_priority(batch), req=req.T.contiguous()[
        :, :, None], active=accept & fit[:, 0],
        tables=[(torch.zeros((s, 1), device=dev), d.aux_free.view(s, 1), s)]
        * 2, eps=EPS, mask=fit[:, 1].contiguous())
    kw = k2_switch(kw)
    got = segment_prefix_chain(**kw)
    want = segment_prefix_chain_plain(**kw)
    if not torch.equal(got, want):
        raise SystemExit("K2's aux levels differ from the plain version")
    nbytes, ops = k2_cost(kw)
    b_ms, b_by = bound(nbytes, ops)
    return {"aux levels": dict(
        ms=cuda_ms(lambda: segment_prefix_chain(**kw)),
        device_ms=device_ms(lambda: segment_prefix_chain(**kw),
                            "segment_prefix_chain_kernel"),
        plain_ms=cuda_ms(lambda: segment_prefix_chain_plain(**kw), reps=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
        shape=f"P={p} L=2 R=1 S={s}", asking=int(has.any(dim=1).sum()),
        rejected=int(((accept & fit.all(dim=1)) & ~got).sum()))}


def k5_cost(args, full, z):
    """(bytes, operations) of one K5 call: the pod columns (choice,
    trying, numa_single, demand), the zone rows of the chosen nodes
    (cap, used, valid, policy) once a node, and the outputs; per engaged
    pod, M = 2^Z masks: a mask's combined free (3 a zone and dim) and
    fit (4), its free cpu (2 a zone), its key (9 with the argmin); the
    greedy take (8 a zone) and its total (2 a zone and 2); per pod not
    engaged, its policy (2)."""
    p = args[0].shape[0]
    m = 1 << z
    engaged = int(full.engaged.sum())
    n_rows = int(torch.unique(args[0][args[1]]).numel())
    nbytes = p * 14 + n_rows * (z * 17 + 4) + p * (z * 17 + 6)
    ops = engaged * (m * (8 * z + 13) + 10 * z + 2) + (p - engaged) * 2
    return nbytes, ops


def check_k5_big(dev, gen):
    """K5 at P = 2500 and 4096 (a grid of blocks, no cap) on config 2's
    nodes at Z = 2, every policy code, strategy "most"; equal to the
    plain version in every output; timed."""
    out = {}
    for p in BIG_PODS:
        snap, pods = numa_state(dev, gen, 1000, 2)
        args = k5_args(snap, slice_batch(pods, 0, p), gen) + ("most",)
        got = topology_admit(*args)
        same_outputs(f"K5 topology_admit (P={p})", got,
                     topology_admit_plain(*args))
        b_ms, b_by = bound(*k5_cost(args, got, 2))
        out[f"P={p}"] = dict(
            ms=cuda_ms(lambda: topology_admit(*args)),
            device_ms=device_ms(lambda: topology_admit(*args),
                                "topology_admit_kernel"),
            plain_ms=cuda_ms(lambda: topology_admit_plain(*args), reps=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
            shape=f"P={p} S=1000 Z=2", engaged=int(got.engaged.sum()))
    return out


def check_k7_big(dev, gen):
    """K7's two launches and the K2 gate between them (`k7_chain`) at a
    gpu_share step of P = 2500 and 4096 pods (N = 10 000, I = 8, the
    affinity from K5), strategy "least", the take launch timed; and
    untimed at P = 4096 with I = 24 and 56. Each equal to its plain
    version."""
    out = {}
    for p, gpus in [(p, 8) for p in BIG_PODS] + [(BIG_PODS[-1], g)
                                                  for g in C8_GPUS]:
        label = f"take P={p}" + ("" if gpus == 8 else f" I={gpus}")
        snap, batch = gpu_state(dev, gen, 10_000 if gpus == 8 else 2000,
                                6000, p, gpus=gpus)
        n = snap.num_nodes
        st = gpu_step(snap, batch, gen)
        r = k7_chain(label, snap, st, "least")
        pick, alive, take_args, fin = (r["pick"], r["alive"],
                                       r["take_args"], r["fin"])
        if gpus != 8:
            out[label] = dict(max_abs_err=0.0, **r["stats"])
            continue
        d = snap.devices
        i = d.gpu_free.shape[1]
        b_ms, b_by = bound(*k7_take_cost(st, pick, alive, i))
        out[label] = dict(
            ms=cuda_ms(lambda: gpu_instance_pick(*take_args, chosen=pick)),
            device_ms=device_ms(
                lambda: gpu_instance_pick(*take_args, chosen=pick), K7_TAKE),
            plain_ms=cuda_ms(lambda: gpu_take_plain(
                st["choice"], alive, pick, d, *r["zone"]), reps=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
            shape=f"P={p} N={n} I={i}, take", **r["stats"])
    return out


# fault C8's widths: eight NUMA zones a node (two sockets at NPS4 or
# SNC-4), an 8-GPU node split into 3 and into 7 MIG slices, 64 RDMA VFs
C8_ZONES = 8
C8_GPUS = (24, 56)
C8_VFS = 64


def chunk_card_vs_host(label, snap, batch, kw, kernels_used):
    """One schedule_batch chunk on the card and on the host: every field
    of the result equal (f32 bit for bit, the post-commit snapshot
    included), and each kernel of `kernels_used` launched in the card's
    run."""
    dev = snap.nodes.allocatable.device
    kernels.reset_launch_counts()
    got = schedule_batch(snap, batch, loadaware.LoadAwareConfig.make(
        device=dev), **kw)
    launched = kernels.launch_counts()
    want = schedule_batch(snap.to("cpu"), batch.to("cpu"),
                          loadaware.LoadAwareConfig.make(device="cpu"), **kw)
    bad = diff_fields(got, want)
    if bad:
        raise SystemExit(f"schedule_batch ({label}): the card differs from "
                         f"the host in {bad}")
    missing = [k for k in kernels_used
               if dev.type == "cuda" and not launched[k]]
    if missing:
        raise SystemExit(f"schedule_batch ({label}) never launched "
                         f"{missing}: {launched}")
    return dict(placed=int((got.assignment >= 0).sum()),
                launches={k: launched[k] for k in kernels_used})


def c8_cases(dev, gen, n=1000, p=1000):
    """The cases of fault C8 (`check_c8`), as (label, function) pairs;
    each function holds the card to the plain version or to the host
    and returns what it counted."""
    cases = []

    def numa_cases():
        snap, pods = numa_state(dev, gen, n, C8_ZONES)
        batch = slice_batch(pods, 0, p)
        out = {}
        for strategy in ("most", "least"):
            args = k4_args(snap, batch, strategy)
            ok, score = numa_pair_terms(*args)
            want_ok, want_score = numa_pair_terms_plain(*args)
            if not (torch.equal(ok, want_ok) and torch.equal(
                    score.view(torch.int32), want_score.view(torch.int32))):
                raise SystemExit(f"K4 at Z={C8_ZONES} ({strategy}) differs "
                                 "from its plain version")
            args = k5_args(snap, batch, gen, trying_frac=0.9) + (strategy,)
            one = tuple(a[:1] if k < 4 else a for k, a in enumerate(args))
            for a in (args, one):
                same_outputs(f"K5 at Z={C8_ZONES} ({strategy}, P="
                             f"{a[0].shape[0]})", topology_admit(*a),
                             topology_admit_plain(*a))
            out[strategy] = dict(pairs_ok=int(ok.sum()))
        # K2's zone chain, one level a zone (core.py:617-622)
        kw = zone_chain_kw(snap, batch, gen)
        got = segment_prefix_chain(**kw)
        if not torch.equal(got, segment_prefix_chain_plain(**kw)):
            raise SystemExit(f"K2's zone chain at L={C8_ZONES} differs "
                             "from its plain version")
        out["zone chain"] = dict(active=int(kw["active"].sum()),
                                 accepted=int(got.sum()))
        return out
    cases.append((f"Z={C8_ZONES} K4, K5, K2's zone chain", numa_cases))

    def guard_case():
        snap, _ = numa_state(dev, gen, n, C8_ZONES)
        nodes = snap.nodes
        free = nodes.numa_free.clone()
        free[::97, 5, 0] = -1.0
        free[::89, 7, 1] = float("nan")
        out = {}
        for label, nd in (("healthy", nodes),
                          ("zones 5 and 7 bad", nodes.replace(
                              numa_free=free))):
            zeros = [torch.zeros(3, dtype=torch.int32, device=dev)
                     for _ in range(2)]
            got = guard_nodes(nd, None, zeros[0])
            want = guard_nodes_plain(nd, None, zeros[1])
            bad = diff_fields(got, (*want, zeros[1]))
            if bad:
                raise SystemExit(f"K14 at Z={C8_ZONES} ({label}) differs "
                                 f"from its plain version in {bad}")
            out[label] = [int(x) for x in got[2].cpu()]
        return out
    cases.append((f"Z={C8_ZONES} K14", guard_case))

    def numa_chunk():
        snap, pods = numa_state(dev, gen, n, C8_ZONES)
        return chunk_card_vs_host(
            f"config 2 chunk at Z={C8_ZONES}", snap, slice_batch(pods, 0, p),
            CONFIG_2_KW, NUMA_KERNELS)
    cases.append((f"Z={C8_ZONES} schedule_batch chunk", numa_chunk))

    for gpus in C8_GPUS:
        def gpu_kernels(gpus=gpus):
            out = {}
            for label, edge, strategy in (("least", False, "least"),
                                          ("most", False, "most"),
                                          ("edge least", True, "least"),
                                          ("edge most", True, "most")):
                snap, batch = gpu_state(dev, gen, n, 0, p, edge, gpus)
                g, d = gpu_req_of(batch), snap.devices
                pair = torch.rand((p, n), generator=gen, device=dev) < 0.8
                ok, score = device_pair_terms(g, d, strategy, pair.clone())
                want_ok, want_score = device_pair_terms_plain(g, d, strategy,
                                                              pair)
                if not (torch.equal(ok, want_ok) and torch.equal(
                        score.view(torch.int32),
                        want_score.view(torch.int32))):
                    raise SystemExit(f"K6 at I={gpus} ({label}) differs "
                                     "from its plain version")
                st = gpu_step(snap, batch, gen)
                args = k5_gpu_args(snap, st, strategy)
                same_outputs(f"K5 with hints at I={gpus} ({label})",
                             topology_admit(*args),
                             topology_admit_plain(*args))
                r = k7_chain(f"I={gpus} {label}", snap, st, strategy)
                out[label] = dict(pairs_ok=int(ok.sum()), **r["stats"])
            return out
        cases.append((f"I={gpus} K6, K5 with hints, K7", gpu_kernels))

        def gpu_chunk(gpus=gpus):
            snap, batch = gpu_state(dev, gen, n, 0, p, gpus=gpus)
            return chunk_card_vs_host(
                f"gpu_share chunk at I={gpus}", snap, batch, GPU_SHARE_KW,
                NUMA_KERNELS + GPU_KERNELS)
        cases.append((f"I={gpus} schedule_batch chunk", gpu_chunk))

    def both_wide():
        snap, batch = gpu_state(dev, gen, n, 0, p, gpus=C8_GPUS[-1])
        snap = with_zones(snap, gen, C8_ZONES)
        st = gpu_step(snap, batch, gen)
        for strategy in ("most", "least"):
            args = k5_gpu_args(snap, st, strategy)
            same_outputs(f"K5 with hints at Z={C8_ZONES} I={C8_GPUS[-1]} "
                         f"({strategy})", topology_admit(*args),
                         topology_admit_plain(*args))
        k7_chain(f"Z={C8_ZONES} I={C8_GPUS[-1]}", snap, st, "least")
        return chunk_card_vs_host(
            f"gpu_share chunk at Z={C8_ZONES} I={C8_GPUS[-1]}", snap, batch,
            GPU_SHARE_KW, NUMA_KERNELS + GPU_KERNELS)
    cases.append((f"Z={C8_ZONES} I={C8_GPUS[-1]} K5, K7, schedule_batch "
                  "chunk", both_wide))

    def aux_cases():
        snap, batch, prefixes = aux_state(dev, n, p, j=C8_VFS)
        d = snap.devices
        ch, rq = aux_choice(snap, batch, gen)
        out = {}
        for strategy in ("least", "most"):
            for label, c, r in ((strategy, ch, rq),
                                (f"{strategy} P=1", ch[:1], rq[:1])):
                got = aux_instance_pick(c, r, d.aux_free, d, strategy)
                want = aux_instance_pick_plain(c, r, d.aux_free, d, strategy)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise SystemExit(f"K17 at J={C8_VFS} ({label}) differs "
                                     "from its plain version")
                out[f"K17 {label}"] = dict(ok=int(got[1].sum()))
            rows = prefixes["gpu"]
            g = gpu_req_of(batch)[:rows].contiguous()
            a = deviceshare.aux_request(batch.requests)[:rows].contiguous()
            pair = torch.rand((batch.num_pods, n), generator=gen,
                              device=dev) < 0.8
            no_gpu = d.replace(gpu_free=d.gpu_free[:, :0].contiguous(),
                               gpu_valid=d.gpu_valid[:, :0].contiguous())
            for label, dd in ((strategy, d), (f"{strategy}, no GPU", no_gpu)):
                ok, score = device_pair_terms(g, dd, strategy, pair.clone(),
                                              a)
                want_ok, want_score = device_pair_terms_plain(
                    g, dd, strategy, pair, a)
                same = torch.equal(ok, want_ok) and (
                    score is None and want_score is None or torch.equal(
                        score.view(torch.int32),
                        want_score.view(torch.int32)))
                if not same:
                    raise SystemExit(f"K6's aux part at J={C8_VFS} ({label}) "
                                     "differs from its plain version")
                out[f"K6 {label}"] = dict(pairs_ok=int(ok[:rows].sum()))
        return out
    cases.append((f"J={C8_VFS} K6's aux part, K17", aux_cases))

    def above_caps():
        # one past each kernel's cap: the wrapper refuses it on the card,
        # naming the cap, and falls back to nothing
        snap, pods = numa_state(dev, gen, 200, C8_ZONES + 1)
        batch = slice_batch(pods, 0, 100)
        gsnap, gbatch = gpu_state(dev, gen, 200, 0, 100, gpus=65)
        st = gpu_step(gsnap, gbatch, gen)
        asnap, abatch, _ = aux_state(dev, 200, 200, j=65)
        ch, rq = aux_choice(asnap, abatch, gen)
        g = gpu_req_of(abatch)
        a = deviceshare.aux_request(abatch.requests).contiguous()
        zero = torch.zeros(3, dtype=torch.int32, device=dev)
        calls = {
            "K4 Z=9": lambda: numa_pair_terms(*k4_args(snap, batch, "most")),
            "K5 Z=9": lambda: topology_admit(*k5_args(snap, batch, gen),
                                             "most"),
            "K14 Z=9": lambda: guard_nodes(snap.nodes, None, zero),
            "K6 I=65": lambda: device_pair_terms(gpu_req_of(gbatch),
                                                 gsnap.devices, "least"),
            "K7 I=65": lambda: gpu_instance_pick(
                st["choice"], st["accept"], st["gpu_req"], gsnap.devices,
                None, None, "least"),
            "K17 J=65": lambda: aux_instance_pick(
                ch, rq, asnap.devices.aux_free, asnap.devices, "least"),
            "K6 aux J=65": lambda: device_pair_terms(
                g, asnap.devices, "least", None, a),
        }
        out = {}
        for label, fn in calls.items():
            try:
                fn()
            except ValueError as e:
                out[label] = str(e)
                continue
            raise SystemExit(f"{label}: above its cap, the wrapper did not "
                             "raise")
        return out
    cases.append(("above the caps", above_caps))
    return cases


def check_c8(dev, gen, n=1000, p=1000, keep_going=False):
    """Fault C8: the reference takes any zone and instance width, so the
    card must too (up to the kernels' caps, Z <= 8, I <= 64, J <= 64).
    At Z = 8: K4 and K5 (both strategies, P = 1), K2's 8-level zone
    chain, K14 healthy and with bad zones, and one config-2 chunk
    (`schedule_batch(enable_numa=True)`, P = 1000 against N = 1000); at
    I = 24 and 56: K6, K5 with DeviceShare's hints and K7's two launches
    around the K2 gate (both strategies, the edge state), and one
    gpu_share chunk; at Z = 8 with I = 56: K5, K7 and one chunk; at J =
    64: K17 (both strategies, P = 1) and K6's aux part (with and without
    GPU instances). Each against its plain version on the card, each
    chunk card against host in every field. With `keep_going` a case's
    exception is recorded and the next case runs (the parent's run)."""
    out = {}
    for label, fn in c8_cases(dev, gen, n, p):
        try:
            out[label] = fn()
        except (ValueError, RuntimeError, SystemExit) as e:
            if not keep_going:
                raise
            out[label] = dict(raised=type(e).__name__, message=str(e))
    return out


def check_k8_big(dev, gen):
    """K8 at a gpu_share step of P = 2500 and 4096 pods (N = 10 000 and 64
    slots, the workload's 40 groups; the blocks of each tile of 2048
    gated pods walk every tile of charging ones), equal to the plain
    version; timed."""
    out = {}
    for p in BIG_PODS:
        snap, batch = gpu_state(dev, gen, 10_000, 8000, p)
        batch, topo, counts, _, lim = topo_state(snap, batch, gen)
        choice, trying, rank = k8_step(snap, batch, gen)
        fams = domains.step_families(topo, counts, lim)
        got = topology_prefix_gate(choice, trying, rank, fams)
        want = topology_prefix_gate_plain(choice, trying, rank, fams)
        if not torch.equal(got, want):
            raise SystemExit(f"K8 topology_prefix_gate (P={p}) differs from "
                             f"its plain version at "
                             f"{(got != want).nonzero()[:5, 0].tolist()}")
        rejected = int((trying & ~got).sum())
        if not rejected:
            raise SystemExit(f"K8 (P={p}): the gates reject no pod")
        b_ms, b_by = bound(*k8_cost(choice, trying, fams))
        out[f"P={p}"] = dict(
            ms=cuda_ms(lambda: topology_prefix_gate(choice, trying, rank,
                                                    fams)),
            device_ms=device_ms(
                lambda: topology_prefix_gate(choice, trying, rank, fams),
                "topology_prefix_kernel"),
            plain_ms=cuda_ms(lambda: topology_prefix_gate_plain(
                choice, trying, rank, fams), reps=3),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
            shape=(f"P={p} X={snap.num_nodes + 64} columns="
                   f"{sum(f.dom_x.shape[0] for f in fams)}"),
            trying=int(trying.sum()), rejected=rejected)
    return out


def check_k1_amp(snap, pods, cfg, gen):
    """K1 with the amplified CPU fit (`AmpTerms`) at the sweep's shape
    (P = 2000 against the loaded 10 000 nodes, k = 8), a third of the
    nodes amplified (CPU allocatable times 1.5, 2 or 3) and a third of
    the pods CPU-bound; and untimed with fit_dims over all 11 dims.
    Equal to the plain version; the amplified term must remove pairs.
    The sweep's batch is timed three ways on the same state: amplified,
    with every node's ratio 1 (the term in, removing nothing) and with
    no term (K1 as an unamplified batch runs it)."""
    from koordinator_tpu_torch.kernels.score_topk import AmpTerms, amp_fit
    dev = snap.nodes.allocatable.device
    ratios = torch.tensor([1.5, 2.0, 3.0], device=dev)
    n = snap.num_nodes
    on = torch.rand((n,), generator=gen, device=dev) < 0.33
    ratio = torch.where(on, ratios[torch.randint(
        0, 3, (n,), generator=gen, device=dev)], 1.0)
    alloc = snap.nodes.allocatable.clone()
    alloc[:, CPU] = alloc[:, CPU] * ratio
    # the amplified nodes nearly full: 0 to 8000 mC of CPU headroom, so
    # that a bound pod's amplified request misses where its raw one fits
    head = torch.floor(torch.rand((n,), generator=gen, device=dev) * 16.0) \
        * 500.0
    requested = snap.nodes.requested.clone()
    requested[:, CPU] = torch.where(
        on, torch.clamp_min(alloc[:, CPU] - head, 0.0), requested[:, CPU])
    amp_snap = snap.replace(nodes=snap.nodes.replace(allocatable=alloc,
                                                     requested=requested))
    cases = {}
    for fd in (FIT_DIMS, ALL_DIMS):
        kw = k1_case(amp_snap, pods, cfg, 80_000, 2000, 8, gen, fd,
                     SCORE_DIMS)
        bind = torch.rand((2000,), generator=gen, device=dev) < 0.33
        col = fd.index(CPU)
        if fd is FIT_DIMS:
            cases["sweep"] = dict(kw, amp=AmpTerms(bind, ratio, col))
            cases["ratio 1"] = dict(kw, amp=AmpTerms(
                bind, torch.ones_like(ratio), col))
            cases["no term"] = dict(kw, amp=None)
        else:
            cases["R=11"] = dict(kw, amp=AmpTerms(bind, ratio, col))
    out = {}
    for label, kw in cases.items():
        (val, idx), err = k1_equal(f"amplified {label}", kw)
        amp = kw["amp"]
        gates = kw["gates"]
        checked = expand_gates(gates) & kw["row_ok"][:, None]
        fit = torch.all(kw["req_fit"][:, None, :] + kw["requested_fit"][None]
                        <= kw["alloc_fit"][None] + EPS, dim=-1)
        # the pairs the fit admits and the amplified term removes
        removed = 0 if amp is None else int((checked & fit & ~amp_fit(
            amp, kw["req_fit"], kw["requested_fit"], kw["alloc_fit"],
            EPS)).sum())
        if (removed > 0) != (label in ("sweep", "R=11")):
            raise SystemExit(f"K1 amplified ({label}): the term removes "
                             f"{removed} pairs")
        if label == "R=11":
            out[label] = dict(max_abs_err=err, removed_pairs=removed)
            continue
        p, f = kw["req_fit"].shape
        d = kw["est"].shape[1]
        n_rows = int(kw["row_ok"].sum())
        n_checked = int(checked.sum())
        feasible = checked & fit
        if amp is not None:
            feasible = feasible & amp_fit(amp, kw["req_fit"],
                                          kw["requested_fit"],
                                          kw["alloc_fit"], EPS)
        n_feasible = int(feasible.sum())
        n_needed, n_terms = k1_needed_pairs(kw, checked, val, idx)
        active = int((kw["row_ok"] & gates.device_ok).sum())
        # bytes: as check_k1's, plus (with the term) the ratio a node and
        # the bind flag a pod. Operations: `bound_ms` as check_k1's, a
        # selection that prunes by node bounds (the amplified term only
        # removes pairs, so the bounds hold), plus 3 (a product, a sum,
        # a compare) a needed pair of a bound pod; `bound_ms_all_pairs`
        # a selection that prunes nothing, plus 3 a checked pair of a
        # bound pod.
        nbytes = p * (f + d) * 4 + n * (2 * f + 3 * d) * 4 + d * 4 \
            + p * 8 * 8 + p * 9 + n * 8 + gates.selector_match.numel() \
            + (n * 4 + p if amp is not None else 0)
        n_bind_needed = n_bind = 0
        if amp is not None:
            n_bind_needed = k1_needed_pairs(
                kw, checked & amp.bind[:, None], val, idx)[0]
            n_bind = int((checked & amp.bind[:, None]).sum())
        ops = active * n + n * (3 + n_terms * (5 * d + 3)) \
            + n_needed * (2 * f + 8 * d + 4) + n_bind_needed * 3
        ops_all = n_rows * n + n_checked * 2 * f + n * (f + 2 * d) \
            + n_feasible * (8 * d + 4) + n_bind * 3
        b_ms, b_by = bound(nbytes, ops)
        masked = torch.where(feasible, tie_break_jitter(
            loadaware.least_requested_score(
                kw["est"], kw["prod_scored"], kw["node_term"],
                kw["prod_term"], kw["alloc_score"], gates.metric_fresh,
                kw["weights"], kw["fma_sum"])), -1.0)
        out[label] = dict(
            ms=cuda_ms(lambda: score_topk(**kw)),
            device_ms=device_ms(lambda: score_topk(**kw),
                                "score_topk_kernel"),
            plain_ms=cuda_ms(lambda: score_topk_plain(**kw), reps=3),
            library_ms=cuda_ms(lambda: torch.topk(masked, 8, dim=1)),
            bound_ms=b_ms, bound_by=b_by,
            bound_ms_all_pairs=bound(nbytes, ops_all)[0], max_abs_err=err,
            shape=f"P={p} N={n} k=8 F={f} D={d}, {label}",
            removed_pairs=removed, feasible_pairs=n_feasible,
            needed_pairs=n_needed)
    return out


def config_4_phase():
    """BASELINE config 4 (`configs.run_config_4_quota`: 50 000 pods x 5000
    nodes, 500 quotas, chunks of 2500) on the card after a warm-up run,
    counting launches: K2 once an inner step (every one at P = 2500, the
    tiled walk), K1 once a round, nothing of the NUMA, DeviceShare or
    topology paths; no overcommit, quota within runtime. Then its first
    20 000 pods (eight chunks, the same nodes and quotas) on the card
    and on the host: the assignment and every leaf of the final snapshot
    equal (the whole queue's host run, about 40 s, was cut to keep the
    script's time). Returns (line, launches)."""
    run_config_4_quota(device="cuda")                     # warm-up
    kernels.reset_launch_counts()
    line, run = run_config_4_quota(device="cuda")
    launches = kernels.launch_counts()
    _, run = run_config_4_quota(CONFIG_4_COMPARED_PODS, device="cuda")
    t0 = time.perf_counter()
    host_line, host = run_config_4_quota(CONFIG_4_COMPARED_PODS, device="cpu")
    line.update(launches=launches, host_s=time.perf_counter() - t0,
                compared_pods=CONFIG_4_COMPARED_PODS,
                host_placed=host_line["placed"])
    got = dict(to_numpy(run.snapshot), assignment=run.assignment.cpu().numpy())
    want = dict(to_numpy(host.snapshot), assignment=host.assignment.numpy())
    differ = []

    def walk(g, w, prefix):
        for k, v in w.items():
            if isinstance(v, dict):
                walk(g[k], v, f"{prefix}{k}.")
            elif isinstance(v, np.ndarray) and not (
                    g[k].dtype == v.dtype and np.array_equal(g[k], v)):
                differ.append(prefix + k)
    walk(got, want, "")
    line["differing_fields"] = differ
    print("config 4: " + json.dumps(line), flush=True)
    if differ:
        raise SystemExit(f"config 4: the card differs from the host in "
                         f"{differ}")
    chunks = line["num_pods"] // line["chunk"]
    rounds = chunks * CONFIG_4_KW["num_rounds"]
    steps = rounds * CONFIG_4_KW["k_choices"]
    want_l = {"score_topk": rounds, "segment_prefix_ok": steps,
              "order_switch": chunks, "numa_pair_terms": 0,
              "topology_admit": 0,
              "device_pair_terms": 0, "gpu_instance_pick": 0,
              "topology_prefix_gate": 0, "stage1_mask": 0}
    for name, count in want_l.items():
        if launches[name] != count:
            raise SystemExit(f"config 4: {name} launched {launches[name]} "
                             f"times, not {count}")
    if not (overcommit_ok(run.snapshot) and quota_ok(run.snapshot)
            and 0 < line["placed"] <= line["num_pods"]):
        raise SystemExit("config 4: overcommit, quota over runtime or "
                         f"placed {line['placed']}")
    return line, launches


def amplified_phase():
    """full_gate_amplified_100kx10k: the packed full gate on a cluster
    whose node webhook amplified the CPU of about 30 % of the nodes,
    amplification on (`configs.run_full_gate(amplified=True)`). Card
    against host, every field equal, at 5000 pods x 10 000 nodes (the
    full width) in chunks of 2500, two chunks and the tail, so that
    K2, K5, K7's take and K8 run their forms above 2048 pods inside the
    batch (an earlier comparison at 8000 x 1000 was cut to keep the
    script's time; the full gate's phase 7 compares that size). Then
    at 100 000 x 10 000 on the card, counting launches, with the full
    gate's launch formulas and invariants (node requested the recount
    with the bind pods' CPU amplified) and the bind pods placed on
    amplified nodes. Returns (line, launches)."""
    for num_pods, num_nodes, chunk in ((5000, 10_000, 2500),):
        runs = {}
        for d in ("cuda", "cpu"):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            _, run, _ = run_full_gate(num_pods, num_nodes, chunk, device=d,
                                      amplified=True)
            runs[d] = (flat_run(run), time.perf_counter() - t0,
                       kernels.launch_counts())
        got, want = runs["cuda"][0], runs["cpu"][0]
        differ = [f for f in got if not (
            got[f].dtype == want[f].dtype and np.array_equal(got[f],
                                                             want[f]))]
        label = f"{num_pods}x{num_nodes} chunk {chunk}"
        launches = runs["cuda"][2]
        print(f"amplified full gate {label}: " + json.dumps({
            "differing_fields": differ, "fields": len(got),
            "seconds": {k: v[1] for k, v in runs.items()},
            "placed": int((got["assignment"] >= 0).sum()),
            "launches": launches}), flush=True)
        if differ:
            raise SystemExit(f"amplified full gate {label}: the card differs "
                             f"from the host in {differ}")
        idle = [k for k in ("score_topk", "segment_prefix_ok",
                            "topology_admit", "gpu_instance_pick",
                            "topology_prefix_gate") if not launches[k]]
        if idle:
            raise SystemExit(f"amplified full gate {label}: {idle} never "
                             "launched")
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    line, run, setup = run_full_gate(device="cuda", amplified=True)
    launches = kernels.launch_counts()
    line["launches"] = launches
    line["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    snap0, pods = setup["snap"], setup["pods"]
    ratio = snap0.nodes.cpu_amplification
    assign = run.assignment
    bound_amp = (assign >= 0) & (run.res_slot < 0) & pods.numa_single
    line["bind_pods_on_amplified_nodes"] = int(
        (bound_amp & (ratio[assign.clamp_min(0).long()] > 1.0)).sum())
    print("amplified full gate: " + json.dumps(line), flush=True)
    if not line["bind_pods_on_amplified_nodes"]:
        raise SystemExit("amplified full gate: no CPU-bind pod sits on an "
                         "amplified node")
    check_gpu_share(run, line, launches, snap0, pods, setup["step_kw"],
                    setup["tail_kw"], name="amplified full gate")
    return line, launches


def aux_invariants(snap0, pods, run, line, name):
    """The aux pools' invariants on a whole run: the batch-start free
    less every placed pod's request at its (node, pool, instance) equals
    the final free exactly; no VF below 0; every placed aux pod's VF
    valid on its node, and every pod holding a VF placed and asking for
    its pool."""
    d0 = snap0.devices
    n, _, j = d0.aux_free.shape
    req = deviceshare.aux_request(pods.requests)
    inst, assign = run.aux_inst, run.assignment
    held = inst >= 0
    if not bool((held <= ((assign >= 0)[:, None] & (req > 0))).all()):
        raise SystemExit(f"{name}: a VF held by an unplaced pod or for a "
                         "pool it does not ask for")
    flat = deviceshare.aux_segments(assign.clamp_min(0), inst, held, j,
                                    n * 2 * j).long()
    if not bool(d0.aux_valid.reshape(-1)[flat[held]].all()):
        raise SystemExit(f"{name}: a placed pod holds an invalid VF")
    want = torch.zeros(n * 2 * j + 1, dtype=torch.float64,
                       device=assign.device).index_add_(
        0, flat.reshape(-1), torch.where(held, req, 0.0).double().reshape(-1))
    final = run.snapshot.devices.aux_free
    if not torch.equal(final.double().reshape(-1),
                       d0.aux_free.double().reshape(-1) - want[:-1]):
        raise SystemExit(f"{name}: the final VF free is not the batch-start "
                         "free less the placed pods' requests")
    if not bool((final >= 0).all()):
        raise SystemExit(f"{name}: a VF's free is negative")
    line["aux_vfs_held"] = int(held.sum())


def aux_phase():
    """full_gate_aux_100kx10k: the packed full gate on a cluster with aux
    pools (`configs.run_full_gate(aux=True)`): card against host, every
    field equal (aux_inst and aux_free included), at 8000 pods x 1000
    nodes in chunks of 2000, and on the first full-width chunk (2000
    pods of the 100 000 against 10 000 nodes, one batch); then at
    100 000 x 10 000 on the card, counting launches, with the full
    gate's launch formulas (K17 and K2 once more a step) and
    invariants, the aux invariants (`aux_invariants`), and aux pods
    both placed and turned away by K2's aux levels (counted by
    `aux_stats` in the untimed first chunk, which is the run's first
    batch: the timed run counts nothing). Returns (line, launches)."""
    runs = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        line_s, run, _ = run_full_gate(8000, 1000, 2000, device=d, aux=True)
        runs[d] = (flat_run(run), time.perf_counter() - t0, line_s)
    got, want = runs["cuda"][0], runs["cpu"][0]
    differ = [f for f in got if not (
        got[f].dtype == want[f].dtype and np.array_equal(got[f], want[f]))]
    print("aux full gate 8000x1000: " + json.dumps({
        "differing_fields": differ, "fields": len(got),
        "seconds": {k: v[1] for k, v in runs.items()},
        **{k: runs["cuda"][2][k] for k in (
            "placed", "aux_pods", "aux_placed", "aux_no_fit")}}), flush=True)
    if differ or "aux_inst" not in got:
        raise SystemExit(f"aux full gate 8000x1000: the card differs from "
                         f"the host in {differ}")
    # the first full-width chunk, one batch on each (the whole run's
    # first batch), counting the pods the aux gates turn away
    first = {}
    for d in ("cuda", "cpu"):
        snap, pods = aux_full_gate_inputs(device=d)
        packed, _, _, step_kw, _ = pack_full_gate(snap, pods, 2000)
        stats = {}
        t0 = time.perf_counter()
        res = schedule_batch(snap, slice_batch(packed, 0, 2000),
                             loadaware.LoadAwareConfig.make(device=d),
                             aux_stats=stats, **step_kw)
        flat = {k: v.cpu().numpy() for k, v in (
            ("assignment", res.assignment), ("aux_inst", res.aux_inst),
            ("gpu_take", res.gpu_take), ("res_slot", res.res_slot),
            ("numa_zone", res.numa_zone), ("chosen_score", res.chosen_score))}
        flat.update({f"snapshot.{k}": v for k, v in to_numpy(
            res.snapshot.devices).items() if isinstance(v, np.ndarray)})
        flat.update({f"snapshot.nodes.{k}": v for k, v in to_numpy(
            res.snapshot.nodes).items() if isinstance(v, np.ndarray)})
        flat.update({f"aux_{k}": np.asarray(int(v))
                     for k, v in stats.items()})
        first[d] = (flat, time.perf_counter() - t0)
    differ = [f for f in first["cuda"][0] if not np.array_equal(
        first["cuda"][0][f], first["cpu"][0][f])]
    turned_away = {k: int(first["cuda"][0][f"aux_{k}"])
                   for k in ("no_instance", "gate_rejected")}
    print("aux full gate, first chunk at 10 000 nodes: " + json.dumps({
        "differing_fields": differ, "fields": len(first["cuda"][0]),
        "seconds": {k: v[1] for k, v in first.items()},
        "placed": int((first["cuda"][0]["assignment"] >= 0).sum()),
        "vfs_held": int((first["cuda"][0]["aux_inst"] >= 0).sum()),
        "aux_turned_away": turned_away}), flush=True)
    if differ:
        raise SystemExit(f"aux full gate first chunk: the card differs from "
                         f"the host in {differ}")
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    line, run, setup = run_full_gate(device="cuda", aux=True)
    launches = kernels.launch_counts()
    line["launches"] = launches
    line["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    snap0, pods = setup["snap"], setup["pods"]
    aux_invariants(snap0, pods, run, line, "aux full gate")
    line["first_chunk_aux_turned_away"] = turned_away
    print("aux full gate: " + json.dumps(line), flush=True)
    if not (line["aux_placed"] > 0 and min(turned_away.values()) > 0
            and min(line["aux_no_fit"].values()) > 0):
        raise SystemExit("aux full gate: aux pods must both place and be "
                         "turned away (no fitting VF, K2's aux levels, in "
                         "the run's first batch), and each kind must have "
                         "pods no node fits: " + json.dumps(
                             {k: line[k] for k in (
                                 "aux_placed", "first_chunk_aux_turned_away",
                                 "aux_no_fit")}))
    check_gpu_share(run, line, launches, snap0, pods, setup["step_kw"],
                    setup["tail_kw"], name="aux full gate")
    return line, launches


def small_config_phase(name, run_fn, kw):
    """A BASELINE config on the card, counting launches, then on the
    host: the assignment and every leaf of the final snapshot equal;
    only K1-K3 launched. Returns (line, launches)."""
    kernels.reset_launch_counts()
    line, run = run_fn(device="cuda", **kw)
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    _, host = run_fn(device="cpu", **kw)
    line.update(launches=launches, host_s=time.perf_counter() - t0)
    got = dict(to_numpy(run.snapshot), assignment=run.assignment.cpu().numpy())
    want = dict(to_numpy(host.snapshot), assignment=host.assignment.numpy())
    differ = []

    def walk(g, w, prefix):
        for k, v in w.items():
            if isinstance(v, dict):
                walk(g[k], v, f"{prefix}{k}.")
            elif isinstance(v, np.ndarray) and not (
                    g[k].dtype == v.dtype and np.array_equal(g[k], v)):
                differ.append(prefix + k)
    walk(got, want, "")
    line["differing_fields"] = differ
    print(f"{name}: " + json.dumps(line), flush=True)
    if differ:
        raise SystemExit(f"{name}: the card differs from the host in "
                         f"{differ}")
    if any(launches[k] for k in launches if k not in SLIM_KERNELS) or min(
            launches[k] for k in SLIM_KERNELS) <= 0:
        raise SystemExit(f"{name}: launched other than K1-K3, or one of "
                         f"them never: {launches}")
    if not (overcommit_ok(run.snapshot) and quota_ok(run.snapshot)
            and 0 < line["placed"] <= line["num_pods"]):
        raise SystemExit(f"{name}: overcommit, quota over runtime or placed "
                         f"{line['placed']}")
    return line, launches

# --- the ElasticQuota fair share (K18, K3 as the fold) and koord-manager's
# overcommit (K19) ---------------------------------------------------------


def quota_chain(dev, depth=6, width=3, q=32, seed=3):
    """A six-level chain (root, then `width` children a level, the first
    of which parents the next level) where no quota lends; fractional
    mins, maxes, weights and demand in CPU and memory. Returns (quotas,
    cluster_total)."""
    rng = np.random.default_rng(seed)
    parent, head = [-1], 0
    for _ in range(1, depth):
        first = len(parent)
        parent += [head] * width
        head = first
    n, r, f32 = len(parent), len(ALL_DIMS), np.float32
    par = np.full((q,), -1, np.int32)
    par[:n] = parent
    da = np.full((q, 6), -1, np.int32)
    anc = np.zeros((q, q), bool)
    for i in range(n):
        chain = [i]
        while par[chain[-1]] >= 0:
            chain.append(int(par[chain[-1]]))
        da[i, :len(chain)] = chain[::-1]
        anc[i, chain] = True
    mx = np.full((q, r), np.inf, f32)
    mx[:n, :2] = rng.uniform(2e4, 8e4, (n, 2))
    mn = np.zeros((q, r), f32)
    mn[:n, :2] = rng.uniform(0, 1.5e4, (n, 2))
    sw = np.zeros((q, r), f32)
    sw[:n, :2] = rng.uniform(0.1, 3.0, (n, 2))
    dem = np.zeros((q, r), f32)
    dem[:n, :2] = rng.uniform(0, 6e4, (n, 2))
    quotas = from_reference("QuotaState", dict(
        min=mn, max=mx, shared_weight=sw, parent=par, ancestors=anc,
        depth_ancestor=da, used=np.zeros_like(mn), demand=dem,
        allow_lent=np.zeros((q,), bool), runtime=mx.copy(),
        valid=np.arange(q) < n), dev)
    total = np.zeros((r,), f32)
    total[:2] = (1e5, 2e5)
    return quotas, torch.from_numpy(total).to(dev)


@functools.lru_cache(maxsize=None)
def fair_share_state(dev):
    """(snap, pods, cluster_total) of config_4_fair_share_500q_50k on
    `dev`, built once for phase 2 and phase 16 (nothing changes them)."""
    return fair_share_inputs(device=dev)


def k18_cases(dev):
    """{label: (quotas, cluster_total, max_iters)}: the fair-share tree
    (50 000 pods folded, Q = 512), config 4's own tree (degenerate in
    CPU and memory), a six-level chain that lends nothing, the fair
    share with unlimited memory maxes below the root and CPU weights
    zeroed, the cap max_iters = 2, and one quota (Q = 1)."""
    snap, pods, total = fair_share_state(dev)
    folded = add_pending_demand(snap.quotas, pods)
    mx, sw = folded.max.clone(), folded.shared_weight.clone()
    mx[1:, 1] = float("inf")
    sw[:, CPU] = 0.0
    s4, p4 = config_4_inputs(device=dev)
    t4 = s4.nodes.allocatable.double().sum(dim=0).float()
    one = from_reference("QuotaState", dict(
        min=np.zeros((1, 11), np.float32),
        max=np.full((1, 11), 5e4, np.float32),
        shared_weight=np.zeros((1, 11), np.float32),
        parent=np.full((1,), -1, np.int32), ancestors=np.ones((1, 1), bool),
        depth_ancestor=np.array([[0, -1, -1, -1, -1, -1]], np.int32),
        used=np.zeros((1, 11), np.float32),
        demand=np.full((1, 11), 7e4, np.float32),
        allow_lent=np.ones((1,), bool),
        runtime=np.zeros((1, 11), np.float32),
        valid=np.ones((1,), bool)), dev)
    chain, chain_total = quota_chain(dev)
    return {"fair share": (folded, total, 64),
            "config 4 tree": (add_pending_demand(s4.quotas, p4), t4, 64),
            "6-level chain": (chain, chain_total, 64),
            "inf max, zero weights": (folded.replace(max=mx,
                                                     shared_weight=sw),
                                      total, 64),
            "max_iters 2": (folded, total, 2),
            "Q=1": (one, total, 64)}


def k18_cost(quotas, rounds):
    """(bytes, operations) of one forest solve: the QuotaState's columns
    read once and the runtime and limited demand written once; the adds
    of the demand's propagation (each child's clamped demand once, each
    row's five level sums), and a level's work a round from the rounds
    the kernel ran (the total weight and the returned excess summed over
    the level's rows, six operations a row for delta and its clamp),
    with the start sum and one more weight sum for the loop's exit."""
    q, r = quotas.min.shape
    nbytes = 6 * q * r * 4 + q * (4 + 24 + 2) + r * 4
    depth = quota_depth(quotas).cpu()
    with_parent = int((quotas.parent >= 0).sum())
    ops = with_parent * r + 5 * q * r
    for d in range(1, 6):
        rows = int(((depth == d) & quotas.valid.cpu()).sum()) * r
        ops += rows * (2 + int(rounds[d]) * 8)
    return nbytes, ops


def check_k18(dev):
    """K18 quota_runtime against its plain version on the host (runtime,
    limited demand and rounds a level, bit for bit) on each of
    `k18_cases`, and on the fair share stopped after the demand
    (propagate_demand alone); timed on the fair-share tree."""
    out = {}
    for label, (q, total, it) in k18_cases(dev).items():
        got = quota_runtime(q, total, it)
        want = quota_runtime_plain(q.to("cpu"), total.cpu(), it)
        for f in ("runtime", "limited"):
            g, w = getattr(got, f).cpu(), getattr(want, f)
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise SystemExit(f"K18 quota_runtime ({label}): {f} differs "
                                 f"from its plain version")
        if not torch.equal(got.rounds.cpu(), want.rounds):
            raise SystemExit(f"K18 quota_runtime ({label}): rounds "
                             f"{got.rounds.tolist()} against "
                             f"{want.rounds.tolist()}")
        res = dict(max_abs_err=0.0, rounds=got.rounds.tolist(),
                   shape=f"Q={q.min.shape[0]} R={q.min.shape[1]} "
                         f"max_iters={it}")
        if label == "fair share":
            only = quota_runtime(q, None, demand_only=True)
            if only.runtime is not None or not torch.equal(
                    only.limited.cpu().view(torch.int32),
                    want.limited.view(torch.int32)):
                raise SystemExit("K18 quota_runtime (demand only) differs "
                                 "from its plain version")
            nbytes, ops = k18_cost(q, got.rounds.cpu())
            b_ms, b_by = bound(nbytes, ops)
            res.update(
                ms=cuda_ms(lambda: quota_runtime(q, total, it)),
                device_ms=device_ms(lambda: quota_runtime(q, total, it),
                                    "quota_runtime_kernel"),
                demand_only_ms=cuda_ms(lambda: quota_runtime(
                    q, None, demand_only=True)),
                plain_ms=cuda_ms(lambda: quota_runtime_plain(q, total, it),
                                 reps=3),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                bound_counts={"bytes": nbytes, "operations": ops})
        out[label] = res
    return out


def check_fold(dev):
    """K3 as the pending-demand fold (`add_pending_demand`): the fair
    share's 50 000 pods with 10 % quota-less, 5 % invalid and 1 % beyond
    the table, into the 512-row tree at R = 11, against the fold on the
    host, bit for bit; timed, beside index_add_ of the kept rows (the
    library call) and the plain scatter on the card."""
    snap, pods, _ = fair_share_state(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    u = torch.rand((3, pods.num_pods), generator=gen, device=dev)
    qid = torch.where(u[0] < 0.1, -1, pods.quota_id)
    qid = torch.where(u[1] < 0.01, 600, qid).to(torch.int32)
    pods = pods.replace(quota_id=qid, valid=pods.valid & (u[2] >= 0.05))
    quotas = snap.quotas
    got = add_pending_demand(quotas, pods).demand.cpu()
    want = add_pending_demand(quotas.to("cpu"), pods.to("cpu")).demand
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise SystemExit("K3 as the fold differs from the fold on the host")
    q, r = quotas.demand.shape
    p = pods.num_pods
    kernels.reset_launch_counts()
    add_pending_demand(quotas, pods)
    launches = kernels.launch_counts()["ordered_scatter_add"]
    req = pods.requests * pods.valid[:, None]
    tgt = torch.where(pods.quota_id >= 0, pods.quota_id, q).to(torch.int32)
    keep = tgt < q
    kidx, krows = tgt[keep].long(), req[keep]
    # requests, valid and quota ids read once, the demand read and
    # written once; an add a kept pod and column
    b_ms, b_by = bound(p * (r * 4 + 1 + 4) + 2 * q * r * 4,
                       int(keep.sum()) * r)
    if launches != 1:
        raise SystemExit(f"K3 as the fold launched {launches} times, not "
                         "once")
    return {"fair share fold": dict(
        max_abs_err=0.0, launches=launches,
        hottest_row=int(torch.bincount(kidx, minlength=q).max()),
        ms=cuda_ms(lambda: add_pending_demand(quotas, pods)),
        device_ms=device_ms(lambda: add_pending_demand(quotas, pods),
                            "ordered_scatter_add_kernel") * launches,
        plain_ms=cuda_ms(lambda: ordered_scatter_add_plain(
            quotas.demand, tgt, req)),
        library_ms=cuda_ms(lambda: quotas.demand.clone().index_add_(
            0, kidx, krows)),
        bound_ms=b_ms, bound_by=b_by, kept=int(keep.sum()),
        shape=f"P={p} Q={q} R={r} in one launch")}


def k19_columns(dev, n, seed=19):
    """K19's arguments on n nodes: random columns with NaN, +-inf, -0 and
    negative entries, every CPU policy and memory policy."""
    rng = np.random.default_rng(seed)

    def col(scale):
        x = rng.uniform(-0.1, 1.0, (n, 2)) * scale
        k = rng.uniform(size=(n, 2))
        x = np.where(k < 0.01, np.nan, x)
        x = np.where((k >= 0.01) & (k < 0.02), np.inf, x)
        x = np.where((k >= 0.02) & (k < 0.03), -np.inf, x)
        x = np.where((k >= 0.03) & (k < 0.04), -0.0, x)
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    return [col(1e5), col(3e4), col(5e3), col(8e3), col(4e4), col(3e4),
            col(4e4),
            torch.from_numpy(rng.uniform(size=n) < 0.5).to(dev),
            torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(dev),
            col(1e5), col(3e4), col(1.0)]


def same_floats(got, want) -> bool:
    """NaN where the other has NaN (a NaN's payload is the device's own),
    every other entry bit for bit."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def check_k19(dev):
    """K19 node_overcommit against its plain version on the host at
    10 000 nodes, every policy, NaN, +-inf, -0 and negative inputs (NaN
    where the host has NaN, other entries bit for bit); timed."""
    args = k19_columns(dev, 10_000)
    got = node_overcommit(*args)
    want = node_overcommit_plain(*(a.cpu() for a in args))
    for name, g, w in zip(("batch", "mid"), got, want):
        if not same_floats(g, w):
            raise SystemExit(f"K19 node_overcommit: {name} differs from its "
                             f"plain version")
    n = args[0].shape[0]
    # ten [N, 2] columns, the policy bytes read once, batch and mid written
    b_ms, b_by = bound(n * (10 * 8 + 1 + 4 + 2 * 8), n * 2 * 12)
    return {"10k nodes": dict(
        max_abs_err=0.0, nan_rows=int(torch.isnan(want[0]).any(1).sum()),
        ms=cuda_ms(lambda: node_overcommit(*args)),
        device_ms=device_ms(lambda: node_overcommit(*args),
                            "node_overcommit_kernel"),
        plain_ms=cuda_ms(lambda: node_overcommit_plain(*args)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=f"N={n}")}


def fair_share_phase():
    """config_4_fair_share_500q_50k (`run_config_4_fair_share`: the fold,
    K18's runtime, config 4's sweep with four quota levels) on the card
    after a warm-up run, counting launches; then once more with the
    sweep at runtime = max that counts the pods the runtime turns away,
    whose extra launches are that sweep's. The fair share launches K18
    once, K3 once more than that sweep (the fold), K1, K2 and the
    order switch as that sweep, nothing else. Then the card's runtime
    equal to the host's plain water-fill of the same folded tree, bit
    for bit; quota used within runtime + EPS at every level; the tree
    binding (quotas below their limited demand at levels 1-3, pods
    turned away). Then the first FAIR_SHARE_COMPARED_PODS pods' run on
    the card and on the host: the assignment and every leaf of the final
    snapshot equal. Returns (line, launches)."""
    run_config_4_fair_share(device="cuda")                # warm-up
    kernels.reset_launch_counts()
    line, run = run_config_4_fair_share(device="cuda")
    launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    both, _ = run_config_4_fair_share(device="cuda", count_turned_away=True)
    sweep = {k: v - launches[k] for k, v in kernels.launch_counts().items()}
    line.update({k: both[k] for k in ("placed_at_max", "turned_away")})
    fold = 1
    want = dict(sweep, quota_runtime=1,
                ordered_scatter_add=sweep["ordered_scatter_add"] + fold)
    if launches != want or both["placed"] != line["placed"]:
        raise SystemExit(f"fair share: launches {launches}, not {want}, or "
                         f"the runs differ")
    line.update(launches=launches, fold_launches=fold)
    total = fair_share_state(torch.device("cuda"))[2]
    host = quota_runtime_plain(run.quotas.to("cpu"), total.cpu())
    if not (torch.equal(run.quotas.runtime.cpu().view(torch.int32),
                        host.runtime.view(torch.int32))
            and torch.equal(run.limited.cpu().view(torch.int32),
                            host.limited.view(torch.int32))
            and torch.equal(run.rounds.cpu(), host.rounds)):
        raise SystemExit("fair share: the card's runtime differs from the "
                         "host's")
    quotas = run.snapshot.quotas
    depth = quota_depth(quotas).cpu()
    over = ((quotas.used > quotas.runtime + EPS).any(dim=1)
            & quotas.valid).cpu()
    line["over_runtime_by_level"] = [int(over[depth == d].sum())
                                     for d in range(FAIR_SHARE_LEVELS)]
    t0 = time.perf_counter()
    host_line, host = run_config_4_fair_share(FAIR_SHARE_COMPARED_PODS,
                                              device="cpu")
    line.update(host_s=time.perf_counter() - t0,
                compared_pods=FAIR_SHARE_COMPARED_PODS,
                host_placed=host_line["placed"])
    _, card = run_config_4_fair_share(FAIR_SHARE_COMPARED_PODS,
                                      device="cuda")
    differ = (diff_fields(card.snapshot, host.snapshot)
              + diff_fields(card.assignment, host.assignment, "assignment"))
    line["differing_fields"] = differ
    print("fair share: " + json.dumps(line), flush=True)
    if differ:
        raise SystemExit(f"fair share: the card differs from the host in "
                         f"{differ}")
    if any(line["over_runtime_by_level"]) or not overcommit_ok(run.snapshot):
        raise SystemExit("fair share: quota used over runtime or overcommit")
    if not (all(line["below_demand_cpu"]) and line["turned_away"] > 0
            and 0 < line["placed"] < line["num_pods"]):
        raise SystemExit(f"fair share: the tree does not bind: {line}")
    return line, launches


def gauge_values(samples):
    return [(name, labels, np.float64(v).view(np.uint64)
             if v == v else "nan") for name, labels, v in samples]


def node_resource_phase():
    """node_resource_10k (`run_node_resource`: two reconciles of the
    NodeResourceController over 10 000 nodes, the second after a usage
    drift) on the card, counting launches (K19 once a reconcile, nothing
    else), then on the host: batch, mid (NaN where the host has NaN,
    other entries bit for bit), degraded, sync_mask and the gauges equal
    in both reconciles; the diff gate syncs and holds rows in the
    second. Returns (line, launches)."""
    cluster = node_resource_cluster(10_000)
    kernels.reset_launch_counts()
    line, run = run_node_resource(device="cuda", cluster=cluster)
    launches = kernels.launch_counts()
    want = {k: 2 if k == "node_overcommit" else 0 for k in launches}
    if launches != want:
        raise SystemExit(f"node resource: launches {launches}, not {want}")
    t0 = time.perf_counter()
    host_line, host = run_node_resource(device="cpu", cluster=cluster)
    line.update(launches=launches, host_s=time.perf_counter() - t0,
                host_values=[r["value"] for r in host_line["reconciles"]])
    print("node resource: " + json.dumps(line), flush=True)
    for k, (g, w) in enumerate(zip(run.outputs, host.outputs)):
        for f in ("batch", "mid"):
            if not same_floats(torch.from_numpy(g[f]),
                               torch.from_numpy(w[f])):
                raise SystemExit(f"node resource: reconcile {k} {f} differs")
        for f in ("degraded", "sync_mask"):
            if not np.array_equal(g[f], w[f]):
                raise SystemExit(f"node resource: reconcile {k} {f} differs")
        if gauge_values(run.gauges[k]) != gauge_values(host.gauges[k]):
            raise SystemExit(f"node resource: reconcile {k} gauges differ")
    second = line["reconciles"][1]
    if not 0 < second["synced"] < line["nodes"] - second["degraded"]:
        raise SystemExit(f"node resource: the diff gate did not both sync "
                         f"and hold rows: {second}")
    return line, launches


K3_FORMULA = "steps + rounds + batches + charged"


def k3_formula(steps, rounds, batches, charged=0):
    """K3's launches as the code issues them (K3_FORMULA): one grouped
    launch an inner step (every commit of the step), one a round (the
    estimates and gang counts; the first round also the batch's gang
    attempts), one a batch (the rebuild, the reservation slots' included)
    and one for each `charge_all_counts` (the count tables between
    batches) or forget."""
    return steps + rounds + batches + charged


def expected_launches(line):
    """(inner steps, K3 launches) of one flagship run: K2 launches once
    an inner step; K3 once an inner step (node and all quota levels in
    one grouped launch), once a round (two estimates and the gang count;
    the first round also the gangs attempted) and once a batch (the
    rebuild's requested, two estimates, quotas and gangs assumed):
    `k3_formula`."""
    batches = line["num_pods"] // line["chunk"]
    rounds = (batches * STEP_KW["num_rounds"]
              + line["tail_passes"] * TAIL_KW["num_rounds"])
    steps = (batches * STEP_KW["num_rounds"] * STEP_KW["k_choices"]
             + line["tail_passes"] * TAIL_KW["num_rounds"]
             * TAIL_KW["k_choices"])
    return steps, k3_formula(steps, rounds, batches + line["tail_passes"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    smi = card_name_and_power_limit()
    print(smi, flush=True)
    phase_s = {}
    tc = build_all()
    phase_s["1. build"] = tc.build_s
    print(f"build: {tc.build_s:.1f} s for {len(tc.libs)} kernels", flush=True)
    for name, log in tc.ptxas.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    # --- 2. kernels against their plain versions -------------------------
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    snap, pods = loaded_state(dev, gen)
    cfg = loadaware.LoadAwareConfig.make(device=dev)
    k1 = check_k1(snap, pods, cfg, gen)
    print("kernel score_topk edges, equal to the plain version: "
          + json.dumps(check_k1_edges(snap, pods, cfg, gen)), flush=True)
    k2 = check_k2(snap, pods, gen)
    switch = check_order_switch(snap, pods, gen)
    k3 = check_k3(snap, pods, gen)
    k4 = check_k4(dev, gen)
    k5 = check_k5(dev, gen)
    k1_numa = check_k1_numa(dev, gen)
    k2_zones = check_k2_zones(dev, gen)
    k6 = check_k6(dev, gen)
    k5_gpu = check_k5_gpu(dev, gen)
    k7 = check_k7(dev, gen)
    k1_gpu = check_k1_gpu(dev, gen)
    k1_slots = check_k1_slots(dev, gen)
    k2_once = check_k2_once(dev, gen)
    k1_topo = check_k1_topo(dev, gen)
    k8 = check_k8(dev, gen)
    k2_mask = check_k2_mask(snap, pods, gen)
    k9 = check_k9(dev, gen)
    rows = check_prefix_rows(dev, gen)
    lnl = check_lnl(dev, gen)
    lnl_edges = check_lnl_cases(dev)
    guard_checks = check_guards(dev, gen)
    k16 = check_k16(dev, gen)
    k2_big = check_k2_big(snap, pods, gen)
    k2_frac = check_k2_fractional(dev)
    k5_big = check_k5_big(dev, gen)
    k7_big = check_k7_big(dev, gen)
    k8_big = check_k8_big(dev, gen)
    k1_amp = check_k1_amp(snap, pods, cfg, gen)
    lnl_every = check_lnl(dev, gen, every_node=True)
    k17 = check_k17(dev, gen)
    k6_aux = check_k6_aux(dev, gen)
    k2_aux = check_k2_aux(dev, gen)
    c8 = check_c8(dev, gen)
    k18 = check_k18(dev)
    fold = check_fold(dev)
    k19 = check_k19(dev)
    for name, res in (("score_topk", k1), ("segment_prefix_ok", k2),
                      ("order_switch", switch),
                      ("ordered_scatter_add", k3), ("numa_pair_terms", k4),
                      ("topology_admit", k5), ("score_topk", k1_numa),
                      ("segment_prefix_ok", k2_zones),
                      ("device_pair_terms", k6), ("topology_admit", k5_gpu),
                      ("gpu_instance_pick", k7), ("score_topk", k1_gpu),
                      ("score_topk", k1_slots),
                      ("segment_prefix_ok", k2_once),
                      ("score_topk", k1_topo),
                      ("topology_prefix_gate", k8),
                      ("segment_prefix_ok", k2_mask),
                      ("stage1_mask", k9), ("prefix rows", rows),
                      ("lownodeload", lnl),
                      ("lnl_eviction_order cases", lnl_edges),
                      ("guard", guard_checks),
                      ("delta_rows", k16), ("segment_prefix_ok", k2_big),
                      ("segment_prefix_ok fractional", k2_frac),
                      ("topology_admit", k5_big),
                      ("gpu_instance_pick", k7_big),
                      ("topology_prefix_gate", k8_big),
                      ("score_topk amplified", k1_amp),
                      ("lownodeload every node", lnl_every),
                      ("aux_instance_pick", k17),
                      ("device_pair_terms aux", k6_aux),
                      ("segment_prefix_ok aux", k2_aux),
                      ("quota_runtime", k18),
                      ("ordered_scatter_add fold", fold),
                      ("node_overcommit", k19)):
        for label, r in res.items():
            print(f"kernel {name} [{label}]: " + json.dumps(r), flush=True)
    for label, r in c8.items():
        print(f"fault C8 [{label}], equal: " + json.dumps(r), flush=True)

    print("K2 deciding its own order switch, equal to the plain version: "
          + json.dumps({"launches_held": len(K2_FOLDED),
                        "exact": sum(K2_FOLDED),
                        "pinned": len(K2_FOLDED) - sum(K2_FOLDED)}),
          flush=True)
    phase_s["2. kernels"] = time.perf_counter() - t_phase
    print(f"phase 2. kernels: {phase_s['2. kernels']:.1f} s", flush=True)

    # --- 3. slice equality: the card against the host --------------------
    t_phase = time.perf_counter()
    runs = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        run = sweep_and_tail(
            synthetic_cluster(1000, seed=3, num_quotas=32, device=d),
            synthetic_pods(8000, seed=1, num_quotas=32, device=d),
            loadaware.LoadAwareConfig.make(device=d), chunk=1000)
        runs[d] = (run.assignment.cpu(), run.stats,
                   run.snapshot.nodes.requested.cpu(),
                   time.perf_counter() - t0)
    same = all(torch.equal(a, b) for a, b in zip(runs["cuda"][:3],
                                                runs["cpu"][:3]))
    print("slice equality 8000x1000: " + json.dumps({
        "equal": same, "placed": int((runs["cuda"][0] >= 0).sum()),
        "stats": [int(x) for x in runs["cuda"][1]],
        "cuda_s": runs["cuda"][3], "cpu_s": runs["cpu"][3]}), flush=True)
    if not same:
        raise SystemExit("the card's assignment differs from the host's")

    phase_s["3. slice equality"] = time.perf_counter() - t_phase
    print(f"phase 3. slice equality: {phase_s['3. slice equality']:.1f} s",
          flush=True)

    # --- 4. the flagship at 100k x 10k ------------------------------------
    t_phase = time.perf_counter()
    warm, _ = run_northstar(device="cuda", snap_seed=0)
    print("flagship warm-up: " + json.dumps(warm), flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    line, run = run_northstar(device="cuda", snap_seed=7)
    launches = kernels.launch_counts()
    line["launches"] = launches
    line["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    print("flagship: " + json.dumps(line), flush=True)
    if min(launches[k] for k in SLIM_KERNELS) <= 0:
        raise SystemExit(f"a kernel of the path never launched: {launches}")
    if any(launches[k] for k in launches if k not in SLIM_KERNELS):
        raise SystemExit(f"the slim path launched a NUMA or DeviceShare "
                         f"kernel: {launches}")
    steps, k3_launches = expected_launches(line)
    if launches["segment_prefix_ok"] != steps:
        raise SystemExit(f"K2 launched {launches['segment_prefix_ok']} "
                         f"times for {steps} inner steps")
    if launches["ordered_scatter_add"] != k3_launches:
        raise SystemExit(f"K3 launched {launches['ordered_scatter_add']} "
                         f"times, not {k3_launches} ({K3_FORMULA})")
    if line["stragglers_after_sweep"] != STRAGGLERS_AFTER_SWEEP:
        raise SystemExit(f"{line['stragglers_after_sweep']} stragglers after "
                         f"the sweep, not {STRAGGLERS_AFTER_SWEEP}: a "
                         "placement moved")
    if not overcommit_ok(run.snapshot):
        raise SystemExit("overcommit: requested exceeds allocatable")
    if not quota_ok(run.snapshot):
        raise SystemExit("quota used exceeds runtime")
    if line["never_retried"] != 0:
        raise SystemExit(f"{line['never_retried']} stragglers never retried")
    if not 0 < line["placed"] <= 100_000:
        raise SystemExit(f"placed {line['placed']} pods")

    phase_s["4. flagship"] = time.perf_counter() - t_phase
    print(f"phase 4. flagship: {phase_s['4. flagship']:.1f} s", flush=True)

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        phase_s[label] = time.perf_counter() - t0
        print(f"phase {label}: {phase_s[label]:.1f} s", flush=True)
        return out

    # --- 5. BASELINE config 2, the NUMA path, at 10k x 1k ------------------
    _, launches_cfg2 = timed("5. config 2", config_2_phase)

    # --- 6. gpu_share_100kx10k, the DeviceShare path ----------------------
    _, launches_gpu, _ = timed("6. gpu_share", gpu_share_phase)

    # --- 7. the full gate: the cascade and the packing prefixes ------------
    _, launches_full, _ = timed("7. full gate", full_gate_phase)

    # --- 8. BASELINE config 5: the descheduler's LowNodeLoad plan ---------
    _, launches_cfg5 = timed("8. config 5", descheduler_phase)

    # --- 9. the guarded cycle: guards, deltas, forget, the store ----------
    _, launches_guarded = timed("9. guarded cycle", guarded_phase)

    # --- 10. BASELINE config 4: chunks of 2500, K2's tiled walk -----------
    _, launches_cfg4 = timed("10. config 4", config_4_phase)

    # --- 11. config 5 with pods on every node: K11 and K12 above 16 384 ----
    _, launches_cfg5_every = timed(
        "11. config 5 every node", lambda: descheduler_phase(every_node=True))

    # --- 12. the amplified full gate ---------------------------------------
    _, launches_amp = timed("12. amplified full gate", amplified_phase)

    # --- 13. the aux full gate: RDMA/FPGA pools (K17) ----------------------
    _, launches_aux = timed("13. aux full gate", aux_phase)

    # --- 14-15. BASELINE configs 1 and 3 ----------------------------------
    timed("14. config 1", lambda: small_config_phase(
        "config 1", run_config_1_spark, {}))
    line3, _ = timed("15. config 3", lambda: small_config_phase(
        "config 3", run_config_3_gangs, {}))
    if not (line3["gangs_placed"] > 0 and line3["gangs_partial"] == 0
            and line3["placed"] == CONFIG_3_GANG_SIZE * line3["gangs_placed"]):
        raise SystemExit(f"config 3: a strict gang placed in part: {line3}")

    # --- 16. the ElasticQuota fair share: the fold (K3) and K18 ----------
    _, launches_fair = timed("16. config 4 fair share", fair_share_phase)

    # --- 17. koord-manager's batch and mid overcommit (K19) ---------------
    _, launches_nr = timed("17. node resource", node_resource_phase)
    print("phase seconds: " + json.dumps(phase_s), flush=True)

    # each kernel's numbers at the shapes of the path it came with (K1-K3
    # the flagship, K4-K5 config 2, K6-K7 gpu_share), and K1, K2, K5 at
    # gpu_share's too
    timings = {"score_topk": k1["sweep"], "segment_prefix_ok": k2["chain"],
               "order_switch": switch["chain requests"],
               "ordered_scatter_add": k3["node commit"],
               "numa_pair_terms": k4["cfg2 most"],
               "topology_admit": k5["cfg2 most"],
               "device_pair_terms": k6["gpu_share least"],
               "gpu_instance_pick": k7["gpu_share least"],
               "topology_prefix_gate": k8["gpu_share"],
               "stage1_mask": k9["full gate"]}
    at_gpu_share = {"score_topk": k1_topo["gpu_share"],
                    "segment_prefix_ok": k7["gpu_share least"]["gpu_gate"],
                    "topology_admit": k5_gpu["gpu_share most"],
                    "gpu_instance_pick": k7["gpu_share + slot rows"]}
    report = []
    for name, r in timings.items():
        source, replaces = SOURCES[name]
        path = (launches if name in SLIM_KERNELS else launches_cfg2
                if name in NUMA_KERNELS else launches_full
                if name == "stage1_mask" else launches_gpu)
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path[name],
            "launches_by_path": {"flagship": launches[name],
                                 "config_2": launches_cfg2[name],
                                 "gpu_share": launches_gpu[name],
                                 "full_gate": launches_full[name],
                                 "config_4": launches_cfg4[name],
                                 "full_gate_amplified": launches_amp[name],
                                 "full_gate_aux": launches_aux[name]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        tiled = {"segment_prefix_ok": k2_big, "topology_admit": k5_big,
                 "gpu_instance_pick": k7_big,
                 "topology_prefix_gate": k8_big}
        if name in tiled:
            entry["above_2048_pods"] = {
                label: {k: v for k, v in res.items() if k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape")}
                for label, res in tiled[name].items() if "ms" in res}
        if name == "segment_prefix_ok":
            entry["fractional_requests"] = k2_frac
            entry["at_aux_levels"] = k2_aux["aux levels"]
        if name == "device_pair_terms":
            entry["at_aux_full_gate"] = {
                label: k6_aux[label] for label in (
                    "aux full gate least", "without the aux part")}
        if name == "score_topk":
            entry["at_amplified"] = {
                label: {k: k1_amp[label][k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_ms_all_pairs", "library_ms", "shape",
                    "removed_pairs")}
                for label in ("sweep", "ratio 1", "no term")}
        if name == "segment_prefix_ok":
            entry["at_allocate_once"] = {
                k: k2_once["gpu_share"][k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "shape")}
            entry["with_topology_mask"] = {
                k: k2_mask["chain + mask"][k] for k in (
                    "ms", "device_ms", "plain_ms", "shape")}
        if name == "ordered_scatter_add":
            entry["at_fold"] = fold["fair share fold"]
            entry["launches_by_path"]["config_4_fair_share"] = \
                launches_fair[name]
            for label in ("count commit", "quota commit", "hot row P=50000",
                          "full gate step"):
                entry["at_" + label.replace(" ", "_").replace("=", "")] = {
                    k: k3[label][k] for k in (
                        "ms", "device_ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "shape", "hottest_row")}
            entry["launch_formula"] = K3_FORMULA
        if name == "topology_prefix_gate":
            entry["at_tail"] = k8["gpu_share tail"]
            entry["at_full_gate"] = k8["full gate topo_prefix"]
        if name == "gpu_instance_pick":
            entry["device_activities_a_call"] = \
                k7["gpu_share least"]["activities"]
        if name in ("numa_pair_terms", "device_pair_terms"):
            entry["at_prefix_rows"] = rows[name]
        wide = {"numa_pair_terms": k4.get("Z=8 most"),
                "topology_admit": k5.get("Z=8 most"),
                "device_pair_terms": k6.get("I=56 least")}.get(name)
        if wide is not None:
            entry["at_c8_width"] = wide
        if name == "score_topk":
            entry["at_prefix_rows"] = next(
                v for k, v in rows.items() if k.startswith("addend rows")
                and "device_ms" in v)
        if name in at_gpu_share:
            g = at_gpu_share[name]
            entry["at_gpu_share"] = {
                k: g[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "shape")
                if k in g}
        report.append(entry)
    # K10-K13 at config 5's shape; launches from phase 8's plain run (K13
    # from the capped run), two plans each
    by_path = {"config_5": launches_cfg5["baseline_cfg5_descheduler_10k"],
               "config_5_capped": launches_cfg5[
                   "baseline_cfg5_descheduler_10k_capped"],
               "config_5_every_node": launches_cfg5_every[
                   "baseline_cfg5_descheduler_10k_every_node"],
               "config_5_capped_every_node": launches_cfg5_every[
                   "baseline_cfg5_descheduler_10k_capped_every_node"]}
    for name in LNL_KERNELS:
        source, replaces = SOURCES[name]
        r = lnl["config 5"]["timing"][name]
        path = by_path["config_5_capped" if name == "lnl_plan_capped"
                       else "config_5"]
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path[name],
            "launches_by_path": {k: v[name] for k, v in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "at_every_node": lnl_every["every node"]["timing"][name]})
        if name == "lnl_eviction_order":
            report[-1]["edge_cases"] = sorted(lnl_edges)
    # K14-K16 at the guarded cycle's shapes; launches from phase 9 (two
    # runs of ten batches, two deltas applied a run)
    for name, r in (("guard_nodes", guard_checks["guard_nodes full gate"]),
                    ("guard_pods", guard_checks["guard_pods full gate"]),
                    ("delta_rows", k16["metric 1000"])):
        source, replaces = SOURCES[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_guarded[name],
            "launches_by_path": {"guarded_cycle": launches_guarded[name]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]}
        if name == "delta_rows":
            entry["at_topology_delta"] = k16["topology 64"]
        if name == "guard_nodes":
            entry["at_c8_width"] = guard_checks["guard_nodes Z=8"]
        report.append(entry)
    # K17 at the aux full gate's first chunk; launches from phase 13
    source, replaces = SOURCES["aux_instance_pick"]
    r = k17["aux full gate least"]
    report.append({
        "name": "aux_instance_pick", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches_aux["aux_instance_pick"],
        "launches_by_path": {"full_gate_aux":
                             launches_aux["aux_instance_pick"]},
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "shape": r["shape"],
        "most": {k: k17["aux full gate most"][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms")},
        "at_c8_width": k17[f"aux full gate J={C8_VFS} least"]})
    # K18 on the fair-share tree, launches from phase 16; K19 at 10 000
    # nodes, launches from phase 17 (two reconciles)
    for name, r, path, launched in (
            ("quota_runtime", k18["fair share"], "config_4_fair_share",
             launches_fair),
            ("node_overcommit", k19["10k nodes"], "node_resource_10k",
             launches_nr)):
        source, replaces = SOURCES[name]
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched[name],
            "launches_by_path": {path: launched[name]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
