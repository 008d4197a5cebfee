"""The batched scheduling core: feasibility, score and the
conflict-resolving commit of one pod batch, then the straggler tail.

Counterpart of `koordinator_tpu/scheduler/core.py` schedule_batch,
tail_select, tail_pass and tail_compaction_loop for the slim flagship,
the NodeNUMAResource path (`enable_numa`, with the topology manager),
DeviceShare's GPU instances (`enable_devices` on a snapshot with them),
taints and tolerations (`pods.has_taints`: the forbid gate and the
PreferNoSchedule score penalty), live reservation slots (V > 0) and
pod topology spread, inter-pod anti-affinity and affinity
(`pods.has_spread` / `has_anti` / `has_aff`), the Filter->Score gate
cascade (`cascade=True`) and the packing-prefix contracts
(`topo_prefix`, `numa_prefix`, `gpu_prefix`, `dom_classes`), amplified
CPU (`enable_amplification`), the aux (RDMA/FPGA) instance pools and
`approx_topk` (run as the exact top-k): every option of the
reference's schedule_batch. Any batch size: the in-step kernels walk
batches above 2048 pods a tile at a time.

Per round (num_rounds of them), kernel K1 (`score_topk`) picks each
active pod's k best feasible columns: the N nodes and the V reservation
slots (columns N..N+V-1, owner-restricted virtual nodes whose capacity
is the slot's free, scored above any node). It takes the batch's
static gates in factored form (`cascade.static_gate_terms`, with the
taint forbid and penalty tables) and the slots' gates as bool[P, V]
(`reservation.slot_columns`), so no [P, N] gate mask is built. Then k
inner steps run: each pod tries its next choice, kernel K2
(`segment_prefix_chain`, one launch) admits it if it fits the node or
slot, and then each quota level, after every earlier-ranked pod that
chose the same column or quota, and kernel K3 (`ordered_scatter_add`)
commits the accepted requests, one launch for the nodes and slots and
one for all quota levels; a rejected pod falls through to its next
choice. With `enable_numa`, kernel K4 (`numa_pair_terms`) gives each
(pod, node) pair its batch-start NUMA gates and zone score, which K1
takes as a pair mask and a score addend; in each inner step, after the
node and quota gates, kernel K5 (`topology_admit`) runs the topology
manager for every trying pod on its chosen row, a second K2 launch
gates the zone takes zone by zone, and K3 commits them. With GPU
instances, kernel K6 (`device_pair_terms`) gives each pair its
batch-start instance gate, ANDed into the pair mask, and its pool
score, K1's second addend (the first without NUMA); in each inner step
K5 also runs DeviceShare's hint provider, kernel K7
(`gpu_instance_pick`) picks each shared pod's instance, a third K2
launch gates the shared pods per (row, instance) and admits one
multi-GPU pod a row, K7 again gives the multi-GPU pods whole
instances, and one K3 launch commits every pod's instance takes. With
aux pools, K6 also ANDs in the prefilter's aux part, and in each inner
step kernel K17 (`aux_instance_pick`) picks each aux pod's RDMA and FPGA
instance on its chosen node, one K2 launch gates both pools' (node,
pool, instance) segments (pool 1 after pool 0's gate) and one K3
launch commits them. The
zone and instance pools carry one extended row a slot (its zone and
instance holds), so a consumer takes the reserved zone and minors
through the same gates. With slots, one more K2 launch a step admits
the first consumer of each AllocateOnce slot, which then closes. With
the cascade on, kernel K9 (`stage1_mask`) writes the batch-start
candidate mask (the static gates, the fit and the quota ceilings) as
the pair mask, and K4 and K6 run on the numa and gpu prefixes' rows
only (stage 2), ANDing them into it. The prefixes slice the in-step
gates whether the cascade is on or not: the topology families run on
the first topo_prefix pods, the topology manager and zone gates on the
first numa_prefix, the GPU instance gates on the first gpu_prefix, each
K2 launch of such a block with the ranks of its pods re-ranked among
themselves. With
pod topology groups, each round builds the (group x column) maps from
the carried counts (`domains.round_terms`), which K1 takes as bit words
with the spread penalty; in each step kernel K8 (`topology_prefix_gate`)
runs the same-domain prefix gates of the three families on the trying
pods, K2 ANDs its verdict in after the node level, and once accept is
final one K3 launch a count table charges the accepted members and
carriers into the carried counts. After
the rounds, strict gangs below quorum roll back, and the snapshot is
rebuilt from the final assignment: a slot's consumer charges its quota
and its estimate (on the slot's host node), not the node's requested or
pools, and is drawn from the slot (`reservation.rebuild_reservations`).
With `enable_amplification` a CPU-bind pod's CPU costs its request
times its node's ratio: K1 fits it so, K2's node level and the node
commits charge it so (level 0 takes its own request rows), the quota
levels stay raw; slot columns keep a ratio of 1.
The reference runs the rounds and steps as lax.scan loops inside one
jitted program; here they are Python loops over launches, with no host
readback inside a batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from koordinator_tpu_torch.api.extension import (
    NUM_AUX_TYPES,
    PriorityClass,
    ResourceKind,
)
from koordinator_tpu_torch.kernels.aux_instances import aux_instance_pick
from koordinator_tpu_torch.kernels.device_terms import device_pair_terms
from koordinator_tpu_torch.kernels.gpu_instances import gpu_instance_pick
from koordinator_tpu_torch.kernels.numa_terms import numa_pair_terms
from koordinator_tpu_torch.kernels.scatter import (
    ordered_scatter_add,
    ordered_scatter_add_named,
)
from koordinator_tpu_torch.kernels.score_topk import AmpTerms, score_topk
from koordinator_tpu_torch.kernels.topology import topology_admit
from koordinator_tpu_torch.kernels.topology_prefix import topology_prefix_gate
from koordinator_tpu_torch.kernels._xla import xla_max
from koordinator_tpu_torch.scheduler.batching import (
    EPS,
    MAX_NODE_SCORE,
    exact_in_any_order,
    rank_by_priority,
    segment_prefix_chain,
    stable_rank,
)
from koordinator_tpu_torch.ops.feasibility import (
    pod_ancestors,
    quota_ceiling_terms,
)
from koordinator_tpu_torch.scheduler.cascade import (
    stage1_mask,
    static_gate_terms,
)
from koordinator_tpu_torch.scheduler.domains import (
    COUNT_FIELDS,
    batch_counts,
    batch_topology,
    charge_all_counts,
    commit_count_groups,
    round_terms,
    step_families,
)
from koordinator_tpu_torch.scheduler.plugins import (
    deviceshare,
    loadaware,
    numaaware,
)
from koordinator_tpu_torch.scheduler.plugins.reservation import (
    reservation_groups,
    slot_columns,
)
from koordinator_tpu_torch.snapshot.schema import (
    MAX_QUOTA_DEPTH,
    PER_POD_FIELDS,
    ClusterSnapshot,
    PodBatch,
    Struct,
)

PROD = int(PriorityClass.PROD)
CPU = int(ResourceKind.CPU)


@dataclasses.dataclass
class ScheduleResult(Struct):
    assignment: torch.Tensor     # i32[P] node index, -1 = unschedulable
    chosen_score: torch.Tensor   # f32[P] score of the chosen node, -1
    numa_zone: torch.Tensor      # i32[P] zone taken by NUMA-bound pods, -1
    numa_take: torch.Tensor      # f32[P, Z, 2] per-zone (cpu, mem) charged
                                 # by topology-engaged pods, zero elsewhere
    gpu_take: torch.Tensor       # bool[P, I], False
    aux_inst: torch.Tensor       # i32[P, 2] aux instance a pool, -1
    res_slot: torch.Tensor       # i32[P] reservation slot consumed, -1
    gang_failed: torch.Tensor    # bool[G] strict gangs proven below quorum
    snapshot: ClusterSnapshot    # post-commit snapshot
    amplified: bool = False


def _check_strategies(*, enable_numa, numa_strategy, enable_devices,
                      device_strategy) -> None:
    if enable_numa and numa_strategy not in ("most", "least"):
        raise ValueError(f"numa_strategy {numa_strategy!r}")
    if enable_devices and device_strategy not in deviceshare.STRATEGIES:
        raise ValueError(f"device_strategy {device_strategy!r}")


def _count(n: int, idx: torch.Tensor) -> tuple:
    """The K3 group whose output (f32[n, 1]) counts the entries of idx
    that fall on each of n rows (rows outside [0, n) dropped)."""
    ones = torch.ones((idx.shape[0], 1), dtype=torch.float32,
                      device=idx.device)
    zeros = torch.zeros((n, 1), dtype=torch.float32, device=idx.device)
    return zeros, idx, ones


def _where_i32(cond: torch.Tensor, a, b) -> torch.Tensor:
    return torch.where(cond, a, b).to(torch.int32)


def _prefix(value: Optional[int], p: int) -> int:
    """A packing prefix's row count in a batch of p pods: p where None,
    else clamped into [0, p] (core.py:246-248)."""
    return p if value is None else max(min(int(value), p), 0)


def _norm_classes(cls, n_g: int) -> None:
    """Check one family's domain classes (core.py:495-507): None, or a
    partition of range(n_g) into non-empty classes; else ValueError.
    The reference batches a class's per-group matvecs into one matmul,
    bit-identical to the per-group form the port runs, so a valid
    partition changes nothing here."""
    if cls is None:
        return
    got = sorted(g for c in cls for g in c)
    if got != list(range(n_g)) or not all(len(c) for c in cls):
        raise ValueError(f"dom_classes must partition range({n_g}) "
                         f"into non-empty classes; got {cls}")


def _fit_rows(x: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """x's leading axis cut or padded with `fill` to `rows` (core.py:
    484-493: the NUMA block reads the GPU rows of the gpu width, the GPU
    block the zone rows of the numa width)."""
    if x.shape[0] >= rows:
        return x[:rows]
    pad = torch.full((rows - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def _with_head(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x with its first rows replaced by `head` (the verdict of a gate
    run on a prefix; the rows beyond pass through)."""
    if head.shape[0] == x.shape[0]:
        return head
    return torch.cat([head, x[head.shape[0]:]])


def schedule_batch(snap: ClusterSnapshot, pods: PodBatch,
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
                   cascade: bool = False,
                   aux_stats: Optional[dict] = None) -> ScheduleResult:
    """Schedule a pod batch against the snapshot. Pure: the caller
    publishes `result.snapshot`.

    The arguments are the reference's subset for the ported paths, with
    its defaults, so a slim caller passes enable_numa=False. `fit_dims`
    are the resource dims the capacity and quota gates check (None =
    all); `score_dims` the dims LoadAware scores; `numa_strategy`
    ("most" or "least") the NUMA allocation strategy of the zone score,
    the hint order and the zone take; `device_strategy` ("least" or
    "most") DeviceShare's, of the pool score and the shared pods'
    instance choice.

    The packing contracts, as the reference states them (core.py:
    171-228; `utils.synthetic.pack_gate_prefixes` establishes all
    three): with `topo_prefix` every pod with a spread, anti-affinity or
    affinity membership sits in rows [0, topo_prefix), and the topology
    families gate, score and count those rows only; with `numa_prefix`
    every CPU-bind pod sits below it and no node has a topology-manager
    policy, and the topology manager and zone gates run on those rows;
    with `gpu_prefix` every device-requesting pod sits below it, and the
    GPU instance gates run on those rows (with aux pools, the batch-start
    aux prefilter too: `has_device_request` counts aux pods). A prefix
    above the batch is the batch. `dom_classes` (spread, anti, affinity
    classes of groups with equal domain rows) is checked (ValueError
    unless each partitions its family) and changes nothing else.
    `cascade` folds the stage-1 mask in (K9) and, where a numa or gpu
    prefix is below the batch, runs the batch-start NUMA and device
    gates and scores on its rows only; the placements equal those with
    the cascade off.

    `aux_stats` (a dict, or None) counts, on the device, the pods the
    aux instance gates turn away in the inner steps: `no_instance` (the
    chosen node has no fitting instance of a pool the pod asks for) and
    `gate_rejected` (K2's aux levels reject it: this step's earlier pods
    took the instance's room); each adds to what the dict holds.

    `approx_topk` runs K1's exact select: the reference's approx_max_k
    (core.py:734-738) is a TPU partial reduction that XLA lowers to the
    exact top-k on the CPU, where the port is held to it, and on the
    card an exact select costs what K1 costs, so the flag changes
    nothing here."""
    _check_strategies(enable_numa=enable_numa, numa_strategy=numa_strategy,
                      enable_devices=enable_devices,
                      device_strategy=device_strategy)
    nodes0, quotas0, gangs0 = snap.nodes, snap.quotas, snap.gangs
    dev = nodes0.allocatable.device
    n_nodes = nodes0.num_nodes
    n_quotas = quotas0.min.shape[0]
    n_gangs = gangs0.min_member.shape[0]
    p = pods.num_pods
    fd = list(fit_dims) if fit_dims is not None else None
    sd = list(score_dims) if score_dims is not None else None

    def dims(x):
        """Restrict a [..., R] operand to the checked resource dims."""
        return (x if fd is None else x[..., fd]).contiguous()

    rank = rank_by_priority(pods)
    # the packing prefixes' row counts; a gate run on a prefix ranks its
    # pods among themselves (the reference's earlier[:w, :w])
    pc, pn, pg = (_prefix(w, p) for w in (topo_prefix, numa_prefix,
                                          gpu_prefix))
    ranks = {p: rank}

    def rank_of(rows):
        if rows not in ranks:
            ranks[rows] = stable_rank(rank[:rows])
        return ranks[rows]

    s_cls, a_cls, f_cls = (dom_classes if dom_classes is not None
                           else (None, None, None))
    for on, cls, count0 in ((pods.has_spread, s_cls, pods.spread_count0),
                            (pods.has_anti, a_cls, pods.anti_count0),
                            (pods.has_aff, f_cls, pods.aff_count0)):
        if on:
            _norm_classes(cls, count0.shape[0])

    # gang quorum (coscheduling PreFilter, core.go:220-274); a gang id
    # beyond the table reads its last row, as the reference's gather
    # clamps (a quarantined pod keeps its out-of-range id)
    gid = pods.gang_id.clamp(0, max(n_gangs - 1, 0)).long()
    gang_quorum = ((gangs0.member_count >= gangs0.min_member)
                   | gangs0.satisfied) & gangs0.valid
    gang_ok = (pods.gang_id < 0) | gang_quorum[gid]

    pod_anc = pod_ancestors(quotas0, pods)                      # [P, D]
    # the quota segment of each checked level, n_quotas = none: [D', P]
    quota_seg = torch.where(pod_anc >= 0, pod_anc, n_quotas)[
        :, :quota_depth].T.to(torch.int32).contiguous()

    # the static gates (selector, LoadAware filter, schedulable, taint
    # forbids and penalty, the device prefilter of a snapshot without
    # instances) in factored form: K1 combines them pair by pair
    devices0 = snap.devices
    n_inst = devices0.gpu_free.shape[1]
    n_aux = devices0.aux_free.shape[2]
    use_gpu = enable_devices and n_inst > 0
    use_aux = enable_devices and n_aux > 0
    gates = static_gate_terms(nodes0, pods, cfg,
                              devices0 if enable_devices else None)
    # stage 2 of the cascade (core.py:286-367): with a gpu (numa) prefix
    # below the batch the batch-start device (NUMA) gates and scores run
    # on its rows only, and the rows beyond pass them and score 0
    dev_pg = pg if (cascade and pg < p) else p
    numa_pn = pn if (cascade and pn < p) else p
    if enable_devices and dev_pg < p:
        gates = gates.replace(device_ok=torch.cat([
            gates.device_ok[:dev_pg],
            torch.ones((p - dev_pg,), dtype=torch.bool, device=dev)]))

    # reservation slots as virtual node columns N..N+V-1 (owner-
    # restricted, capacity the slot's free, scored above any node): the
    # slot gates read the static gates at the host node, before the
    # device and NUMA prefilters (a consumer draws from the slot's hold)
    resv0 = snap.reservations
    slot_ok, slot_alloc0, slot_node = slot_columns(snap, pods, gates)
    n_slots = slot_node.shape[0]
    n_ext = n_nodes + n_slots
    is_once = resv0.allocate_once
    slot_node_c = slot_node.clamp_min(0).long()

    # pod topology spread and inter-pod (anti-)affinity: the families'
    # slot-extended domain maps and bit words, and the carried (group x
    # domain) counts, from the batch's count0 fields (COUNT_FIELDS order)
    topo = batch_topology(pods, slot_node, n_nodes, pc)
    counts = batch_counts(pods)

    def extend(node_rows, slot_rows):
        """Rows of the extended pool: the nodes', then the slots'."""
        return (torch.cat([node_rows, slot_rows]).contiguous() if n_slots
                else node_rows)

    def to_real(ext_idx):
        """An extended column's real node (a slot's host node)."""
        if not n_slots:
            return ext_idx
        slot = (ext_idx - n_nodes).clamp(0, n_slots - 1).long()
        return _where_i32(ext_idx >= n_nodes, slot_node[slot], ext_idx)

    # stage 1 of the cascade (K9): the static gates, the batch-start fit
    # and the quota ceilings as the pair mask of the node columns (never
    # of the slot columns, which read the gates above)
    pair_ok = pair_score = None
    if cascade:
        pair_ok = stage1_mask(snap, pods, gates, fit_dims, quota_depth)

    # NodeNUMAResource at batch start (K4, on the first numa_pn rows):
    # the single-NUMA prefilter and the policy nodes' combined fit ANDed
    # into the pair mask, the zone score as an addend of the LoadAware
    # score; the zone pools gain a row per slot (its zone hold, policy
    # none, nothing used)
    n_zones = nodes0.numa_cap.shape[1]
    if enable_numa:
        demand = numaaware.zone_demand(pods)
        pair_ok, pair_score = numa_pair_terms(
            demand[:numa_pn], pods.numa_single[:numa_pn], nodes0.numa_cap,
            nodes0.numa_free, nodes0.numa_valid, nodes0.numa_policy,
            numa_strategy, pair_ok)
        numa_cap_x = extend(nodes0.numa_cap, resv0.numa_free)
        numa_valid_x = extend(nodes0.numa_valid, resv0.numa_valid)
        numa_policy_x = extend(nodes0.numa_policy, torch.zeros(
            (n_slots,), dtype=torch.int32, device=dev))
        numa_used = extend(nodes0.numa_cap - nodes0.numa_free,
                           torch.zeros_like(resv0.numa_free))
        numa_cap_flat = numa_cap_x.reshape(n_ext, n_zones * 2)
        out_zone = torch.full((p,), -1, dtype=torch.int32, device=dev)
        out_take = torch.zeros((p, n_zones, 2), dtype=torch.float32,
                               device=dev)

    # DeviceShare at batch start (K6, on the first dev_pg rows): the
    # instance prefilter (GPU and aux parts) ANDed into the pair mask,
    # the GPU pool score a second addend after the zone score (the first
    # without NUMA), as the reference sums them; the instance pool gains
    # a row per slot (its reserved instances, the host node's totals and
    # topology)
    pair_score2 = None
    gpu_req = deviceshare.gpu_request(pods.requests,
                                      pods.gpu_ratio).contiguous()
    if use_aux:
        a_req = deviceshare.aux_request(pods.requests).contiguous()
    if use_gpu or use_aux:
        pair_ok, dev_score = device_pair_terms(
            gpu_req[:dev_pg], devices0, device_strategy, pair_ok,
            a_req[:dev_pg] if use_aux else None)
    if use_gpu:
        if pair_score is None:
            pair_score = dev_score
        else:
            pair_score2 = dev_score
        devices_x = devices0.replace(**{
            f: extend(getattr(devices0, f), getattr(devices0, f)[slot_node_c])
            for f in ("gpu_total", "gpu_numa", "gpu_pcie")}, **{
            f: extend(getattr(devices0, f), getattr(resv0, f))
            for f in ("gpu_free", "gpu_valid")}) if n_slots else devices0
        gpu_free = devices_x.gpu_free
        n_slots_gpu = n_ext * n_inst
        # K2's tables for the shared gate (used 0, capacity the live
        # instance free) and the one-multi-pod-a-row level (capacity 1)
        gate_base = torch.zeros((n_slots_gpu, 3), dtype=torch.float32,
                                device=dev)
        one_pod = torch.zeros((n_ext, 3), dtype=torch.float32, device=dev)
        one_pod[:, 0] = 1.0
        out_gpu_take = torch.zeros((p, n_inst), dtype=torch.bool, device=dev)
        out_per = torch.zeros((p, 3), dtype=torch.float32, device=dev)

    if use_aux:
        # the aux pools (N rows: slot columns never carry an aux pod,
        # reservation.slot_columns) and K2's table of their gates: the
        # (node, pool, instance) segments, used 0, capacity the live free
        n_aux_seg = n_nodes * NUM_AUX_TYPES * n_aux
        aux_free = devices0.aux_free
        aux_base = torch.zeros((n_aux_seg, 1), dtype=torch.float32,
                               device=dev)
        has_aux = a_req > 0
        a_req_lv = a_req.T.contiguous()[:, :, None]            # [2, P, 1]
        exact_aux = exact_in_any_order(a_req)
        out_aux = torch.full((p, NUM_AUX_TYPES), -1, dtype=torch.int32,
                             device=dev)

    if n_slots:
        # K2's table of the AllocateOnce level: one winner a once slot
        once_base = torch.zeros((n_slots, 1), dtype=torch.float32,
                                device=dev)
        once_cap = torch.ones((n_slots, 1), dtype=torch.float32, device=dev)
        once_req = torch.ones((p, 1), dtype=torch.float32, device=dev)
        exact_once = exact_in_any_order(once_req)
        once_taken = torch.zeros((n_slots,), dtype=torch.bool, device=dev)

    # amplified CPU (core.py:383-404): a CPU-bind pod's CPU costs its
    # request times the ratio of its column (1 on slot columns); K1 fits
    # it so only where the fit checks CPU
    amp = amp_ext = None
    if enable_amplification:
        amp_ext = extend(nodes0.cpu_amplification, torch.ones(
            (n_slots,), dtype=torch.float32, device=dev))
        if fd is None or CPU in fd:
            amp = AmpTerms(bind=pods.numa_single,
                           ratio=nodes0.cpu_amplification,
                           col=CPU if fd is None else fd.index(CPU))

    req_fit = dims(pods.requests)
    # K2's order switch (exact_in_any_order) for the requests fixed for
    # the batch, decided once on the device; the step's own arrays (the
    # amplified node level's, the zone takes, the GPU per-instance
    # requests) are decided by each K2 launch itself
    exact_fit = exact_in_any_order(req_fit)
    alloc_fit = dims(extend(nodes0.allocatable, slot_alloc0))
    runtime_fit = dims(quotas0.runtime)
    est_score = (pods.estimated if sd is None
                 else pods.estimated[:, sd]).contiguous()
    is_prod = pods.priority_class == PROD
    is_prod_scored = loadaware.prod_scored(pods, cfg)
    k = min(k_choices, n_ext)

    requested = extend(nodes0.requested, torch.zeros_like(slot_alloc0))
    quota_used = quotas0.used
    assigned_est = nodes0.assigned_estimated
    prod_assigned_est = nodes0.prod_assigned_estimated
    gang_placed = torch.zeros((n_gangs, 1), dtype=torch.float32, device=dev)
    placed = torch.full((p,), -1, dtype=torch.int32, device=dev)
    out_score = torch.full((p,), -1.0, dtype=torch.float32, device=dev)
    drop_node = torch.full((p,), n_ext, dtype=torch.int32, device=dev)

    def quota_commit(used, take, rows):
        """{"quota": the K3 group that charges rows to every quota level
        of the pods in `take`} (one group for all levels), or {}."""
        if not quota_depth:
            return {}
        return {"quota": (used, _where_i32(take[None, :], quota_seg,
                                           n_quotas), rows)}

    # the gang attempts of the batch, known before any step: charged in
    # the first round's call (or alone, with no rounds)
    attempted_group = _count(n_gangs, _where_i32(
        pods.valid & (pods.gang_id >= 0), pods.gang_id, n_gangs))
    attempted = None

    for _ in range(num_rounds):
        active = pods.valid & (placed < 0) & gang_ok

        # quota admission (ElasticQuota PreFilter): used + request <=
        # runtime at every tree level
        quota_admit = quota_ceiling_terms(pod_anc, dims(quota_used),
                                          runtime_fit, req_fit, quota_depth)
        row_ok = (active & quota_admit).contiguous()

        # score inputs frozen for the round (the reference's NodeMetric
        # does not change on assume either)
        nodes = nodes0.replace(assigned_estimated=assigned_est,
                               prod_assigned_estimated=prod_assigned_est)
        node_term, prod_term, alloc_score, weights = loadaware.score_terms(
            nodes, cfg, score_dims)
        # consumed AllocateOnce slots admit nobody (plugin.go:509-510)
        slots = (dict(slot_ok=slot_ok, slot_block=is_once & once_taken)
                 if n_slots else {})
        # the round's topology gates and spread penalty from the counts
        # at its start, and the spread groups' in-step limits
        topo_terms = spread_lim = None
        if topo is not None:
            topo_terms, spread_lim = round_terms(topo, counts, active)
        topk_val, topk_idx = score_topk(
            gates, pair_ok, row_ok, req_fit, dims(requested), alloc_fit,
            est_score, is_prod_scored, node_term, prod_term, alloc_score,
            weights, k, tie_break, EPS, fma_sum=score_dims is not None,
            pair_score=pair_score, pair_score2=pair_score2, topo=topo_terms,
            amp=amp, **slots)

        kptr = torch.zeros((p,), dtype=torch.int64, device=dev)
        for _ in range(k):
            at = kptr.clamp_max(k - 1)[:, None]
            val = topk_val.gather(1, at)[:, 0]
            choice = topk_idx.gather(1, at)[:, 0]
            trying = active & (placed < 0) & (kptr < k) & (val > -0.5)
            if n_slots:
                # a once slot taken in an earlier step admits nobody
                slot_of = (choice - n_nodes).clamp(0, n_slots - 1).long()
                on_slot = choice >= n_nodes
                trying = trying & ~(on_slot & (is_once & once_taken)[slot_of])
            choice_eff = _where_i32(trying, choice, drop_node)

            # the same-domain prefix gates of the topology families (K8,
            # on the first pc pods; the rest pass): charges of every
            # trying pod, not only those the node level admits
            # (core.py:776-884)
            topo_ok = None
            if topo is not None and pc:
                topo_ok = _fit_rows(topology_prefix_gate(
                    choice_eff[:pc], trying[:pc], rank_of(pc),
                    step_families(topo, counts, spread_lim, pc)), p, True)

            # node (and slot) capacity prefix in priority order, then (K2
            # ANDs in the topology verdict) the quota prefix per tree
            # level among the pods both admitted; with amplification the
            # node level charges a CPU-bind pod's amplified CPU
            # (core.py:757-763), the quota levels the raw request
            req_node = pods.requests
            if enable_amplification:
                f_amp = torch.where(pods.numa_single, amp_ext[
                    choice_eff.clamp(0, n_ext - 1).long()], 1.0)
                req_node = pods.requests.clone()
                req_node[:, CPU] = req_node[:, CPU] * f_amp
            quota_table = (dims(quota_used), runtime_fit, n_quotas)
            accept = segment_prefix_chain(
                torch.cat([choice_eff[None], quota_seg]), rank, req_fit,
                trying, [(dims(requested), alloc_fit, n_ext)]
                + [quota_table] * quota_depth, EPS, topo_ok,
                req0=dims(req_node) if enable_amplification else None,
                exact=None if enable_amplification else exact_fit)

            if use_gpu:
                live = devices_x.replace(gpu_free=gpu_free)
            adm = None
            if enable_numa and pn:
                # the topology manager on the chosen row (K5, with
                # DeviceShare's hint provider on the live instance free
                # where there are instances), then the zone capacity
                # prefix, zone by zone, over the engaged pods it admitted
                # (K2: each zone sees the previous zone's gate); pods it
                # rejects still counted in the node prefix above, as in
                # the reference. All on the first pn pods (the rest pass),
                # which read the GPU requests of the first pg, zero beyond
                adm = topology_admit(
                    choice_eff[:pn], trying[:pn], pods.numa_single[:pn],
                    demand[:pn], numa_cap_x, numa_used, numa_valid_x,
                    numa_policy_x, numa_strategy,
                    *((_fit_rows(gpu_req[:pg], pn, 0.0), live) if use_gpu
                      else ()))
                acc = accept[:pn] & adm.admit
                used_flat = numa_used.view(n_ext, n_zones * 2)
                zone_ok = segment_prefix_chain(
                    choice_eff[:pn][None].expand(n_zones, pn).contiguous(),
                    rank_of(pn), adm.take.transpose(0, 1), acc & adm.engaged,
                    [(used_flat[:, 2 * z:2 * z + 2],
                      numa_cap_flat[:, 2 * z:2 * z + 2], n_ext)
                     for z in range(n_zones)], EPS)
                accept = _with_head(accept, (acc & ~adm.engaged) | zone_ok)

            if use_gpu and pg:
                # the GPU instance gates (K7, K2, K7) on the first pg pods
                # (the rest pass): shared pods' instances, their (row,
                # instance) prefix gate and the first multi-GPU pod of
                # each row in one K2 launch, then the multi-GPU pods'
                # whole instances; engaged pods keep to the topology
                # manager's affinity (rows beyond the numa prefix: any
                # zone, not engaged)
                zone = (None, None)
                if enable_numa:
                    aff, eng = ((adm.affinity, adm.engaged) if adm is not None
                                else (torch.ones((0, n_zones), dtype=torch.bool,
                                                 device=dev),
                                      torch.zeros((0,), dtype=torch.bool,
                                                  device=dev)))
                    zone = (_fit_rows(aff, pg, True), _fit_rows(eng, pg, False))
                choice_pg, gpu_pg = choice_eff[:pg], gpu_req[:pg]
                pick = gpu_instance_pick(choice_pg, accept[:pg], gpu_pg, live,
                                         *zone, device_strategy)
                alive = segment_prefix_chain(
                    pick.seg, rank_of(pg), pick.req, pick.gate_active,
                    [(gate_base, gpu_free.view(n_slots_gpu, 3), n_slots_gpu),
                     (gate_base[:n_ext], one_pod, n_ext)], EPS)
                fin = gpu_instance_pick(choice_pg, alive, gpu_pg, live,
                                        *zone, device_strategy, chosen=pick)
                accept = _with_head(accept, fin.accept)

            if use_aux:
                # the aux instance gates (core.py:1020-1039): K17 picks
                # each pod's instance of both pools on its chosen node
                # from the live free; one K2 launch gates pool 0's
                # (node, pool, instance) segments, then, with pool 1's
                # fit ANDed in after it, pool 1's
                a_inst, a_ok = aux_instance_pick(choice_eff, a_req, aux_free,
                                                 devices0, device_strategy)
                aux_seg = deviceshare.aux_segments(choice_eff, a_inst,
                                                   has_aux, n_aux, n_aux_seg)
                fit_a = ~has_aux | a_ok
                before = accept
                accept = segment_prefix_chain(
                    aux_seg.T.contiguous(), rank, a_req_lv,
                    accept & fit_a[:, 0],
                    [(aux_base, aux_free.view(n_aux_seg, 1), n_aux_seg)]
                    * NUM_AUX_TYPES, EPS, fit_a[:, 1].contiguous(),
                    exact=exact_aux)
                if aux_stats is not None:
                    fits = before & fit_a.all(dim=1)
                    for key, n in (("no_instance", (before & ~fits).sum()),
                                   ("gate_rejected", (fits & ~accept).sum())):
                        aux_stats[key] = aux_stats.get(key, 0) + n

            if n_slots:
                # AllocateOnce: among this step's accepted consumers of a
                # once slot only the first in priority order wins
                # (plugin.go:509-510; K2, a request of one against a
                # capacity of one), then the slot closes
                once_here = accept & on_slot & is_once[slot_of]
                won = segment_prefix_chain(
                    _where_i32(once_here, slot_of, n_slots)[None], rank,
                    once_req, once_here, [(once_base, once_cap, n_slots)],
                    EPS, exact=exact_once)
                accept = (accept & ~once_here) | won
                hit = torch.zeros((n_slots + 1,), dtype=torch.bool,
                                  device=dev)
                hit[torch.where(won, slot_of, n_slots)] = True
                once_taken = once_taken | hit[:n_slots]

            # scatter-commit (assume): accept is final from here on; the
            # step's commits go in one grouped K3 call; the zone and
            # instance commits read their prefix rows only
            commits = {}
            if adm is not None:
                took_z = accept[:pn] & adm.engaged
                commits["numa"] = (
                    used_flat, _where_i32(took_z, choice[:pn], n_ext),
                    (adm.take * took_z[:, None, None]).reshape(
                        pn, n_zones * 2))
                out_take = _with_head(out_take, torch.where(
                    took_z[:, None, None], adm.take, out_take[:pn]))
                out_zone = _with_head(out_zone, _where_i32(
                    took_z & pods.numa_single[:pn], adm.zone1, out_zone[:pn]))
            if use_gpu and pg:
                # every pod's instance takes in one ordered scatter over
                # [N + V, I * 3]: no instance gets adds from a shared and
                # a multi-GPU pod in one step (the take launch excludes
                # the shared pods' instances), so this equals the
                # reference's shared scatter followed by its multi-GPU
                # one bit for bit (the other columns add -0.0)
                took_gpu = accept[:pg] & (pick.count > 0)
                commits["gpu"] = (
                    gpu_free.view(n_ext, n_inst * 3),
                    _where_i32(took_gpu, choice[:pg], n_ext),
                    -(fin.take[:, :, None] * pick.per_inst[:, None, :])
                    .reshape(pg, n_inst * 3))
                out_gpu_take = _with_head(
                    out_gpu_take, out_gpu_take[:pg] | (fin.take
                                                       & took_gpu[:, None]))
                out_per = _with_head(out_per, torch.where(
                    took_gpu[:, None], pick.per_inst, out_per[:pg]))

            if use_aux:
                # both pools' takes in one ordered scatter, pool 0's pods
                # first, as the reference's two scatters add them
                took_a = accept[:, None] & has_aux
                commits["aux"] = (
                    aux_free.view(n_aux_seg, 1),
                    _where_i32(took_a, aux_seg, n_aux_seg).T.reshape(-1),
                    -(a_req * took_a).T.reshape(-1, 1))
                out_aux = _where_i32(took_a, a_inst, out_aux)

            count_groups, count_finish = [], None
            if topo is not None and pc:
                # The reference recounts the (group x domain) counts from
                # `placed` at every step and round; here the accepted
                # members and carriers are charged into carried counts
                # as they commit. The two are equal bit for bit: within
                # a batch a placement is never undone before the gang
                # rollback at its end (which the reference's in-batch
                # counts do not see either), so the carried counts hold
                # count0 plus one 1.0 for each placed member, as the
                # recount does, and 0/1 adds onto whole numbers in f32
                # are exact below 2^24 in any order.
                count_groups, count_finish = commit_count_groups(
                    topo, counts, accept[:pc], choice[:pc])
                commits.update((("count", k), g)
                               for k, g in enumerate(count_groups))
            acc_req = pods.requests * accept[:, None]
            commits["requested"] = (requested, choice_eff,
                                    req_node * accept[:, None])
            commits.update(quota_commit(quota_used, accept, acc_req))
            outs = ordered_scatter_add_named(commits)
            if adm is not None:
                numa_used = outs["numa"].view(n_ext, n_zones, 2)
            if use_gpu and pg:
                gpu_free = outs["gpu"].view(n_ext, n_inst, 3)
            if use_aux:
                aux_free = outs["aux"].view(aux_free.shape)
            if count_groups:
                counts = count_finish([outs["count", k]
                                       for k in range(len(count_groups))])
            requested = outs["requested"]
            quota_used = outs.get("quota", quota_used)
            placed = _where_i32(accept, choice, placed)
            out_score = torch.where(accept, val, out_score)
            # a rejected pod's chosen node just filled up: fall through
            kptr = torch.where(trying & ~accept, kptr + 1, kptr)

        # newly placed pods' estimates feed the next round's scores (a
        # slot consumer's on its host node)
        new = (placed >= 0) & active
        tgt = _where_i32(new, to_real(placed), n_nodes)
        est = pods.estimated * new[:, None]
        commits = {"est": (assigned_est, tgt, est),
                   "prod_est": (prod_assigned_est, tgt,
                                est * is_prod[:, None]),
                   "gang": _count(n_gangs, _where_i32(
                       new & (pods.gang_id >= 0), pods.gang_id, n_gangs))}
        if attempted is None:
            commits["attempted"] = attempted_group
        outs = ordered_scatter_add_named(commits)
        assigned_est, prod_assigned_est = outs["est"], outs["prod_est"]
        gang_placed = gang_placed + outs["gang"]
        attempted = outs.get("attempted", attempted)

    # gang all-or-nothing rollback (Permit barrier, core.go:311-341): a
    # strict gang below quorum rolls back once no member is outstanding
    if attempted is None:
        attempted = ordered_scatter_add(*attempted_group)
    attempted = attempted[:, 0].to(torch.int32)
    outstanding = torch.clamp_min(
        gangs0.member_count - gangs0.assumed - attempted, 0)
    gang_total = gangs0.assumed + gang_placed[:, 0].to(torch.int32)
    gang_fail = (gangs0.valid & gangs0.strict & ~gangs0.satisfied
                 & (gang_total < gangs0.min_member) & (outstanding == 0))
    revoke = (placed >= 0) & (pods.gang_id >= 0) & gang_fail[gid]
    placed = _where_i32(revoke, -1, placed)

    # rebuild the post-commit state from the final assignment; a slot's
    # consumer charges neither its node's requested nor the node's zone
    # and instance pools (the hold was charged when the slot was made),
    # but its estimate and its quota
    ok = placed >= 0
    fin_req = pods.requests * ok[:, None]
    fin_est = pods.estimated * ok[:, None]
    if n_slots:
        res_slot = _where_i32(placed >= n_nodes, placed - n_nodes, -1)
        on_slot_fin = res_slot >= 0
        placed_real = _where_i32(ok, to_real(placed.clamp_min(0)), -1)
        tgt = _where_i32(ok, placed_real, n_nodes)
        on_node = _where_i32(ok & ~on_slot_fin, tgt, n_nodes)
        node_req = fin_req * ~on_slot_fin[:, None]
    else:
        res_slot = torch.full((p,), -1, dtype=torch.int32, device=dev)
        placed_real = placed
        tgt = on_node = _where_i32(ok, placed, n_nodes)
        node_req = fin_req
    if enable_amplification:
        # a CPU-bind pod's node charge is amplified (core.py:1208-1216)
        f_fin = torch.where(ok & pods.numa_single, nodes0.cpu_amplification[
            placed_real.clamp(0, n_nodes - 1).long()], 1.0)
        node_req = node_req.clone()
        node_req[:, CPU] = node_req[:, CPU] * f_fin
    # every commit of the rebuild (the reservation slots' too) in one
    # grouped K3 call
    commits = {"requested": (nodes0.requested, tgt, node_req),
               "est": (nodes0.assigned_estimated, tgt, fin_est),
               "prod_est": (nodes0.prod_assigned_estimated, tgt,
                            fin_est * is_prod[:, None]),
               "gang": _count(n_gangs, _where_i32(
                   ok & (pods.gang_id >= 0), pods.gang_id, n_gangs))}
    commits.update(quota_commit(quotas0.used, ok, fin_req))

    # zone usage from the surviving assignment (revoked gang members give
    # their takes back)
    if enable_numa:
        commits["numa"] = (
            nodes0.numa_free.reshape(n_nodes, n_zones * 2), on_node,
            (-out_take * ok[:, None, None]).reshape(p, n_zones * 2))
        numa_zone = _where_i32(ok & pods.numa_single, out_zone, -1)
        numa_take = out_take * ok[:, None, None]
    else:
        numa_zone = torch.full((p,), -1, dtype=torch.int32, device=dev)
        numa_take = torch.zeros((p, n_zones, 2), dtype=torch.float32,
                                device=dev)

    # instance free from the surviving assignment (revoked gang members
    # give their instances back); a take's per-instance request is the
    # one of its pod at its node, carried from the step that took it
    gpu_take = torch.zeros((p, n_inst), dtype=torch.bool, device=dev)
    if use_gpu:
        gpu_take = out_gpu_take & ok[:, None]
        commits["gpu"] = (
            devices0.gpu_free.reshape(n_nodes, n_inst * 3),
            _where_i32(gpu_take.any(dim=1), on_node, n_nodes),
            -(gpu_take[:, :, None] * out_per[:, None, :]).reshape(
                p, n_inst * 3))

    # aux free from the surviving assignment (core.py:1249, :1258-1270),
    # clamped at 0 with XLA's max
    aux_inst = torch.full((p, NUM_AUX_TYPES), -1, dtype=torch.int32,
                          device=dev)
    if use_aux:
        aux_inst = _where_i32(ok[:, None], out_aux, -1)
        took_f = ok[:, None] & has_aux & (aux_inst >= 0)
        seg_f = deviceshare.aux_segments(placed_real.clamp_min(0), aux_inst,
                                         took_f, n_aux, n_aux_seg)
        commits["aux"] = (devices0.aux_free.reshape(n_aux_seg, 1),
                          seg_f.T.reshape(-1),
                          -(a_req * took_f).T.reshape(-1, 1))

    resv_groups, resv_finish = reservation_groups(
        resv0, pods, res_slot, ok,
        numa_take=out_take if enable_numa else None,
        gpu_take=gpu_take if use_gpu else None,
        gpu_per_inst=out_per if use_gpu else None)
    commits.update((("resv", k), g) for k, g in resv_groups.items())
    outs = ordered_scatter_add_named(commits)
    requested, assigned_est = outs["requested"], outs["est"]
    prod_assigned_est = outs["prod_est"]
    quota_used = outs.get("quota", quotas0.used)
    gang_assumed = gangs0.assumed + outs["gang"][:, 0].to(torch.int32)
    numa_free = nodes0.numa_free
    if enable_numa:
        numa_free = torch.clamp_min(outs["numa"], 0.0).view(
            n_nodes, n_zones, 2)
    new_devices = devices0
    if use_gpu:
        new_devices = devices0.replace(gpu_free=torch.clamp_min(
            outs["gpu"], 0.0).view(n_nodes, n_inst, 3))
    if use_aux:
        new_devices = new_devices.replace(aux_free=xla_max(
            outs["aux"].view(devices0.aux_free.shape), 0.0))
    new_resv = resv_finish({k: outs["resv", k] for k in resv_groups})

    # a slot's score outranks any node sum for the owner's preference;
    # it is reported capped at MaxNodeScore
    if n_slots:
        out_score = torch.where(on_slot_fin, torch.clamp_max(
            out_score, MAX_NODE_SCORE), out_score)
    chosen_score = torch.where(ok, out_score, -1.0)
    new_snap = snap.replace(
        nodes=nodes0.replace(requested=requested,
                             assigned_estimated=assigned_est,
                             prod_assigned_estimated=prod_assigned_est,
                             numa_free=numa_free),
        quotas=quotas0.replace(used=quota_used),
        gangs=gangs0.replace(assumed=gang_assumed),
        reservations=new_resv,
        devices=new_devices,
        version=snap.version + 1)
    return ScheduleResult(
        assignment=placed_real,
        chosen_score=chosen_score,
        numa_zone=numa_zone, numa_take=numa_take,
        gpu_take=gpu_take,
        aux_inst=aux_inst,
        res_slot=res_slot, gang_failed=gang_fail, snapshot=new_snap,
        amplified=enable_amplification)


def overcommit_ok(snap: ClusterSnapshot, tol: float = 1.0) -> bool:
    """The no-overcommit invariant on the host: requested <= allocatable
    + tol on every node."""
    return bool((snap.nodes.requested
                 <= snap.nodes.allocatable + tol).all().cpu())


def quota_ok(snap: ClusterSnapshot) -> bool:
    """Quota used <= runtime + EPS on every valid quota, on the host."""
    q = snap.quotas
    used = q.used.cpu().numpy()
    runtime = q.runtime.cpu().numpy()
    valid = q.valid.cpu().numpy()
    return bool((used[valid] <= runtime[valid] + EPS).all())


# --- the straggler tail ---------------------------------------------------
# The (group x domain) counts ride between passes where given; with a
# topo_prefix the selection keeps the constrained stragglers of a pass
# inside the retry batch's prefix (the budget, core.py:1437-1469).


def tail_select(pods: PodBatch, assign: torch.Tensor, tried: torch.Tensor,
                tail_chunk: int, topo_prefix: Optional[int] = None,
                topo_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx i64[tail_chunk], attempt bool[tail_chunk]): the batch rows of
    up to tail_chunk stragglers, never-retried ones first, and which of
    them are true leftovers this pass may retry (the rest pad the
    window).

    With `topo_prefix` and `topo_mask` (bool[P], the pods with a
    topology membership, in the batch's packed order): at most
    topo_prefix constrained stragglers, untried first, go to the front
    of the window, inside the retry batch's packing prefix, and the rest
    of it goes to the unconstrained stragglers, untried first; untried
    pods of either class come before every tried one. Constrained
    overflow is not attempted, so it stays never-retried for a later
    pass (tail_pass marks only attempted rows tried)."""
    bad = pods.valid & (assign < 0)
    if topo_prefix is None:
        key = torch.where(bad & ~tried, 0, torch.where(bad, 1, 2))
    else:
        cb = bad & topo_mask
        ckey = torch.where(cb & ~tried, 0, torch.where(cb, 1, 2))
        adm = cb & (stable_rank(ckey) < topo_prefix)
        free = bad & ~topo_mask
        key = torch.where(
            adm & ~tried, 0, torch.where(
                free & ~tried, 1, torch.where(
                    adm, 2, torch.where(free, 3, torch.where(bad, 4, 5)))))
    idx = torch.sort(key, stable=True).indices[:tail_chunk]
    attempt = bad[idx]
    if topo_prefix is not None:
        in_prefix = torch.arange(idx.shape[0], device=idx.device) < topo_prefix
        attempt = attempt & (~topo_mask[idx] | in_prefix)
    return idx, attempt


def tail_pass(step_fn: Callable, snap: ClusterSnapshot, assign: torch.Tensor,
              tried: torch.Tensor, pods: PodBatch, cfg, *, tail_chunk: int,
              carry: Optional[Dict[str, torch.Tensor]] = None,
              counts: Optional[tuple] = None,
              topo_prefix: Optional[int] = None,
              topo_mask: Optional[torch.Tensor] = None):
    """One retry pass: gather the selected stragglers (`tail_select`,
    with the topology budget where `topo_prefix` and `topo_mask` are
    given) into a compact [tail_chunk] batch, re-schedule it with
    `step_fn(snap, retry, cfg)` and scatter the placements back, and the
    placed pods' result fields named in `carry` ({field: [P, ...]}, e.g.
    `gpu_take`, `res_slot`) where given. `counts` (COUNT_FIELDS order),
    where given, are the retry batch's count0 fields and come back with
    its placements charged (core.py:1506-1510). Returns (snap, assign,
    tried, carry, counts)."""
    idx, attempt = tail_select(pods, assign, tried, tail_chunk, topo_prefix,
                               topo_mask)
    retry = pods.replace(
        **{f: getattr(pods, f)[idx] for f in PER_POD_FIELDS if f != "valid"},
        valid=attempt)
    if counts is not None:
        retry = retry.replace(**dict(zip(COUNT_FIELDS, counts)))
    tried = tried.clone()
    tried[idx] = tried[idx] | attempt
    res = step_fn(snap, retry, cfg)
    if counts is not None:
        counts = charge_all_counts(counts, retry, res.assignment)
    got = attempt & (res.assignment >= 0)
    assign = assign.clone()
    assign[idx] = torch.where(got, res.assignment, assign[idx])
    if carry is not None:
        carry = dict(carry)
        for field, full in carry.items():
            full = full.clone()
            new = getattr(res, field)
            full[idx] = torch.where(got.view(-1, *[1] * (new.dim() - 1)),
                                    new, full[idx])
            carry[field] = full
    return res.snapshot, assign, tried, carry, counts


def tail_compaction_loop(step_fn: Callable, snap: ClusterSnapshot,
                         assign: torch.Tensor, pods: PodBatch, cfg, *,
                         tail_chunk: int, min_passes: int, max_passes: int,
                         carry: Optional[Dict[str, torch.Tensor]] = None,
                         counts: Optional[tuple] = None,
                         topo_prefix: Optional[int] = None,
                         topo_mask: Optional[torch.Tensor] = None):
    """Run tail passes until the stragglers drain or the budget is
    spent: min(min_passes, max_passes) passes always run; more run while
    stragglers remain and (the count improved or never-retried ones
    remain), up to max_passes. The reference loops on device; here the
    host reads two counts after each pass. `topo_prefix` and `topo_mask`
    budget each pass's constrained stragglers (`tail_select`).

    Returns (snap, assign, stats i32[4], carry, counts) with stats =
    [stragglers_after_sweep, stragglers_final, never_retried, passes],
    carry the placed pods' result fields and counts the (group x domain)
    counts (COUNT_FIELDS order) with every pass's placements charged,
    each carried from its argument (None stays None)."""
    min_eff = min(int(min_passes), int(max_passes))
    left0 = int((pods.valid & (assign < 0)).sum())
    tried = torch.zeros_like(pods.valid)
    passes, left, improved, never_retried = 0, left0, False, left0
    while passes < min_eff or (passes < max_passes and left > 0
                               and (improved or never_retried > 0)):
        snap, assign, tried, carry, counts = tail_pass(
            step_fn, snap, assign, tried, pods, cfg, tail_chunk=tail_chunk,
            carry=carry, counts=counts, topo_prefix=topo_prefix,
            topo_mask=topo_mask)
        bad = pods.valid & (assign < 0)
        new_left, never_retried = (
            int(x) for x in torch.stack([bad.sum(), (bad & ~tried).sum()]).cpu())
        passes += 1
        improved = new_left < left
        left = new_left
    stats = torch.tensor([left0, left, never_retried, passes],
                         dtype=torch.int32)
    return snap, assign, stats, carry, counts
