"""The batched scheduling core, slim form: feasibility, score and the
conflict-resolving commit of one pod batch, then the straggler tail.

Counterpart of `koordinator_tpu/scheduler/core.py` schedule_batch,
tail_select, tail_pass and tail_compaction_loop for the slim flagship:
no NUMA, no device instances, no reservation slots, no
spread/anti-affinity/affinity terms, no taint penalty, no
amplification, cascade off. Anything outside that raises
NotImplementedError.

Per round (num_rounds of them), kernel K1 (`score_topk`) picks each
active pod's k best feasible nodes. Then k inner steps run: each pod
tries its next choice, kernel K2 (`segment_prefix_ok`) admits it if it
fits the node, and then each quota level, after every earlier-ranked
pod that chose the same node or quota, and kernel K3
(`ordered_scatter_add`) commits the accepted requests; a rejected pod
falls through to its next choice. After the rounds, strict gangs below
quorum roll back, and the snapshot is rebuilt from the final
assignment. The reference runs the rounds and steps as lax.scan loops
inside one jitted program; here they are Python loops over launches,
with no host readback inside a batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from koordinator_tpu_torch.api.extension import NUM_AUX_TYPES, PriorityClass
from koordinator_tpu_torch.kernels.scatter import ordered_scatter_add
from koordinator_tpu_torch.kernels.score_topk import score_topk
from koordinator_tpu_torch.scheduler.batching import (
    EPS,
    rank_by_priority,
    segment_prefix_ok,
)
from koordinator_tpu_torch.scheduler.cascade import static_gates
from koordinator_tpu_torch.scheduler.plugins import deviceshare, loadaware
from koordinator_tpu_torch.scheduler.plugins.reservation import (
    rebuild_reservations,
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


@dataclasses.dataclass
class ScheduleResult(Struct):
    assignment: torch.Tensor     # i32[P] node index, -1 = unschedulable
    chosen_score: torch.Tensor   # f32[P] score of the chosen node, -1
    numa_zone: torch.Tensor      # i32[P], -1 (no NUMA on the slim path)
    numa_take: torch.Tensor      # f32[P, Z, 2], zero
    gpu_take: torch.Tensor       # bool[P, I], False
    aux_inst: torch.Tensor       # i32[P, 2], -1
    res_slot: torch.Tensor       # i32[P] reservation slot consumed, -1
    gang_failed: torch.Tensor    # bool[G] strict gangs proven below quorum
    snapshot: ClusterSnapshot    # post-commit snapshot
    amplified: bool = False


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: the port covers the slim flagship path "
        "(ROADMAP queue A item 6 holds the full-gate form)")


def _check_slim(snap: ClusterSnapshot, pods: PodBatch, *, enable_numa,
                enable_devices, enable_amplification, cascade,
                approx_topk) -> None:
    if enable_numa:
        raise _unported("enable_numa=True")
    if enable_amplification:
        raise _unported("enable_amplification=True")
    if cascade:
        raise _unported("cascade=True")
    if approx_topk:
        raise _unported("approx_topk=True")
    if enable_devices and (snap.devices.gpu_free.shape[1]
                           or snap.devices.aux_free.shape[2]):
        raise _unported("a snapshot with GPU instances or aux pools")
    if pods.has_spread or pods.has_anti or pods.has_aff:
        raise _unported("pod topology spread and inter-pod (anti-)affinity")


def _count(n: int, idx: torch.Tensor) -> torch.Tensor:
    """f32[n, 1]: how many entries of idx fall on each of n rows (rows
    outside [0, n) dropped), through the ordered scatter."""
    ones = torch.ones((idx.shape[0], 1), dtype=torch.float32,
                      device=idx.device)
    zeros = torch.zeros((n, 1), dtype=torch.float32, device=idx.device)
    return ordered_scatter_add(zeros, idx, ones)


def _where_i32(cond: torch.Tensor, a, b) -> torch.Tensor:
    return torch.where(cond, a, b).to(torch.int32)


def schedule_batch(snap: ClusterSnapshot, pods: PodBatch,
                   cfg: loadaware.LoadAwareConfig,
                   num_rounds: int = 4, k_choices: int = 8,
                   score_dims: tuple = None,
                   approx_topk: bool = False,
                   tie_break: bool = False,
                   enable_numa: bool = True,
                   enable_devices: bool = True,
                   quota_depth: int = MAX_QUOTA_DEPTH,
                   fit_dims: tuple = None,
                   enable_amplification: bool = False,
                   cascade: bool = False) -> ScheduleResult:
    """Schedule a pod batch against the snapshot. Pure: the caller
    publishes `result.snapshot`.

    The arguments are the reference's slim-path subset, with its
    defaults, so a slim caller passes enable_numa=False. `fit_dims` are
    the resource dims the capacity and quota gates check (None = all);
    `score_dims` the dims LoadAware scores. The reference's packing
    contracts (topo/numa/gpu prefixes, domain classes) and strategies
    belong to the full-gate path and are not arguments here."""
    _check_slim(snap, pods, enable_numa=enable_numa,
                enable_devices=enable_devices,
                enable_amplification=enable_amplification, cascade=cascade,
                approx_topk=approx_topk)
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

    # gang quorum (coscheduling PreFilter, core.go:220-274)
    gid = pods.gang_id.clamp_min(0).long()
    gang_quorum = ((gangs0.member_count >= gangs0.min_member)
                   | gangs0.satisfied) & gangs0.valid
    gang_ok = (pods.gang_id < 0) | gang_quorum[gid]

    # ancestor chain per pod per depth, -1 = none
    pod_anc = torch.where(
        pods.quota_id[:, None] >= 0,
        quotas0.depth_ancestor[pods.quota_id.clamp_min(0).long()],
        -1).to(torch.int32)                                     # [P, D]

    static_ok, taint_penalty = static_gates(nodes0, pods, cfg)
    if taint_penalty is not None:
        raise _unported("the taint score penalty (pods.has_taints)")
    if enable_devices:
        static_ok = static_ok & deviceshare.prefilter(snap.devices, pods)
    slot_columns(snap, pods, static_ok)  # raises on live slots
    n_ext = n_nodes  # no slot columns
    static_ok = static_ok.contiguous()

    req_fit = dims(pods.requests)
    alloc_fit = dims(nodes0.allocatable)
    runtime_fit = dims(quotas0.runtime)
    est_score = (pods.estimated if sd is None
                 else pods.estimated[:, sd]).contiguous()
    is_prod = pods.priority_class == PROD
    is_prod_scored = loadaware.prod_scored(pods, cfg)
    k = min(k_choices, n_ext)

    requested = nodes0.requested
    quota_used = quotas0.used
    assigned_est = nodes0.assigned_estimated
    prod_assigned_est = nodes0.prod_assigned_estimated
    gang_placed = torch.zeros((n_gangs, 1), dtype=torch.float32, device=dev)
    placed = torch.full((p,), -1, dtype=torch.int32, device=dev)
    out_score = torch.full((p,), -1.0, dtype=torch.float32, device=dev)
    drop_node = torch.full((p,), n_ext, dtype=torch.int32, device=dev)
    drop_quota = torch.full((p,), n_quotas, dtype=torch.int32, device=dev)

    for _ in range(num_rounds):
        active = pods.valid & (placed < 0) & gang_ok

        # quota admission (ElasticQuota PreFilter): used + request <=
        # runtime at every tree level
        quota_admit = torch.ones((p,), dtype=torch.bool, device=dev)
        for d in range(quota_depth):
            anc = pod_anc[:, d]
            a = anc.clamp_min(0).long()
            level_ok = torch.all(dims(quota_used)[a] + req_fit
                                 <= runtime_fit[a] + EPS, dim=-1)
            quota_admit = quota_admit & ((anc < 0) | level_ok)
        row_ok = (active & quota_admit).contiguous()

        # score inputs frozen for the round (the reference's NodeMetric
        # does not change on assume either)
        nodes = nodes0.replace(assigned_estimated=assigned_est,
                               prod_assigned_estimated=prod_assigned_est)
        node_term, prod_term, alloc_score, weights = loadaware.score_terms(
            nodes, cfg, score_dims)
        topk_val, topk_idx = score_topk(
            static_ok, row_ok, req_fit, dims(requested), alloc_fit,
            est_score, is_prod_scored, node_term, prod_term, alloc_score,
            nodes0.metric_fresh, weights, k, tie_break, EPS)

        kptr = torch.zeros((p,), dtype=torch.int64, device=dev)
        for _ in range(k):
            at = kptr.clamp_max(k - 1)[:, None]
            val = topk_val.gather(1, at)[:, 0]
            choice = topk_idx.gather(1, at)[:, 0]
            trying = active & (placed < 0) & (kptr < k) & (val > -0.5)
            choice_eff = _where_i32(trying, choice, drop_node)

            # node capacity prefix in priority order
            eff_req = torch.where(trying[:, None], req_fit, 0.0)
            accept = trying & segment_prefix_ok(
                choice_eff, rank, eff_req, dims(requested), alloc_fit,
                n_ext, EPS)
            # quota prefix per tree level, the same gate
            for d in range(quota_depth):
                anc = torch.where(accept, pod_anc[:, d], -1)
                anc_eff = _where_i32(anc >= 0, anc, drop_quota)
                acc_req = torch.where(accept[:, None], req_fit, 0.0)
                accept = accept & segment_prefix_ok(
                    anc_eff, rank, acc_req, dims(quota_used), runtime_fit,
                    n_quotas, EPS)

            # scatter-commit (assume)
            acc_req = pods.requests * accept[:, None]
            requested = ordered_scatter_add(requested, choice_eff, acc_req)
            for d in range(quota_depth):
                anc = torch.where(accept, pod_anc[:, d], -1)
                quota_used = ordered_scatter_add(
                    quota_used, _where_i32(anc >= 0, anc, drop_quota),
                    acc_req)
            placed = _where_i32(accept, choice, placed)
            out_score = torch.where(accept, val, out_score)
            # a rejected pod's chosen node just filled up: fall through
            kptr = torch.where(trying & ~accept, kptr + 1, kptr)

        # newly placed pods' estimates feed the next round's scores
        new = (placed >= 0) & active
        tgt = _where_i32(new, placed, n_nodes)
        est = pods.estimated * new[:, None]
        assigned_est = ordered_scatter_add(assigned_est, tgt, est)
        prod_assigned_est = ordered_scatter_add(
            prod_assigned_est, tgt, est * is_prod[:, None])
        gang_placed = gang_placed + _count(
            n_gangs, _where_i32(new & (pods.gang_id >= 0), pods.gang_id,
                                n_gangs))

    # gang all-or-nothing rollback (Permit barrier, core.go:311-341): a
    # strict gang below quorum rolls back once no member is outstanding
    attempted = _count(n_gangs, _where_i32(
        pods.valid & (pods.gang_id >= 0), pods.gang_id, n_gangs))
    attempted = attempted[:, 0].to(torch.int32)
    outstanding = torch.clamp_min(
        gangs0.member_count - gangs0.assumed - attempted, 0)
    gang_total = gangs0.assumed + gang_placed[:, 0].to(torch.int32)
    gang_fail = (gangs0.valid & gangs0.strict & ~gangs0.satisfied
                 & (gang_total < gangs0.min_member) & (outstanding == 0))
    revoke = (placed >= 0) & (pods.gang_id >= 0) & gang_fail[gid]
    placed = _where_i32(revoke, -1, placed)

    # rebuild the post-commit state from the final assignment (no slot
    # consumers: every placed pod charges its node)
    ok = placed >= 0
    res_slot = torch.full((p,), -1, dtype=torch.int32, device=dev)
    tgt = _where_i32(ok, placed, n_nodes)
    fin_req = pods.requests * ok[:, None]
    fin_est = pods.estimated * ok[:, None]
    requested = ordered_scatter_add(nodes0.requested, tgt, fin_req)
    assigned_est = ordered_scatter_add(nodes0.assigned_estimated, tgt,
                                       fin_est)
    prod_assigned_est = ordered_scatter_add(
        nodes0.prod_assigned_estimated, tgt, fin_est * is_prod[:, None])
    quota_used = quotas0.used
    for d in range(quota_depth):
        anc = torch.where(ok, pod_anc[:, d], -1)
        quota_used = ordered_scatter_add(
            quota_used, _where_i32(anc >= 0, anc, drop_quota), fin_req)
    gang_assumed = gangs0.assumed + _count(n_gangs, _where_i32(
        ok & (pods.gang_id >= 0), pods.gang_id, n_gangs))[:, 0].to(torch.int32)

    n_zones = nodes0.numa_cap.shape[1]
    n_inst = snap.devices.gpu_free.shape[1]
    new_snap = snap.replace(
        nodes=nodes0.replace(requested=requested,
                             assigned_estimated=assigned_est,
                             prod_assigned_estimated=prod_assigned_est),
        quotas=quotas0.replace(used=quota_used),
        gangs=gangs0.replace(assumed=gang_assumed),
        reservations=rebuild_reservations(snap.reservations, pods, res_slot,
                                          ok),
        version=snap.version + 1)
    return ScheduleResult(
        assignment=placed,
        chosen_score=torch.where(ok, out_score, -1.0),
        numa_zone=torch.full((p,), -1, dtype=torch.int32, device=dev),
        numa_take=torch.zeros((p, n_zones, 2), dtype=torch.float32,
                              device=dev),
        gpu_take=torch.zeros((p, n_inst), dtype=torch.bool, device=dev),
        aux_inst=torch.full((p, NUM_AUX_TYPES), -1, dtype=torch.int32,
                            device=dev),
        res_slot=res_slot, gang_failed=gang_fail, snapshot=new_snap)


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
# The slim form: no topology-constrained budget in the selection and no
# (group x domain) counts to carry between passes.


def tail_select(pods: PodBatch, assign: torch.Tensor, tried: torch.Tensor,
                tail_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx i64[tail_chunk], attempt bool[tail_chunk]): the batch rows of
    up to tail_chunk stragglers, never-retried ones first, and which of
    them are true leftovers (the rest pad the window)."""
    bad = pods.valid & (assign < 0)
    key = torch.where(bad & ~tried, 0, torch.where(bad, 1, 2))
    idx = torch.sort(key, stable=True).indices[:tail_chunk]
    return idx, bad[idx]


def tail_pass(step_fn: Callable, snap: ClusterSnapshot, assign: torch.Tensor,
              tried: torch.Tensor, pods: PodBatch, cfg, *, tail_chunk: int):
    """One retry pass: gather the selected stragglers into a compact
    [tail_chunk] batch, re-schedule it with `step_fn(snap, retry, cfg)`
    and scatter the placements back. Returns (snap, assign, tried)."""
    idx, attempt = tail_select(pods, assign, tried, tail_chunk)
    retry = pods.replace(
        **{f: getattr(pods, f)[idx] for f in PER_POD_FIELDS if f != "valid"},
        valid=attempt)
    tried = tried.clone()
    tried[idx] = tried[idx] | attempt
    res = step_fn(snap, retry, cfg)
    got = attempt & (res.assignment >= 0)
    assign = assign.clone()
    assign[idx] = torch.where(got, res.assignment, assign[idx])
    return res.snapshot, assign, tried


def tail_compaction_loop(step_fn: Callable, snap: ClusterSnapshot,
                         assign: torch.Tensor, pods: PodBatch, cfg, *,
                         tail_chunk: int, min_passes: int, max_passes: int):
    """Run tail passes until the stragglers drain or the budget is
    spent: min(min_passes, max_passes) passes always run; more run while
    stragglers remain and (the count improved or never-retried ones
    remain), up to max_passes. The reference loops on device; here the
    host reads two counts after each pass.

    Returns (snap, assign, stats i32[4]) with stats =
    [stragglers_after_sweep, stragglers_final, never_retried, passes]."""
    min_eff = min(int(min_passes), int(max_passes))
    left0 = int((pods.valid & (assign < 0)).sum())
    tried = torch.zeros_like(pods.valid)
    passes, left, improved, never_retried = 0, left0, False, left0
    while passes < min_eff or (passes < max_passes and left > 0
                               and (improved or never_retried > 0)):
        snap, assign, tried = tail_pass(step_fn, snap, assign, tried, pods,
                                        cfg, tail_chunk=tail_chunk)
        bad = pods.valid & (assign < 0)
        new_left, never_retried = (
            int(x) for x in torch.stack([bad.sum(), (bad & ~tried).sum()]).cpu())
        passes += 1
        improved = new_left < left
        left = new_left
    stats = torch.tensor([left0, left, never_retried, passes],
                         dtype=torch.int32)
    return snap, assign, stats
