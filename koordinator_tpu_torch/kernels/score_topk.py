"""K1 score_topk: one commit round's fused gates, fit, score, jitter, mask
and top-k.

Kernel: `csrc/score_topk.cu`. Replaces the round prologue of
koordinator_tpu/scheduler/core.py schedule_batch (cascade.static_gates
and the deviceshare prefilter, read there as one [P, N] mask;
core.py:565-577 fit, :675-684 quota admission, loadaware.score_matrix,
:693-742 addends, taint penalty, slot columns, jitter, mask and
lax.top_k) without writing any [P, N] matrix: the static gates come in
factored form (`cascade.GateTerms`, with the taint forbid and penalty
tables for a batch with tolerations), an optional bool[P, N] pair mask
carries gates that do not factor, up to two f32[P, N] pair scores are
added to the LoadAware score in the reference's order (core.py:693-699:
the NUMA zone score from K4, then the DeviceShare pool score from K6),
the taint penalty is subtracted and the result floored at 0
(:700-704), the pod topology gates (spread, anti-affinity and affinity,
:587-675) come as bit words a pod and a column (`TopoTerms`), the spread
penalty is subtracted and the result floored at 0 again (:705-712), and
V reservation slots are extra columns N..N+V-1 of the selection
(:713-720, the owner-restricted virtual nodes of plugins/reservation.py)
scoring 3 * MAX_NODE_SCORE + 1. With amplified CPU (`AmpTerms`,
:383-404, :565-577) a CPU-bind pod must also fit its CPU request times
each node's ratio.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.api.extension import NUM_RESOURCES
from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check
from koordinator_tpu_torch.scheduler.batching import MAX_NODE_SCORE
from koordinator_tpu_torch.scheduler.cascade import (
    GateTerms,
    expand_gates,
    taint_penalty,
)
from koordinator_tpu_torch.scheduler.plugins import loadaware

# the tie-break jitter step, float32 as the reference rounds it
JITTER = float(np.float32(0.49 / 1024.0))
MAX_K = 32
MAX_LABELS = 1024   # label groups (selector table columns) the kernel takes
MAX_TAINT_GROUPS = 64  # taint groups (forbid/penalty table columns)
# a reservation slot column's score: above any node's sum of plugin scores
SLOT_SCORE = 3.0 * MAX_NODE_SCORE + 1.0
ROWS_PER_BLOCK = 16  # pod rows a block of the kernel takes
# the pod topology gate's families: a pod's word of each is ANDed with
# the column's word of the same family
TOPO_FAMILIES = 5
TOPO_SPREAD, TOPO_ANTI_A, TOPO_ANTI_B, TOPO_AFF, TOPO_AFF_BOOT = range(5)


@dataclasses.dataclass
class TopoTerms:
    """A round's pod topology gates and spread penalty in factored form
    (scheduler/domains.py round_terms). `pod_words` i32[P, 5]: a pod's
    bits over each family's groups (spread carried groups, anti-affinity
    carried groups, anti-affinity matched groups, affinity carried
    groups it cannot open, affinity groups it may open); `col_words`
    i32[5, N + V]: each column's bits of the groups that reject it (a
    spread group's domain at its skew, or keyless for a hard group; an
    anti-affinity domain holding a member; one holding a carrier; an
    affinity domain holding no member, or keyless; keyless). A pair is
    blocked where any family's words share a bit. `penalty` f32[Sg,
    N + V] or None: the spread penalty map; a node pair's penalty is the
    sum, in ascending group order, of its spread groups' entries, and
    with a map every node value is floored at 0 after it."""
    pod_words: torch.Tensor
    col_words: torch.Tensor
    penalty: Optional[torch.Tensor] = None


@dataclasses.dataclass
class AmpTerms:
    """The amplified-CPU fit (core.py:383-404, :565-577): `bind` bool[P]
    the CPU-bind pods (numa_single), `ratio` f32[N] each node's CPU
    amplification, `col` the fit column of CPU. A bind pod fits node n
    only where fl(fl(req[col] * ratio[n]) + requested[n, col]) <=
    fl(alloc[n, col] + eps); the slot columns keep a ratio of 1 (the
    fit's own check)."""
    bind: torch.Tensor
    ratio: torch.Tensor
    col: int


def amp_fit(amp: AmpTerms, req_fit, requested_fit, alloc_fit, eps):
    """bool[P, N]: the amplified CPU fit on the node columns."""
    n = amp.ratio.shape[0]
    c = amp.col
    amp_cpu = req_fit[:, c][:, None] * torch.where(
        amp.bind[:, None], amp.ratio[None, :], 1.0)
    return amp_cpu + requested_fit[None, :n, c] <= alloc_fit[None, :n, c] + eps


def topo_blocked(topo: TopoTerms) -> torch.Tensor:
    """bool[P, N + V]: the pairs the words block."""
    hit = topo.pod_words[:, :, None] & topo.col_words[None, :, :]
    return (hit != 0).any(dim=1)


def spread_penalty(topo: TopoTerms, n: int) -> torch.Tensor:
    """f32[P, n]: each pod's spread penalty on the first n columns, its
    carried groups' entries summed in ascending group order."""
    words = topo.pod_words[:, TOPO_SPREAD]
    out = torch.zeros((words.shape[0], n), dtype=torch.float32,
                      device=words.device)
    for g in range(topo.penalty.shape[0]):
        bit = ((words >> g) & 1) != 0
        out = torch.where(bit[:, None], out + topo.penalty[g, :n], out)
    return out

# per (device, stream): the kernel's split-merge tickets, zero between
# launches (each launch's last block of a row group resets its own);
# launches on one stream run one after another, so they may share them
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def tie_break_jitter(scores: torch.Tensor) -> torch.Tensor:
    """scores + h(p, n) * JITTER with one rounding, where
    h = (p * 2654435761 + n * 40503) mod 2^32 & 1023 (k8s selectHost's
    uniform choice among equal scores, made deterministic)."""
    p, n = scores.shape
    pi = torch.arange(p, dtype=torch.int64, device=scores.device)[:, None]
    ni = torch.arange(n, dtype=torch.int64, device=scores.device)[None, :]
    h = (pi * 2654435761 + ni * 40503) & 1023
    return loadaware.fma_f32(h.to(torch.float32), JITTER, scores)


def add_rows(scores: torch.Tensor, addend: torch.Tensor) -> torch.Tensor:
    """scores f32[P, N] with addend f32[rows, N] (rows <= P) added to its
    first rows, the rows beyond as they are (the reference adds zero
    rows there)."""
    rows = addend.shape[0]
    return torch.cat([scores[:rows] + addend, scores[rows:]])


def masked_scores(gates: GateTerms, pair_ok: Optional[torch.Tensor],
                  row_ok, req_fit, requested_fit, alloc_fit, est,
                  prod_scored, node_term, prod_term, alloc_score, weights,
                  tie_break: bool, eps: float, fma_sum: bool,
                  pair_score: Optional[torch.Tensor] = None,
                  pair_score2: Optional[torch.Tensor] = None,
                  slot_ok: Optional[torch.Tensor] = None,
                  slot_block: Optional[torch.Tensor] = None,
                  topo: Optional[TopoTerms] = None,
                  amp: Optional[AmpTerms] = None):
    """f32[P, N + V]: each pair's value in the selection of
    `score_topk_plain`, -1 where it is not feasible (the reference's
    masked matrix, core.py:693-735)."""
    n = gates.label_group.shape[0]
    static_ok = expand_gates(gates)
    if pair_ok is not None:
        static_ok = static_ok & pair_ok
    fit = torch.all(req_fit[:, None, :] + requested_fit[None]
                    <= alloc_fit[None] + eps, dim=-1)          # [P, N+V]
    feasible = fit[:, :n] & static_ok & row_ok[:, None]
    if amp is not None:
        feasible = feasible & amp_fit(amp, req_fit, requested_fit,
                                      alloc_fit, eps)
    scores = loadaware.least_requested_score(
        est, prod_scored, node_term, prod_term, alloc_score,
        gates.metric_fresh, weights, fma_sum)
    if pair_score is not None:
        scores = add_rows(scores, pair_score)
    if pair_score2 is not None:
        scores = add_rows(scores, pair_score2)
    penalty = taint_penalty(gates)
    if penalty is not None:
        scores = torch.clamp_min(scores - penalty, 0.0)
    if topo is not None and topo.penalty is not None:
        scores = torch.clamp_min(scores - spread_penalty(topo, n), 0.0)
    if slot_ok is not None:
        feasible = torch.cat([feasible, fit[:, n:] & slot_ok
                              & ~slot_block[None, :] & row_ok[:, None]], 1)
        scores = torch.cat([scores, torch.full_like(slot_ok, SLOT_SCORE,
                                                    dtype=scores.dtype)], 1)
    if topo is not None:
        feasible = feasible & ~topo_blocked(topo)
    if tie_break:
        scores = tie_break_jitter(scores)
    return torch.where(feasible, scores, -1.0)


def score_topk_plain(gates: GateTerms, pair_ok: Optional[torch.Tensor],
                     row_ok, req_fit, requested_fit, alloc_fit, est,
                     prod_scored, node_term, prod_term, alloc_score,
                     weights, k: int, tie_break: bool, eps: float,
                     fma_sum: bool, pair_score: Optional[torch.Tensor] = None,
                     pair_score2: Optional[torch.Tensor] = None,
                     slot_ok: Optional[torch.Tensor] = None,
                     slot_block: Optional[torch.Tensor] = None,
                     topo: Optional[TopoTerms] = None,
                     amp: Optional[AmpTerms] = None):
    """(val f32[P, k], idx i32[P, k]): the k best of each pod's N node
    columns and V slot columns by value descending then index ascending
    (lax.top_k's order). A node pair's value is its LoadAware score
    (+ pair_score, then + pair_score2, where given and on the rows each
    covers, each sum rounded;
    then minus the taint penalty where `gates` carries one, floored at
    0), plus jitter, if it passes the static gates (`gates` expanded,
    and `pair_ok` where given), the row mask and the resource fit, else
    -1. Slot column N + v (`slot_ok` bool[P, V] given) is worth
    SLOT_SCORE plus jitter if slot_ok[p, v], the row mask, the fit of
    the request against row N + v of requested_fit / alloc_fit, and not
    slot_block[v] hold, else -1. With `topo`, a pair its words block is
    -1 (slot columns included), and with a spread penalty map a node
    pair's value before the jitter is max(v - spread, 0), v the value
    above (the reference's order, core.py:700-712). With `amp` a
    CPU-bind pod's node pairs also need the amplified CPU fit
    (`AmpTerms`). `fma_sum` picks the rounding of the score's weighted
    sum (loadaware.weighted_sum)."""
    masked = masked_scores(gates, pair_ok, row_ok, req_fit, requested_fit,
                           alloc_fit, est, prod_scored, node_term,
                           prod_term, alloc_score, weights, tie_break, eps,
                           fma_sum, pair_score, pair_score2, slot_ok,
                           slot_block, topo, amp)
    val, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    return val[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def _tickets(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _TICKETS.get((dev, stream))
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 1024),), dtype=torch.int32, device=dev)
        _TICKETS[(dev, stream)] = t
    return t


def score_topk(gates: GateTerms, pair_ok: Optional[torch.Tensor], row_ok,
               req_fit, requested_fit, alloc_fit, est, prod_scored,
               node_term, prod_term, alloc_score, weights, k: int,
               tie_break: bool, eps: float, fma_sum: bool,
               pair_score: Optional[torch.Tensor] = None,
               pair_score2: Optional[torch.Tensor] = None,
               slot_ok: Optional[torch.Tensor] = None,
               slot_block: Optional[torch.Tensor] = None,
               topo: Optional[TopoTerms] = None,
               amp: Optional[AmpTerms] = None):
    """The selection of `score_topk_plain`: the kernel for CUDA tensors,
    the plain version for CPU tensors. Shapes: `gates` over P pods and N
    nodes (selector table S x L, L <= MAX_LABELS; with tolerations,
    forbid and penalty tables T x G, G <= MAX_TAINT_GROUPS); pair_ok
    bool[P, N] or None; pair_score f32[R1, N], pair_score2 f32[R2, N]
    or None (the second only with the first; R1, R2 <= P: an addend
    covers the batch's first rows, and adds nothing beyond); slot_ok bool[P, V] and slot_block
    bool[V], or both None (V = 0); row_ok, prod_scored bool[P];
    req_fit f32[P, F]; requested_fit, alloc_fit f32[N + V, F]; est
    f32[P, D]; node_term, prod_term, alloc_score f32[N, D]; weights
    f32[D]; topo (`TopoTerms`: pod_words i32[P, 5], col_words
    i32[5, N + V], penalty f32[Sg, N + V] with Sg <= 32, or None) or
    None; amp (`AmpTerms`: bind bool[P], ratio f32[N], 0 <= col < F) or
    None; k <= min(N + V, 32); F, D <= NUM_RESOURCES.

    On the card, a launch merges the partial lists of its node splits by
    tickets kept for its (device, stream) and reset by the launch
    itself: launches on one stream share them, launches on other streams
    get their own. A launch that does not run to its end (a fault, which
    leaves the context unusable anyway) may leave them set."""
    p, f = req_fit.shape
    n = gates.label_group.shape[0]
    d = est.shape[1]
    s, labels = gates.selector_match.shape
    if (slot_ok is None) != (slot_block is None):
        raise ValueError("score_topk: slot_ok and slot_block go together")
    v = 0 if slot_ok is None else slot_ok.shape[1]
    dev = req_fit.device
    checks = [
        ("row_ok", row_ok, torch.bool, (p,)),
        ("selector_id", gates.selector_id, torch.int32, (p,)),
        ("prod_gate", gates.prod_gate, torch.bool, (p,)),
        ("daemonset", gates.daemonset, torch.bool, (p,)),
        ("device_ok", gates.device_ok, torch.bool, (p,)),
        ("prod_scored", prod_scored, torch.bool, (p,)),
        ("req_fit", req_fit, torch.float32, (p, f)),
        ("est", est, torch.float32, (p, d)),
        ("label_group", gates.label_group, torch.int32, (n,)),
        ("node_ok", gates.node_ok, torch.bool, (n,)),
        ("prod_node_ok", gates.prod_node_ok, torch.bool, (n,)),
        ("metric_fresh", gates.metric_fresh, torch.bool, (n,)),
        ("schedulable", gates.schedulable, torch.bool, (n,)),
        ("requested_fit", requested_fit, torch.float32, (n + v, f)),
        ("alloc_fit", alloc_fit, torch.float32, (n + v, f)),
        ("node_term", node_term, torch.float32, (n, d)),
        ("prod_term", prod_term, torch.float32, (n, d)),
        ("alloc_score", alloc_score, torch.float32, (n, d)),
        ("selector_match", gates.selector_match, torch.bool, (s, labels)),
        ("weights", weights, torch.float32, (d,))]
    taints = gates.tol_forbid is not None
    t = groups = 0
    if taints:
        t, groups = gates.tol_forbid.shape
        checks += [
            ("toleration_id", gates.toleration_id, torch.int32, (p,)),
            ("taint_group", gates.taint_group, torch.int32, (n,)),
            ("tol_forbid", gates.tol_forbid, torch.bool, (t, groups)),
            ("tol_penalty", gates.tol_penalty, torch.float32, (t, groups))]
        if t == 0 or groups == 0:
            raise ValueError("score_topk: empty toleration table")
    if slot_ok is not None:
        checks += [("slot_ok", slot_ok, torch.bool, (p, v)),
                   ("slot_block", slot_block, torch.bool, (v,))]
    if topo is not None:
        checks += [("pod_words", topo.pod_words, torch.int32,
                    (p, TOPO_FAMILIES)),
                   ("col_words", topo.col_words, torch.int32,
                    (TOPO_FAMILIES, n + v))]
        if topo.penalty is not None:
            checks.append(("penalty", topo.penalty, torch.float32,
                           (None, n + v)))
            if not 0 < topo.penalty.shape[0] <= 32:
                raise ValueError("score_topk: the spread penalty map needs "
                                 "1 to 32 groups")
    if pair_ok is not None:
        checks.append(("pair_ok", pair_ok, torch.bool, (p, n)))
    if amp is not None:
        checks += [("amp_bind", amp.bind, torch.bool, (p,)),
                   ("amp_ratio", amp.ratio, torch.float32, (n,))]
        if not 0 <= amp.col < f:
            raise ValueError(f"score_topk: amp column {amp.col} outside "
                             f"[0, {f})")
    if pair_score2 is not None and pair_score is None:
        raise ValueError("score_topk: pair_score2 needs pair_score")
    for name, x in (("pair_score", pair_score),
                    ("pair_score2", pair_score2)):
        if x is not None:
            checks.append((name, x, torch.float32, (None, n)))
            if x.shape[0] > p:
                raise ValueError(f"score_topk: {name} has {x.shape[0]} "
                                 f"rows, more than {p}")
    for name, x, dt, shape in checks:
        _launch.check_tensor(name, x, dt, shape, dev)
    if not 0 < k <= min(n + v, MAX_K):
        raise ValueError(f"score_topk: k={k} must be in [1, min(N + V, "
                         f"{MAX_K})]")
    if max(f, d) > NUM_RESOURCES:
        raise ValueError(f"score_topk: F={f}, D={d} above {NUM_RESOURCES}")
    if dev.type == "cpu":
        return score_topk_plain(gates, pair_ok, row_ok, req_fit,
                                requested_fit, alloc_fit, est, prod_scored,
                                node_term, prod_term, alloc_score, weights,
                                k, tie_break, eps, fma_sum, pair_score,
                                pair_score2, slot_ok, slot_block, topo, amp)
    if dev.type != "cuda":
        raise ValueError(f"score_topk: unsupported device {dev}")
    # an addend of no rows adds nothing: the kernel takes the others
    addends = [x for x in (pair_score, pair_score2)
               if x is not None and x.shape[0]]
    pair_score, pair_score2 = (addends + [None, None])[:2]
    if labels > MAX_LABELS or groups > MAX_TAINT_GROUPS:
        raise ValueError(f"score_topk: {labels} label groups or {groups} "
                         f"taint groups above {MAX_LABELS}, "
                         f"{MAX_TAINT_GROUPS}")
    stream = _launch.stream(dev)
    grid = TOOLCHAIN.function("score_topk", "koord_score_topk_blocks",
                              [ctypes.c_int] * 6)
    blocks = grid(p, f, d, int(pair_score is not None)
                  + int(pair_score2 is not None), int(taints),
                  int(topo is not None))
    check(0 if blocks > 0 else -blocks, "score_topk (occupancy)")
    val = torch.empty((p, k), dtype=torch.float32, device=dev)
    idx = torch.empty((p, k), dtype=torch.int32, device=dev)
    part_val = torch.empty((blocks * ROWS_PER_BLOCK * k,),
                           dtype=torch.float32, device=dev)
    part_idx = torch.empty((blocks * ROWS_PER_BLOCK * k,),
                           dtype=torch.int32, device=dev)
    tensors = (row_ok, gates.device_ok, gates.selector_id, gates.prod_gate,
               gates.daemonset, prod_scored, req_fit, est,
               gates.label_group, gates.node_ok, gates.prod_node_ok,
               gates.metric_fresh, gates.schedulable, requested_fit,
               alloc_fit, node_term, prod_term, alloc_score,
               gates.selector_match, pair_ok, weights, part_val, part_idx,
               _tickets(dev, stream.value or 0, blocks), val, idx,
               pair_score, pair_score2, gates.toleration_id,
               gates.taint_group, gates.tol_forbid, gates.tol_penalty,
               slot_ok, slot_block,
               *((topo.pod_words, topo.col_words, topo.penalty)
                 if topo is not None else (None, None, None)),
               *((amp.bind, amp.ratio) if amp is not None else (None, None)))
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if x is None else x.data_ptr() for x in tensors))
    sg = 0 if topo is None or topo.penalty is None else topo.penalty.shape[0]
    ld = 0 if not sg else topo.penalty.stride(0)
    rows = [0 if x is None else x.shape[0] for x in (pair_score, pair_score2)]
    dims = (ctypes.c_int * 18)(p, n, f, d, k, s, labels,
                               int(bool(tie_break)), int(bool(fma_sum)),
                               blocks, v, t, groups, sg, ld, *rows,
                               0 if amp is None else int(amp.col))
    fn = TOOLCHAIN.function("score_topk", "koord_score_topk",
                            [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_float, ctypes.c_void_p])
    rc = fn(ptrs, dims, eps, stream)
    check(rc, "score_topk")
    score_topk.launches += 1
    return val, idx


score_topk.launches = 0
