"""K1 score_topk: one commit round's fused gates, fit, score, jitter, mask
and top-k.

Kernel: `csrc/score_topk.cu`. Replaces the round prologue of
koordinator_tpu/scheduler/core.py schedule_batch (cascade.static_gates
and the deviceshare prefilter, read there as one [P, N] mask;
core.py:565-577 fit, :675-684 quota admission, loadaware.score_matrix,
:721-742 jitter, mask and lax.top_k) without writing any [P, N] matrix:
the static gates come in factored form (`cascade.GateTerms`), an
optional bool[P, N] pair mask carries gates that do not factor, and up
to two f32[P, N] pair scores are added to the LoadAware score in the
reference's order (core.py:693-699: the NUMA zone score from K4, then
the DeviceShare pool score from K6).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.api.extension import NUM_RESOURCES
from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check
from koordinator_tpu_torch.scheduler.cascade import GateTerms, expand_gates
from koordinator_tpu_torch.scheduler.plugins import loadaware

# the tie-break jitter step, float32 as the reference rounds it
JITTER = float(np.float32(0.49 / 1024.0))
MAX_K = 32
MAX_LABELS = 1024   # label groups (selector table columns) the kernel takes
ROWS_PER_BLOCK = 16  # pod rows a block of the kernel takes

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


def score_topk_plain(gates: GateTerms, pair_ok: Optional[torch.Tensor],
                     row_ok, req_fit, requested_fit, alloc_fit, est,
                     prod_scored, node_term, prod_term, alloc_score,
                     weights, k: int, tie_break: bool, eps: float,
                     fma_sum: bool, pair_score: Optional[torch.Tensor] = None,
                     pair_score2: Optional[torch.Tensor] = None):
    """(val f32[P, k], idx i32[P, k]): the k best nodes of each pod by
    value descending then index ascending (lax.top_k's order), where a
    pair's value is its LoadAware score (+ pair_score, then +
    pair_score2, where given, each sum rounded, then + jitter) if it
    passes the static gates (`gates` expanded, and `pair_ok` where
    given), the row mask and the resource fit, else -1.
    `fma_sum` picks the rounding of the score's weighted sum
    (loadaware.weighted_sum)."""
    static_ok = expand_gates(gates)
    if pair_ok is not None:
        static_ok = static_ok & pair_ok
    fit = torch.all(req_fit[:, None, :] + requested_fit[None]
                    <= alloc_fit[None] + eps, dim=-1)
    feasible = fit & static_ok & row_ok[:, None]
    scores = loadaware.least_requested_score(
        est, prod_scored, node_term, prod_term, alloc_score,
        gates.metric_fresh, weights, fma_sum)
    if pair_score is not None:
        scores = scores + pair_score
    if pair_score2 is not None:
        scores = scores + pair_score2
    if tie_break:
        scores = tie_break_jitter(scores)
    masked = torch.where(feasible, scores, -1.0)
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
               pair_score2: Optional[torch.Tensor] = None):
    """The selection of `score_topk_plain`: the kernel for CUDA tensors,
    the plain version for CPU tensors. Shapes: `gates` over P pods and N
    nodes (selector table S x L, L <= MAX_LABELS); pair_ok bool[P, N] or
    None; pair_score, pair_score2 f32[P, N] or None (the second only with
    the first); row_ok, prod_scored bool[P]; req_fit f32[P, F]; requested_fit,
    alloc_fit f32[N, F]; est f32[P, D]; node_term, prod_term,
    alloc_score f32[N, D]; weights f32[D]; k <= 32;
    F, D <= NUM_RESOURCES.

    On the card, a launch merges the partial lists of its node splits by
    tickets kept for its (device, stream) and reset by the launch
    itself: launches on one stream share them, launches on other streams
    get their own. A launch that does not run to its end (a fault, which
    leaves the context unusable anyway) may leave them set."""
    p, f = req_fit.shape
    n = gates.label_group.shape[0]
    d = est.shape[1]
    s, labels = gates.selector_match.shape
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
        ("requested_fit", requested_fit, torch.float32, (n, f)),
        ("alloc_fit", alloc_fit, torch.float32, (n, f)),
        ("node_term", node_term, torch.float32, (n, d)),
        ("prod_term", prod_term, torch.float32, (n, d)),
        ("alloc_score", alloc_score, torch.float32, (n, d)),
        ("selector_match", gates.selector_match, torch.bool, (s, labels)),
        ("weights", weights, torch.float32, (d,))]
    if pair_ok is not None:
        checks.append(("pair_ok", pair_ok, torch.bool, (p, n)))
    if pair_score is not None:
        checks.append(("pair_score", pair_score, torch.float32, (p, n)))
    if pair_score2 is not None:
        if pair_score is None:
            raise ValueError("score_topk: pair_score2 needs pair_score")
        checks.append(("pair_score2", pair_score2, torch.float32, (p, n)))
    for name, t, dt, shape in checks:
        _launch.check_tensor(name, t, dt, shape, dev)
    if not 0 < k <= min(n, MAX_K):
        raise ValueError(f"score_topk: k={k} must be in [1, min(N, {MAX_K})]")
    if max(f, d) > NUM_RESOURCES:
        raise ValueError(f"score_topk: F={f}, D={d} above {NUM_RESOURCES}")
    if dev.type == "cpu":
        return score_topk_plain(gates, pair_ok, row_ok, req_fit,
                                requested_fit, alloc_fit, est, prod_scored,
                                node_term, prod_term, alloc_score, weights,
                                k, tie_break, eps, fma_sum, pair_score,
                                pair_score2)
    if dev.type != "cuda":
        raise ValueError(f"score_topk: unsupported device {dev}")
    if labels > MAX_LABELS:
        raise ValueError(f"score_topk: {labels} label groups above "
                         f"{MAX_LABELS}")
    stream = _launch.stream(dev)
    grid = TOOLCHAIN.function("score_topk", "koord_score_topk_blocks",
                              [ctypes.c_int] * 4)
    blocks = grid(p, f, d, int(pair_score is not None)
                  + int(pair_score2 is not None))
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
               pair_score, pair_score2)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    dims = (ctypes.c_int * 10)(p, n, f, d, k, s, labels,
                               int(bool(tie_break)), int(bool(fma_sum)),
                               blocks)
    fn = TOOLCHAIN.function("score_topk", "koord_score_topk",
                            [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_float, ctypes.c_void_p])
    rc = fn(ptrs, dims, eps, stream)
    check(rc, "score_topk")
    score_topk.launches += 1
    return val, idx


score_topk.launches = 0
