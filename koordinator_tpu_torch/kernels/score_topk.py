"""K1 score_topk: one commit round's fused fit, score, jitter, mask and
top-k.

Kernel: `csrc/score_topk.cu`. Replaces the round prologue of
koordinator_tpu/scheduler/core.py schedule_batch (core.py:565-577 fit,
:675-684 quota admission, loadaware.score_matrix, :721-742 jitter, mask
and lax.top_k) without writing the [P, N] score matrix.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from koordinator_tpu_torch.api.extension import NUM_RESOURCES
from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check
from koordinator_tpu_torch.scheduler.plugins import loadaware

# the tie-break jitter step, float32 as the reference rounds it
JITTER = float(np.float32(0.49 / 1024.0))
MAX_K = 32


def tie_break_jitter(scores: torch.Tensor) -> torch.Tensor:
    """scores + h(p, n) * JITTER with one rounding, where
    h = (p * 2654435761 + n * 40503) mod 2^32 & 1023 (k8s selectHost's
    uniform choice among equal scores, made deterministic)."""
    p, n = scores.shape
    pi = torch.arange(p, dtype=torch.int64, device=scores.device)[:, None]
    ni = torch.arange(n, dtype=torch.int64, device=scores.device)[None, :]
    h = (pi * 2654435761 + ni * 40503) & 1023
    return loadaware.fma_f32(h.to(torch.float32), JITTER, scores)


def score_topk_plain(static_ok, row_ok, req_fit, requested_fit, alloc_fit,
                     est, prod_scored, node_term, prod_term, alloc_score,
                     fresh, weights, k: int, tie_break: bool,
                     eps: float, fma_sum: bool):
    """(val f32[P, k], idx i32[P, k]): the k best nodes of each pod by
    value descending then index ascending (lax.top_k's order), where a
    pair's value is its LoadAware score (+ jitter) if it passes the
    static gates, the row mask and the resource fit, else -1. `fma_sum`
    picks the rounding of the score's weighted sum
    (loadaware.weighted_sum)."""
    fit = torch.all(req_fit[:, None, :] + requested_fit[None]
                    <= alloc_fit[None] + eps, dim=-1)
    feasible = fit & static_ok & row_ok[:, None]
    scores = loadaware.least_requested_score(
        est, prod_scored, node_term, prod_term, alloc_score, fresh, weights,
        fma_sum)
    if tie_break:
        scores = tie_break_jitter(scores)
    masked = torch.where(feasible, scores, -1.0)
    val, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    return val[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def score_topk(static_ok, row_ok, req_fit, requested_fit, alloc_fit, est,
               prod_scored, node_term, prod_term, alloc_score, fresh,
               weights, k: int, tie_break: bool, eps: float,
               fma_sum: bool):
    """The selection of `score_topk_plain`: the kernel for CUDA tensors,
    the plain version for CPU tensors. Shapes: static_ok bool[P, N];
    row_ok, prod_scored bool[P]; req_fit f32[P, F]; requested_fit,
    alloc_fit f32[N, F]; est f32[P, D]; node_term, prod_term,
    alloc_score f32[N, D]; fresh bool[N]; weights f32[D]; k <= 32;
    F, D <= NUM_RESOURCES."""
    p, n = static_ok.shape
    f = req_fit.shape[1]
    d = est.shape[1]
    dev = static_ok.device
    for name, t, dt, shape in (
            ("static_ok", static_ok, torch.bool, (p, n)),
            ("row_ok", row_ok, torch.bool, (p,)),
            ("req_fit", req_fit, torch.float32, (p, f)),
            ("requested_fit", requested_fit, torch.float32, (n, f)),
            ("alloc_fit", alloc_fit, torch.float32, (n, f)),
            ("est", est, torch.float32, (p, d)),
            ("prod_scored", prod_scored, torch.bool, (p,)),
            ("node_term", node_term, torch.float32, (n, d)),
            ("prod_term", prod_term, torch.float32, (n, d)),
            ("alloc_score", alloc_score, torch.float32, (n, d)),
            ("fresh", fresh, torch.bool, (n,)),
            ("weights", weights, torch.float32, (d,))):
        _launch.check_tensor(name, t, dt, shape, dev)
    if not 0 < k <= min(n, MAX_K):
        raise ValueError(f"score_topk: k={k} must be in [1, min(N, {MAX_K})]")
    if max(f, d) > NUM_RESOURCES:
        raise ValueError(f"score_topk: F={f}, D={d} above {NUM_RESOURCES}")
    if dev.type == "cpu":
        return score_topk_plain(static_ok, row_ok, req_fit, requested_fit,
                                alloc_fit, est, prod_scored, node_term,
                                prod_term, alloc_score, fresh, weights, k,
                                tie_break, eps, fma_sum)
    if dev.type != "cuda":
        raise ValueError(f"score_topk: unsupported device {dev}")
    val = torch.empty((p, k), dtype=torch.float32, device=dev)
    idx = torch.empty((p, k), dtype=torch.int32, device=dev)
    fn = TOOLCHAIN.function("score_topk", "koord_score_topk",
                      [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                      + [ctypes.c_float] + [ctypes.c_void_p] * 3)
    rc = fn(*(_launch.ptr(t) for t in (
        static_ok, row_ok, req_fit, requested_fit, alloc_fit, est,
        prod_scored, node_term, prod_term, alloc_score, fresh, weights)),
        p, n, f, d, k, int(bool(tie_break)), int(bool(fma_sum)), eps,
        _launch.ptr(val), _launch.ptr(idx), _launch.stream(dev))
    check(rc, "score_topk")
    score_topk.launches += 1
    return val, idx


score_topk.launches = 0
