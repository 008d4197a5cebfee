#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`koordinator_tpu_torch/`).

    python3 chip_smoke.py

needs one CUDA card (sm_90a: an H100) and nvcc; it builds the kernels
from `koordinator_tpu_torch/csrc/` into `build/kernels/` first. Phases,
in order:

1. device: the card's name and power limit, and the kernels' build time;
2. kernels: each of K1 score_topk, K2 segment_prefix_ok and
   K3 ordered_scatter_add against its plain PyTorch version on the card,
   at the flagship's shapes, required equal (K1 values and indices, K2
   bools, K3 bit for bit), with its time, the plain version's, one
   library call's and the card's lower bound for the same work;
3. slice equality: the slim flagship at 8000 pods x 1000 nodes on the
   card against the plain path on the host: equal assignments;
4. flagship: the slim flagship at 100 000 pods x 10 000 nodes, chunk
   2000, on the card, after a warm-up run: the bench line, every
   kernel's launch count in the measured run (each must be > 0), peak
   device memory, and the invariants (no overcommit, quota used within
   runtime, every straggler retried).

The last two lines are one JSON object listing the kernels and one
stating the result. Without a CUDA device it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from koordinator_tpu_torch import kernels, resolve_device
from koordinator_tpu_torch.flagship import run_northstar, sweep_and_tail
from koordinator_tpu_torch.kernels.build import build_all
from koordinator_tpu_torch.kernels.scatter import (
    ordered_scatter_add,
    ordered_scatter_add_plain,
)
from koordinator_tpu_torch.kernels.score_topk import (
    score_topk,
    score_topk_plain,
    tie_break_jitter,
)
from koordinator_tpu_torch.kernels.segment_prefix import (
    segment_prefix_ok,
    segment_prefix_ok_plain,
)
from koordinator_tpu_torch.scheduler.batching import EPS, rank_by_priority
from koordinator_tpu_torch.scheduler.cascade import static_gates
from koordinator_tpu_torch.scheduler.core import overcommit_ok, quota_ok
from koordinator_tpu_torch.scheduler.plugins import deviceshare, loadaware
from koordinator_tpu_torch.utils.synthetic import (
    slice_batch,
    synthetic_cluster,
    synthetic_pods,
)

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s
# and f32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
FIT_DIMS = [0, 1, 2, 3]
SCORE_DIMS = [0, 1]
SOURCES = {
    "score_topk": ("koordinator_tpu_torch/csrc/score_topk.cu",
                   "koordinator_tpu/scheduler/core.py:721"),
    "segment_prefix_ok": ("koordinator_tpu_torch/csrc/segment_prefix_ok.cu",
                          "koordinator_tpu/scheduler/batching.py:45"),
    "ordered_scatter_add": (
        "koordinator_tpu_torch/csrc/ordered_scatter_add.cu",
        "koordinator_tpu/scheduler/core.py:1109"),
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


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def loaded_state(dev, gen):
    """The flagship's first chunk against a snapshot whose nodes and
    quotas are partly filled (integer-valued loads, as commits leave
    them; non-integer estimates)."""
    snap = synthetic_cluster(10_000, seed=0, num_quotas=32, device=dev)
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


def k1_case(snap, pods, cfg, p0, p, k, gen):
    """K1's arguments for pods [p0, p0 + p), as schedule_batch forms
    them, with 90 % of the rows active."""
    dev = snap.nodes.allocatable.device
    batch = slice_batch(pods, p0, p)
    static_ok, _ = static_gates(snap.nodes, batch, cfg)
    static_ok = (static_ok & deviceshare.prefilter(snap.devices, batch)
                 ).contiguous()
    node_term, prod_term, alloc_s, weights = loadaware.score_terms(
        snap.nodes, cfg, tuple(SCORE_DIMS))
    row_ok = torch.rand((p,), generator=gen, device=dev) < 0.9
    return dict(
        static_ok=static_ok, row_ok=row_ok,
        req_fit=batch.requests[:, FIT_DIMS].contiguous(),
        requested_fit=snap.nodes.requested[:, FIT_DIMS].contiguous(),
        alloc_fit=snap.nodes.allocatable[:, FIT_DIMS].contiguous(),
        est=batch.estimated[:, SCORE_DIMS].contiguous(),
        prod_scored=loadaware.prod_scored(batch, cfg),
        node_term=node_term, prod_term=prod_term, alloc_score=alloc_s,
        fresh=snap.nodes.metric_fresh, weights=weights, k=k,
        tie_break=True, eps=EPS)


def check_k1(snap, pods, cfg, gen):
    """K1 at the sweep's shape (P=2000, k=8) and the tail's (P=512,
    k=32)."""
    out = {}
    for label, p0, p, k in (("sweep", 0, 2000, 8), ("tail", 2000, 512, 32)):
        kw = k1_case(snap, pods, cfg, p0, p, k, gen)
        got = score_topk(**kw)
        want = score_topk_plain(**kw)
        err = float((got[0] - want[0]).abs().max())
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            bad = (got[1] != want[1]).any(dim=1).nonzero()[:5, 0].tolist()
            raise SystemExit(f"K1 score_topk ({label}) differs from its "
                             f"plain version; rows {bad}")
        n = kw["static_ok"].shape[1]
        f, d = len(FIT_DIMS), len(SCORE_DIMS)
        checked = kw["static_ok"] & kw["row_ok"][:, None]
        fit = torch.all(kw["req_fit"][:, None, :] + kw["requested_fit"][None]
                        <= kw["alloc_fit"][None] + EPS, dim=-1)
        n_rows = int(kw["row_ok"].sum())
        n_checked = int(checked.sum())
        n_feasible = int((checked & fit).sum())
        # inactive rows read nothing of static_ok; per-node terms
        # (alloc + eps, the clamped capacity, cap > 0) count once a node
        nbytes = n_rows * n + p * (f + d) * 4 + 2 * p \
            + n * (2 * f + 3 * d) * 4 + n + d * 4 + p * k * 8
        ops = n_rows * n + n_checked * 2 * f + n * (f + 2 * d) \
            + n_feasible * (8 * d + 4)
        b_ms, b_by = bound(nbytes, ops)
        masked = torch.where(checked & fit, tie_break_jitter(
            loadaware.least_requested_score(
                kw["est"], kw["prod_scored"], kw["node_term"],
                kw["prod_term"], kw["alloc_score"], kw["fresh"],
                kw["weights"])), -1.0)
        out[label] = dict(
            ms=cuda_ms(lambda: score_topk(**kw)),
            plain_ms=cuda_ms(lambda: score_topk_plain(**kw), reps=3),
            library_ms=cuda_ms(lambda: torch.topk(masked, k, dim=1)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"P={p} N={n} k={k}", feasible_pairs=n_feasible)
        score_topk.launches = 0
    return out


def check_k2(snap, pods, gen):
    """K2 at P=2000 with node segments and with quota segments."""
    dev = snap.nodes.allocatable.device
    batch = slice_batch(pods, 0, 2000)
    p = batch.num_pods
    rank = rank_by_priority(batch)
    n_nodes, n_quotas = snap.num_nodes, snap.quotas.min.shape[0]
    drop = torch.rand((p,), generator=gen, device=dev) < 0.3
    node_seg = torch.where(
        drop, n_nodes,
        torch.randint(0, 64, (p,), generator=gen, device=dev)
    ).to(torch.int32)
    quota_seg = torch.where(drop, n_quotas, torch.where(
        torch.rand((p,), generator=gen, device=dev) < 0.5, 0,
        batch.quota_id)).to(torch.int32)
    req = batch.requests[:, FIT_DIMS].contiguous()
    out = {}
    for label, seg, base, limit, s in (
            ("node", node_seg, snap.nodes.requested, snap.nodes.allocatable,
             n_nodes),
            ("quota", quota_seg, snap.quotas.used, snap.quotas.runtime,
             n_quotas)):
        args = (seg, rank, torch.where((seg < s)[:, None], req, 0.0),
                base[:, FIT_DIMS].contiguous(),
                limit[:, FIT_DIMS].contiguous(), s, EPS)
        got = segment_prefix_ok(*args)
        want = segment_prefix_ok_plain(*args)
        err = float((got.int() - want.int()).abs().max())
        if not torch.equal(got, want):
            raise SystemExit(f"K2 segment_prefix_ok ({label}) differs from "
                             f"its plain version at "
                             f"{(got != want).nonzero()[:5, 0].tolist()}")
        r = len(FIT_DIMS)
        inr = seg < s
        mask = (seg[:, None] == seg[None, :]) & (rank[None, :] < rank[:, None])
        matched = int((mask & inr[:, None]).sum())
        n_in = int(inr.sum())
        # base and limit: only the rows of the segments in range
        n_seg = int(torch.unique(seg[inr]).numel())
        nbytes = p * (8 + 4 * r + 1) + 2 * n_seg * r * 4
        ops = n_in * p * 2 + matched * r + n_in * r * 3
        b_ms, b_by = bound(nbytes, ops)
        mask_f = mask.to(torch.float32)
        out[label] = dict(
            ms=cuda_ms(lambda: segment_prefix_ok(*args)),
            plain_ms=cuda_ms(lambda: segment_prefix_ok_plain(*args)),
            library_ms=cuda_ms(lambda: mask_f @ args[2]),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            shape=f"P={p} S={s} R={r}", segments=n_seg, rejected=int((~got).sum()))
        segment_prefix_ok.launches = 0
    return out


def check_k3(dev, gen):
    """K3 at P=2000 rows into 10^4 targets; the plain version runs on
    the host, whose index_add_ adds in order (the card's uses atomics)."""
    s, c, p = 10_000, 11, 2000
    target = torch.rand((s, c), generator=gen, device=dev) * 5000.0
    idx = torch.randint(0, s + 1, (p,), generator=gen, device=dev)
    idx = torch.where(torch.rand((p,), generator=gen, device=dev) < 0.5,
                      idx % 200, idx).to(torch.int32)     # repeats + drops
    rows = torch.rand((p, c), generator=gen, device=dev) * 3000.0 + 0.1
    got = ordered_scatter_add(target, idx, rows)
    want = ordered_scatter_add_plain(target.cpu(), idx.cpu(), rows.cpu())
    err = float((got.cpu() - want).abs().max())
    if not torch.equal(got.cpu(), want):
        raise SystemExit(f"K3 ordered_scatter_add differs from its plain "
                         f"version on the host, max abs err {err}")
    keep = idx < s
    idx_k, rows_k = idx[keep].long(), rows[keep]
    nbytes = 2 * s * c * 4 + p * 4 + p * c * 4
    b_ms, b_by = bound(nbytes, int(keep.sum()) * c)
    out = dict(
        ms=cuda_ms(lambda: ordered_scatter_add(target, idx, rows)),
        plain_ms=cuda_ms(lambda: ordered_scatter_add_plain(target, idx, rows)),
        library_ms=cuda_ms(lambda: target.clone().index_add_(0, idx_k, rows_k)),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        shape=f"P={p} S={s} C={c}")
    ordered_scatter_add.launches = 0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    tc = build_all()
    print(f"build: {tc.build_s:.1f} s for {len(tc.libs)} kernels", flush=True)
    for name, log in tc.ptxas.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    # --- 2. kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    snap, pods = loaded_state(dev, gen)
    cfg = loadaware.LoadAwareConfig.make(device=dev)
    k1 = check_k1(snap, pods, cfg, gen)
    k2 = check_k2(snap, pods, gen)
    k3 = check_k3(dev, gen)
    for name, res in (("score_topk", k1), ("segment_prefix_ok", k2)):
        for label, r in res.items():
            print(f"kernel {name} [{label}]: " + json.dumps(r), flush=True)
    print("kernel ordered_scatter_add: " + json.dumps(k3), flush=True)

    # --- 3. slice equality: the card against the host --------------------
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

    # --- 4. the flagship at 100k x 10k ------------------------------------
    warm, _ = run_northstar(device="cuda", snap_seed=0)
    print("flagship warm-up: " + json.dumps(warm), flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    line, run = run_northstar(device="cuda", snap_seed=7)
    launches = kernels.launch_counts()
    line["launches"] = launches
    line["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    print("flagship: " + json.dumps(line), flush=True)
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the path never launched: {launches}")
    if not overcommit_ok(run.snapshot):
        raise SystemExit("overcommit: requested exceeds allocatable")
    if not quota_ok(run.snapshot):
        raise SystemExit("quota used exceeds runtime")
    if line["never_retried"] != 0:
        raise SystemExit(f"{line['never_retried']} stragglers never retried")
    if not 0 < line["placed"] <= 100_000:
        raise SystemExit(f"placed {line['placed']} pods")

    timings = {"score_topk": k1["sweep"], "segment_prefix_ok": k2["node"],
               "ordered_scatter_add": k3}
    report = []
    for name, r in timings.items():
        source, replaces = SOURCES[name]
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
