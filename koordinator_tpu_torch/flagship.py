"""The slim score-and-bind flagship: a pending queue scheduled in chunks
against one node snapshot, then the straggler tail.

Counterpart of `bench.py` run_northstar(full_gate=False) in the JAX
package: 100k pods against 10k nodes by default, chunks of 2000 through
`schedule_batch` (2 rounds, 8 choices), then `tail_compaction_loop`
(retry windows of 512, 4 rounds, 32 choices, 2 to 6 passes). The
reference scans the chunks and loops the tail on device; here both are
Python loops, and the host reads the straggler counts once per tail
pass.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.scheduler.core import (
    schedule_batch,
    tail_compaction_loop,
)
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.snapshot.schema import ClusterSnapshot, PodBatch
from koordinator_tpu_torch.utils.synthetic import (
    slice_batch,
    synthetic_cluster,
    synthetic_pods,
)

METRIC = "score_bind_100k_pods_10k_nodes"
# the bench's sweep and tail programs (bench.py:400-405, :84-85)
STEP_KW = dict(num_rounds=2, k_choices=8, score_dims=(0, 1),
               tie_break=True, quota_depth=2, fit_dims=(0, 1, 2, 3),
               cascade=False, enable_numa=False)
TAIL_KW = dict(STEP_KW, num_rounds=4, k_choices=32)
MIN_TAIL_PASSES = 2
DEFAULT_MAX_TAIL_PASSES = 6
NUM_QUOTAS = 32


@dataclasses.dataclass
class FlagshipRun:
    snapshot: ClusterSnapshot
    assignment: torch.Tensor     # i32[P] node per pod, -1 = unplaced
    stats: torch.Tensor          # i32[4] after_sweep, final, never_retried,
                                 # passes


def sweep_and_tail(snap: ClusterSnapshot, pods: PodBatch,
                   cfg: LoadAwareConfig, chunk: int,
                   tail_chunk: int = None) -> FlagshipRun:
    """Schedule `pods` chunk by chunk, each chunk on the previous one's
    snapshot, then retry the stragglers in windows of `tail_chunk`
    (default min(chunk, 512))."""
    num = pods.num_pods
    if num % chunk:
        raise ValueError(f"{num} pods not divisible by chunk {chunk}")
    tail_chunk = min(chunk, 512) if tail_chunk is None else tail_chunk
    assigns = []
    for start in range(0, num, chunk):
        res = schedule_batch(snap, slice_batch(pods, start, chunk), cfg,
                             **STEP_KW)
        snap = res.snapshot
        assigns.append(res.assignment)
    snap, assign, stats = tail_compaction_loop(
        functools.partial(schedule_batch, **TAIL_KW), snap,
        torch.cat(assigns), pods, cfg, tail_chunk=tail_chunk,
        min_passes=MIN_TAIL_PASSES, max_passes=DEFAULT_MAX_TAIL_PASSES)
    return FlagshipRun(snapshot=snap, assignment=assign, stats=stats)


def run_northstar(num_pods: int = 100_000, num_nodes: int = 10_000,
                  chunk: int = 2000, device="cuda", snap_seed: int = 7):
    """Build the slim workload (pods seed 1, snapshot `snap_seed`, 32
    quotas), time one sweep-and-tail on it, and return (line, run):
    `line` holds the bench line's fields (value = seconds of the timed
    region, pods_per_sec, placed, stragglers_after_sweep,
    stragglers_final, never_retried, tail_passes) and the device it ran
    on; `run` the final snapshot and assignment. The timed region ends
    with the assignment's readback, as the bench's does; the first call
    on a card also pays the kernels' build unless `kernels.build.
    build_all()` ran before."""
    dev = resolve_device(device)
    pods = synthetic_pods(num_pods, seed=1, num_quotas=NUM_QUOTAS, device=dev)
    snap = synthetic_cluster(num_nodes, seed=snap_seed, num_quotas=NUM_QUOTAS,
                             device=dev)
    cfg = LoadAwareConfig.make(device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    run = sweep_and_tail(snap, pods, cfg, chunk)
    assign = run.assignment.cpu()
    elapsed = time.perf_counter() - t0
    stats = [int(x) for x in run.stats]
    line = {
        "metric": METRIC,
        "value": elapsed,
        "pods_per_sec": num_pods / elapsed,
        "placed": int((assign >= 0).sum()),
        "stragglers_after_sweep": stats[0],
        "stragglers_final": stats[1],
        "never_retried": stats[2],
        "tail_passes": stats[3],
        "num_pods": num_pods,
        "num_nodes": num_nodes,
        "chunk": chunk,
        "platform": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    return line, run

