"""BASELINE configurations beside the flagship.

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
"""

from __future__ import annotations

import dataclasses
import time

import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.scheduler.core import schedule_batch
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.snapshot.schema import ClusterSnapshot, PodBatch
from koordinator_tpu_torch.utils.synthetic import config_2_inputs, slice_batch

CONFIG_2_METRIC = "baseline_cfg2_numa_10kx1k"
# bench_configs._run_scheduler_config's step
CONFIG_2_KW = dict(num_rounds=2, k_choices=8, score_dims=(0, 1),
                   tie_break=True, quota_depth=2, fit_dims=(0, 1, 2, 3),
                   cascade=False, enable_numa=True, numa_strategy="most")


@dataclasses.dataclass
class SweepRun:
    snapshot: ClusterSnapshot
    assignment: torch.Tensor     # i32[P] node per pod, -1 = unplaced
    numa_zone: torch.Tensor      # i32[P]
    numa_take: torch.Tensor      # f32[P, Z, 2]


def numa_sweep(snap: ClusterSnapshot, pods: PodBatch, cfg: LoadAwareConfig,
               chunk: int) -> SweepRun:
    """Schedule `pods` chunk by chunk with the NUMA path, each chunk on
    the previous one's snapshot."""
    num = pods.num_pods
    if num % chunk:
        raise ValueError(f"{num} pods not divisible by chunk {chunk}")
    results = []
    for start in range(0, num, chunk):
        res = schedule_batch(snap, slice_batch(pods, start, chunk), cfg,
                             **CONFIG_2_KW)
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
    run = numa_sweep(snap, pods, cfg, chunk)
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
