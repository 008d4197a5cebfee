"""The colocation overcommit engine: batch/mid extended-resource calculation
for every node in one batched program.

Behavior parity with pkg/slo-controller/noderesource (SURVEY.md 2.3):
- batchresource plugin (plugins/batchresource/plugin.go:164-316, util.go:38-90):
    Batch[usage]          = Capacity − NodeReserved − max(SystemUsed, SystemReserved) − HPUsed
    Batch[request]        = Capacity − NodeReserved − SystemReserved − HPRequest
    Batch[maxUsageRequest]= Capacity − NodeReserved − max(SystemUsed, SystemReserved) − HPMaxUsedReq
  where HP (high-priority) spans every pod whose PriorityClass is not
  Batch/Free; a HP pod without a reported metric is counted at its request;
  LSE pods count max(request-mix, usage); dangling pod metrics (reported but
  no longer in the pod list) count at usage.
- midresource plugin (plugins/midresource/plugin.go:83-160):
    Mid = min(ProdReclaimable, NodeAllocatable × midThresholdPercent/100)
- degrade (plugin.go:467-484): NodeMetric staler than degradeTimeMinutes →
  batch/mid reset (encoded as −1).
- NeedSync diff gate (plugin.go:101-112 + util.IsResourceDiff).

Counterpart of `koordinator_tpu/slo_controller/noderesource.py`. The
whole cluster is one [N, 2] calculation (columns cpu=millicores,
memory=MiB) recomputed every metric sync round: the host aggregates the
typed objects into columns (`build_inputs`), K19 `node_overcommit`
computes the batch and mid formulas on the card (the plain version on
the host), and the host applies the degrade and invalid resets (-1) and
the NeedSync diff gate, as the reference does around its jitted
formulas. The strategy's ratios are Python float divisions cast to f32
and `node_reserved` an f32 product on the host, so the kernel sees the
reference's bits.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.api.extension import (
    PriorityClass,
    QoSClass,
    ResourceKind,
)
from koordinator_tpu_torch.api.types import Node, NodeMetric, Pod
from koordinator_tpu_torch.kernels.node_overcommit import node_overcommit
from koordinator_tpu_torch.slo_controller.config import (
    CalculatePolicy,
    ColocationStrategy,
)
from koordinator_tpu_torch.slo_controller.metrics_defs import (
    SloControllerMetrics,
)

# Column order of the 2-dim resource axis used by this module.
CPU, MEM = 0, 1


@dataclasses.dataclass
class NodeResourceInputs:
    """Columnar inputs to the overcommit calculators, [N, 2] (cpu, mem).

    Host-aggregated from Node/NodeMetric/pod lists by `build_inputs`; the
    formulas run on K19.
    """

    capacity: np.ndarray          # f32[N, 2] node capacity
    allocatable: np.ndarray       # f32[N, 2] node allocatable
    system_used: np.ndarray       # f32[N, 2] NodeMetric systemUsage (+ HP host apps)
    system_reserved: np.ndarray   # f32[N, 2] max(kubelet reserved, node annotation)
    hp_request: np.ndarray        # f32[N, 2] Σ HP pod requests
    hp_used: np.ndarray           # f32[N, 2] Σ HP pod usages (req when no metric)
    hp_max_used_req: np.ndarray   # f32[N, 2] Σ max(req, usage) per HP pod
    prod_reclaimable: np.ndarray  # f32[N, 2] prediction (mid tier source)
    metric_age_seconds: np.ndarray  # f32[N] now − NodeMetric.updateTime (inf if none)
    valid: np.ndarray             # bool[N]
    names: Sequence[str] = ()     # node names (metric labels); "" rows OK


def _rl2(rl: Dict[ResourceKind, float]) -> np.ndarray:
    return np.array([rl.get(ResourceKind.CPU, 0.0),
                     rl.get(ResourceKind.MEMORY, 0.0)], np.float32)


def build_inputs(nodes: Sequence[Node],
                 metrics: Dict[str, NodeMetric],
                 pods_by_node: Dict[str, List[Pod]],
                 now: float,
                 node_reservations: Optional[Dict[str, Dict[ResourceKind, float]]] = None,
                 ) -> NodeResourceInputs:
    """Aggregate typed objects into calculator columns.

    Mirrors calculateOnNode's walk (batchresource/plugin.go:214-316): match
    pod-list entries against NodeMetric pod metrics, classify by priority
    class and QoS, and account dangling metrics.
    """
    n = len(nodes)
    z = lambda: np.zeros((n, 2), np.float32)
    cap, alloc, sys_used, sys_rsvd = z(), z(), z(), z()
    hp_req, hp_used, hp_max = z(), z(), z()
    reclaim = z()
    age = np.full((n,), np.inf, np.float32)
    valid = np.zeros((n,), bool)

    for i, node in enumerate(nodes):
        valid[i] = True
        alloc[i] = _rl2(node.allocatable)
        cap[i] = alloc[i]  # capacity ~= allocatable in canonical units
        if node_reservations and node.meta.name in node_reservations:
            sys_rsvd[i] = _rl2(node_reservations[node.meta.name])

        m = metrics.get(node.meta.name)
        pods = pods_by_node.get(node.meta.name, [])
        if m is None:
            # no metric: every HP pod counts at request; system unknown
            for pod in pods:
                if pod.phase not in ("Running", "Pending"):
                    continue
                if pod.priority_class in (PriorityClass.BATCH, PriorityClass.FREE):
                    continue
                r = _rl2(pod.requests)
                hp_req[i] += r
                hp_used[i] += r
                hp_max[i] += r
            continue

        age[i] = max(now - m.update_time, 0.0)
        sys_used[i] = _rl2(m.system_usage)
        reclaim[i] = _rl2(m.prod_reclaimable)
        pod_metrics = {pm.namespaced_name: pm for pm in m.pods_metric}
        dangling = dict(pod_metrics)

        for pod in pods:
            if pod.phase not in ("Running", "Pending"):
                continue
            key = pod.meta.namespaced_name
            pm = pod_metrics.get(key)
            if pm is not None:
                dangling.pop(key, None)
            if pod.priority_class in (PriorityClass.BATCH, PriorityClass.FREE):
                continue
            req = _rl2(pod.requests)
            hp_req[i] += req
            if pm is None:
                hp_used[i] += req  # not yet metered: count at request
            else:
                used = _rl2(pm.usage)
                if pod.qos is QoSClass.LSE:
                    # LSE never reclaims CPU: charge request on cpu, usage on mem
                    hp_used[i] += np.array([req[CPU], used[MEM]], np.float32)
                else:
                    hp_used[i] += used
                hp_max[i] += np.maximum(req, used)

        # dangling pod metrics: reported usage of pods no longer listed
        for pm in dangling.values():
            if pm.priority_class in (PriorityClass.BATCH, PriorityClass.FREE):
                continue
            used = _rl2(pm.usage)
            hp_used[i] += used
            hp_max[i] += used

    return NodeResourceInputs(
        capacity=cap, allocatable=alloc, system_used=sys_used,
        system_reserved=sys_rsvd, hp_request=hp_req, hp_used=hp_used,
        hp_max_used_req=hp_max, prod_reclaimable=reclaim,
        metric_age_seconds=age, valid=valid,
        names=[n.meta.name for n in nodes])


_MEM_POLICY_CODE = {CalculatePolicy.USAGE: 0, CalculatePolicy.REQUEST: 1,
                    CalculatePolicy.MAX_USAGE_REQUEST: 2}


def compute_node_resources(inputs: NodeResourceInputs,
                           strategy: ColocationStrategy,
                           strategies: Optional[Sequence[ColocationStrategy]] = None,
                           device="cuda") -> Dict[str, np.ndarray]:
    """Run the full overcommit calculation for every node: K19 on
    `device` (the plain version on the host), the resets on the host.

    `strategies`, when given, carries one (node-override-merged) strategy
    per node (ColocationConfig.strategy_for); thresholds and policies then
    vary per row. Returns {"batch": f32[N,2], "mid": f32[N,2],
    "degraded": bool[N]}; degraded rows carry -1 (the reference's Reset,
    plugin.go:153-162).
    """
    dev = resolve_device(device)
    n = inputs.capacity.shape[0]
    per_node = list(strategies) if strategies is not None else [strategy] * n
    if len(per_node) != n:
        raise ValueError(f"{len(per_node)} strategies for {n} nodes")

    # per-node, per-dim reclaim ratios -> node reservation
    reserve_ratio = np.array(
        [[(100.0 - s.cpu_reclaim_threshold_percent) / 100.0,
          (100.0 - s.memory_reclaim_threshold_percent) / 100.0]
         for s in per_node], np.float32).reshape(n, 2)
    node_reserved = inputs.capacity * reserve_ratio
    ratio = np.array([[s.mid_cpu_threshold_percent / 100.0,
                       s.mid_memory_threshold_percent / 100.0]
                      for s in per_node], np.float32).reshape(n, 2)
    cpu_by_max = np.array(
        [s.cpu_calculate_policy is CalculatePolicy.MAX_USAGE_REQUEST
         for s in per_node], bool)
    mem_policy = np.array(
        [_MEM_POLICY_CODE[s.memory_calculate_policy] for s in per_node],
        np.int32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    batch, mid = node_overcommit(
        t(inputs.capacity), t(node_reserved), t(inputs.system_reserved),
        t(inputs.system_used), t(inputs.hp_request), t(inputs.hp_used),
        t(inputs.hp_max_used_req), t(cpu_by_max), t(mem_policy),
        t(inputs.allocatable), t(inputs.prod_reclaimable), t(ratio))
    batch, mid = batch.cpu().numpy(), mid.cpu().numpy()

    degrade_secs = np.array([s.degrade_time_minutes * 60.0 for s in per_node],
                            np.float32)
    degraded = inputs.metric_age_seconds >= degrade_secs
    batch = np.where(degraded[:, None], -1.0, batch)
    mid = np.where(degraded[:, None], -1.0, mid)
    batch[~inputs.valid] = -1.0
    mid[~inputs.valid] = -1.0
    return {"batch": batch, "mid": mid, "degraded": degraded & inputs.valid}


def need_sync(old: np.ndarray, new: np.ndarray,
              diff_threshold: float) -> np.ndarray:
    """bool[N]: relative diff of any dim exceeds the threshold
    (util.IsResourceDiff semantics: |new−old| / max(old, 1) > threshold;
    resets (−1) always sync when the old value differs)."""
    denom = np.maximum(np.abs(old), 1.0)
    diff = np.abs(new - old) / denom
    return np.any((diff > diff_threshold) | ((new < 0) != (old < 0)), axis=-1)


@dataclasses.dataclass
class NodeResourceController:
    """The reconcile loop: recompute overcommit columns and emit per-node
    updates, applying the NeedSync diff gate. Host-side shell around K19
    (cmd/koord-manager noderesource controller); `device` is where the
    formulas run ("cpu" for the plain version). `timings` holds the last
    reconcile's seconds: the calculation and the gauge updates."""

    strategy: ColocationStrategy = dataclasses.field(
        default_factory=lambda: ColocationStrategy(enable=True))
    stats: Optional["SloControllerMetrics"] = None
    device: str = "cuda"
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    _last_batch: Optional[np.ndarray] = None
    _last_mid: Optional[np.ndarray] = None

    def reconcile(self, inputs: NodeResourceInputs,
                  strategies: Optional[Sequence[ColocationStrategy]] = None,
                  ) -> Dict[str, np.ndarray]:
        """Returns {"batch", "mid", "degraded", "sync_mask"}; callers fold
        `batch`/`mid` into Node allocatable (ResourceKind.BATCH_*/MID_*)
        for rows where sync_mask is set."""
        t0 = time.perf_counter()
        out = compute_node_resources(inputs, self.strategy, strategies,
                                     device=self.device)
        n = out["batch"].shape[0]
        if self._last_batch is None or self._last_batch.shape[0] != n:
            sync = np.ones((n,), bool)
            self._last_batch = out["batch"].copy()
            self._last_mid = out["mid"].copy()
        else:
            # honor per-node strategy overrides for the diff gate too, same
            # as the calculator does for the batch/mid math
            if strategies is not None:
                thr = np.asarray([s.resource_diff_threshold
                                  for s in strategies], np.float64)[:, None]
            else:
                thr = self.strategy.resource_diff_threshold
            sync = (need_sync(self._last_batch, out["batch"], thr)
                    | need_sync(self._last_mid, out["mid"], thr))
            # latch only rows that synced: the diff gate compares against the
            # last APPLIED value so sub-threshold drift accumulates until it
            # crosses the threshold (plugin.go NeedSync diffs vs node status)
            self._last_batch[sync] = out["batch"][sync]
            self._last_mid[sync] = out["mid"][sync]
        out["sync_mask"] = sync & inputs.valid
        t1 = time.perf_counter()
        if self.stats is None:
            self.stats = SloControllerMetrics()
        self.stats.node_resource_reconcile_count.labels("succeeded").inc()
        for plugin in ("batchresource", "midresource"):
            self.stats.node_resource_run_plugin_status.labels(
                plugin, "succeeded").inc()
        for i, name in enumerate(inputs.names):
            if not out["sync_mask"][i]:
                continue
            for tier, cols in (("batch", ((CPU, "batch-cpu"),
                                          (MEM, "batch-memory"))),
                               ("mid", ((CPU, "mid-cpu"),
                                        (MEM, "mid-memory")))):
                for col, kind in cols:
                    self.stats.node_extended_resource_allocatable.labels(
                        name, kind, "").set(float(out[tier][i, col]))
        self.timings = {"calculate_s": t1 - t0,
                        "gauges_s": time.perf_counter() - t1}
        return out
