"""LowNodeLoad balance plugin on the host: the port's copy of
`koordinator_tpu/descheduler/lownodeload.py`.

Classify nodes by ACTUAL usage (NodeMetric) against low/high
thresholds, then migrate pods off overutilized nodes until they fall
under the high threshold, bounded by the spare capacity of the
underutilized destinations (framework/plugins/loadaware/
{low_node_load.go,utilization_util.go}):
- classification: a node is UNDERutilized when every resource's usage%%
  is below the low threshold, OVERutilized when any exceeds the high
  threshold;
- deviation thresholds: low/high become cluster-average +- threshold;
- anomaly gating: a node must be overutilized `consecutive_abnormalities`
  detections in a row before eviction starts;
- budget: sum over destination nodes of (high_threshold_abs - usage) per
  resource; eviction stops when any dimension is exhausted or the source
  node falls under the high threshold;
- ordering: source nodes and their removable pods by weighted usage,
  descending;
- node_fit: a removable pod must fit (requests vs allocatable-requested)
  on at least one destination node.

`balance_once` walks the source nodes and their pods one by one: the
golden the device plan (lownodeload_device.py) is held against.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from koordinator_tpu_torch.api import types as api
from koordinator_tpu_torch.api.extension import NUM_RESOURCES, ResourceKind
from koordinator_tpu_torch.descheduler.framework import Evictor
from koordinator_tpu_torch.snapshot.builder import resource_vec


@dataclasses.dataclass
class LowNodeLoadArgs:
    """LowNodeLoadArgs (descheduler/apis/config/types.go): the fields the
    balance pass consumes, with the reference's defaults."""

    low_thresholds: Dict[ResourceKind, float] = dataclasses.field(
        default_factory=lambda: {ResourceKind.CPU: 45.0,
                                 ResourceKind.MEMORY: 60.0})
    high_thresholds: Dict[ResourceKind, float] = dataclasses.field(
        default_factory=lambda: {ResourceKind.CPU: 65.0,
                                 ResourceKind.MEMORY: 80.0})
    use_deviation_thresholds: bool = False
    resource_weights: Dict[ResourceKind, float] = dataclasses.field(
        default_factory=lambda: {ResourceKind.CPU: 1.0,
                                 ResourceKind.MEMORY: 1.0})
    # LoadAnomalyCondition: this many consecutive overutilized detections
    # before eviction kicks in (default 5)
    consecutive_abnormalities: int = 5
    node_fit: bool = True
    node_metric_expiration_seconds: float = 180.0
    dry_run: bool = False
    # pods the default evictor refuses (defaultevictor subset)
    pod_filter: Optional[Callable[[api.Pod], bool]] = None


def _usage_pct(usage: np.ndarray, capacity: np.ndarray) -> np.ndarray:
    return 100.0 * usage / np.maximum(capacity, 1e-9)


class LowNodeLoad:
    """The Balance plugin. Stateful only for the anomaly counters.

    For the CycleRunner loop, inject the cluster-state providers
    (`get_metrics`, `get_pods_by_node`, `now_fn`) and the runner drives
    `balance(nodes)`; `balance_once` is the explicit-arguments form.
    """

    name = "LowNodeLoad"

    def __init__(self, args: Optional[LowNodeLoadArgs] = None,
                 evictor: Optional[Evictor] = None,
                 get_metrics: Optional[
                     Callable[[], Mapping[str, api.NodeMetric]]] = None,
                 get_pods_by_node: Optional[
                     Callable[[], Mapping[str, Sequence[api.Pod]]]] = None,
                 now_fn: Optional[Callable[[], float]] = None):
        self.args = args or LowNodeLoadArgs()
        self.evictor = evictor
        self.get_metrics = get_metrics
        self.get_pods_by_node = get_pods_by_node
        self.now_fn = now_fn
        self._abnormal_counts: Dict[str, int] = {}

    def balance(self, nodes: Sequence[api.Node]) -> None:
        """BalancePlugin protocol entry (framework.CycleRunner)."""
        if self.get_metrics is None or self.get_pods_by_node is None:
            raise RuntimeError(
                "LowNodeLoad.balance needs get_metrics/get_pods_by_node "
                "providers; use balance_once for explicit arguments")
        import time
        now = self.now_fn() if self.now_fn is not None else time.time()
        self.balance_once(nodes, self.get_metrics(),
                          self.get_pods_by_node(), now)

    # -- classification (vectorized) ----------------------------------------

    def node_columns(self, nodes: Sequence[api.Node],
                     metrics: Mapping[str, api.NodeMetric],
                     now: float) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
        """One flattening pass: (usage [N,R], capacity [N,R], fresh [N]);
        nodes with missing/expired NodeMetric are not fresh. Shared with
        the device path so the typed->columnar work happens once."""
        args = self.args
        n = len(nodes)
        usage = np.zeros((n, NUM_RESOURCES), np.float32)
        capacity = np.zeros((n, NUM_RESOURCES), np.float32)
        fresh = np.zeros((n,), bool)
        for i, node in enumerate(nodes):
            capacity[i] = resource_vec(node.allocatable)
            m = metrics.get(node.meta.name)
            if m is not None and not m.is_expired(
                    args.node_metric_expiration_seconds, now):
                usage[i] = resource_vec(m.node_usage)
                fresh[i] = True
        return usage, capacity, fresh

    def classify(self, nodes: Sequence[api.Node],
                 metrics: Mapping[str, api.NodeMetric],
                 now: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray, List[int]]:
        """Returns (usage [N,R], capacity [N,R], low_mask [N], high_mask
        [N], rdims) over the given nodes."""
        return self.classify_columns(
            *self.node_columns(nodes, metrics, now))

    def classify_columns(self, usage: np.ndarray, capacity: np.ndarray,
                         fresh: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray, List[int]]:
        """The threshold math over prebuilt columns."""
        args = self.args
        rdims = sorted({int(k) for k in args.high_thresholds})
        pct = _usage_pct(usage, capacity)

        low = np.array([args.low_thresholds.get(ResourceKind(d), 0.0)
                        for d in rdims], np.float32)
        high = np.array([args.high_thresholds.get(ResourceKind(d), 100.0)
                         for d in rdims], np.float32)
        if args.use_deviation_thresholds:
            avg = pct[fresh][:, rdims].mean(axis=0) if fresh.any() else \
                np.zeros_like(low)
            low = np.clip(avg - low, 0.0, 100.0)
            high = np.clip(avg + high, 0.0, 100.0)
        sel = pct[:, rdims]
        low_mask = fresh & (sel < low[None, :]).all(axis=1)
        high_mask = fresh & (sel > high[None, :]).any(axis=1)
        self._high_abs = capacity[:, rdims] * high[None, :] / 100.0
        return usage, capacity, low_mask, high_mask, rdims

    # -- anomaly gating ------------------------------------------------------

    def _gate_anomalies(self, names: Sequence[str],
                        high_mask: np.ndarray) -> np.ndarray:
        """Track consecutive overutilized detections per node; only nodes
        past the threshold are eviction sources. Normal nodes reset."""
        out = np.zeros_like(high_mask)
        for i, name in enumerate(names):
            if high_mask[i]:
                c = self._abnormal_counts.get(name, 0) + 1
                self._abnormal_counts[name] = c
                out[i] = c >= self.args.consecutive_abnormalities
            else:
                self._abnormal_counts.pop(name, None)
        return out

    # -- the balance pass ----------------------------------------------------

    def balance_once(self, nodes: Sequence[api.Node],
                     metrics: Mapping[str, api.NodeMetric],
                     pods_by_node: Mapping[str, Sequence[api.Pod]],
                     now: float) -> List[api.Pod]:
        """One Balance invocation; returns the pods selected for migration
        (already offered to the evictor unless dry_run)."""
        args = self.args
        if not nodes:
            return []
        usage, capacity, low_mask, high_mask, rdims = self.classify(
            nodes, metrics, now)
        names = [nd.meta.name for nd in nodes]
        source_mask = self._gate_anomalies(names, high_mask)
        if not low_mask.any() or not source_mask.any():
            return []

        # pod usage per node from the NodeMetric pod breakdown; fall back
        # to requests when a pod has no reported usage
        pod_usage: Dict[str, np.ndarray] = {}
        for name in names:
            m = metrics.get(name)
            if m is not None:
                for pm in m.pods_metric:
                    pod_usage[pm.namespaced_name] = resource_vec(pm.usage)

        # budget: spare headroom under the HIGH threshold of destinations
        budget = (self._high_abs[low_mask] - usage[low_mask][:, rdims]) \
            .sum(axis=0)

        # destination free room for node_fit (allocatable - sum requests)
        dest_free = []
        for i in np.nonzero(low_mask)[0]:
            reqs = sum((resource_vec(p.requests)
                        for p in pods_by_node.get(names[i], [])),
                       np.zeros(NUM_RESOURCES, np.float32))
            dest_free.append(capacity[i] - reqs)

        weights = np.zeros((len(rdims),), np.float32)
        for j, d in enumerate(rdims):
            weights[j] = args.resource_weights.get(ResourceKind(d), 0.0)

        def weighted(vec_r: np.ndarray) -> float:
            return float((vec_r * weights).sum())

        # source nodes by weighted usage%, descending
        pct = _usage_pct(usage, capacity)
        src_order = sorted(np.nonzero(source_mask)[0].tolist(),
                           key=lambda i: -weighted(pct[i, rdims]))

        selected: List[api.Pod] = []
        for i in src_order:
            node_usage_r = usage[i, rdims].copy()
            high_abs = self._high_abs[i]
            removable = []
            for pod in pods_by_node.get(names[i], []):
                if pod.is_daemonset:
                    continue
                if args.pod_filter is not None and not args.pod_filter(pod):
                    continue
                if args.node_fit:
                    req = resource_vec(pod.requests)
                    if not any((req <= f + 0.5).all() for f in dest_free):
                        continue
                removable.append(pod)
            if not removable:
                continue
            removable.sort(key=lambda p: -weighted(
                pod_usage.get(p.meta.namespaced_name,
                              resource_vec(p.requests))[rdims]))
            for pod in removable:
                still_over = (node_usage_r > high_abs).any()
                if not still_over or (budget <= 0).any():
                    break
                if not args.dry_run and self.evictor is not None:
                    if not self.evictor.evict(
                            pod, f"node {names[i]} is overutilized"):
                        continue
                u = pod_usage.get(pod.meta.namespaced_name,
                                  resource_vec(pod.requests))[rdims]
                node_usage_r -= u
                budget -= u
                selected.append(pod)
        return selected
