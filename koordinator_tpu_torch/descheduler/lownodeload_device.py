"""The LowNodeLoad balance plan on the card (BASELINE config 5).

The port of koordinator_tpu/descheduler/lownodeload_device.py. The host
plugin (lownodeload.py) walks source nodes and their pods one by one;
that greedy is prefix-structured, so the plan runs as a few passes over
columns:
- within one source node, pods go in sorted order while the node is
  still over its high threshold: the evicted set is a prefix of the
  node's sorted pods (a segment prefix sum);
- across nodes, the destination budget only falls and the reference
  stops at the first exhausted dimension: "budget still open" is a
  prefix along the global order too, as is the per-cycle cap.

`_plan_prelude` is K11 `lnl_eviction_order` (classification, budget,
the global order) and K10 `lnl_node_fit` (each pod must fit some
underutilized node); `plan_kernel` adds K12 `lnl_plan_prefix`, and
`plan_kernel_capped` K13 `lnl_plan_capped`, which replays the
EvictionLimiter's per-node / per-namespace / per-cycle skip-and-continue
in one walk along the order. The host keeps the typed->columnar
flattening, the anomaly counters (stateful across cycles) and offering
the planned pods to the evictor.

Narrowing (as the reference): the device plans predict the
EvictionLimiter exactly; a custom evictor that refuses other pods is
honored by filtering the selection on evict()'s result, but refusals do
not re-plan.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.api import types as api
from koordinator_tpu_torch.api.extension import NUM_RESOURCES, ResourceKind
from koordinator_tpu_torch.descheduler.lownodeload import (
    LowNodeLoad,
    LowNodeLoadArgs,
)
from koordinator_tpu_torch.kernels.lownodeload import (
    lnl_eviction_order,
    lnl_node_fit,
    lnl_plan_capped,
    lnl_plan_prefix,
)
from koordinator_tpu_torch.snapshot.builder import resource_vec


def _plan_prelude(usage, capacity, fresh, source_mask, pod_node,
                  pod_usage_r, pod_req, pod_eligible, low, high, weights,
                  rdims_onehot, use_deviation: bool, node_fit: bool,
                  fit_dims):
    """Shared front half of both plans: (active, order, budget0,
    high_abs, usage_sel). `rdims_onehot` must hold one 1.0 a row and
    zeros elsewhere (as `columnarize` builds it; ValueError otherwise):
    the threshold dims are its rows' argmax."""
    one_hot = (((rdims_onehot == 0) | (rdims_onehot == 1)).all()
               & ((rdims_onehot == 1).sum(dim=1) == 1).all())
    if not bool(one_hot):
        raise ValueError("rdims_onehot: each row must hold one 1.0 and "
                         "zeros elsewhere")
    rdims = rdims_onehot.argmax(dim=1).to(torch.int32)
    eo = lnl_eviction_order(usage, capacity, fresh, source_mask, pod_node,
                            pod_usage_r, pod_eligible, low, high, weights,
                            rdims, use_deviation)
    active = eo.active
    if node_fit:
        active = active & lnl_node_fit(pod_req, pod_node, capacity,
                                       eo.low_mask, fit_dims)
    return active, eo.order, eo.budget0, eo.high_abs, eo.usage_sel


def plan_kernel(usage, capacity, fresh, source_mask, pod_node, pod_usage_r,
                pod_req, pod_eligible, low, high, weights, rdims_onehot,
                max_evictions, use_deviation: bool = False,
                node_fit: bool = True, fit_dims: tuple = None):
    """The uncapped balance plan. Shapes: usage/capacity f32[N, R];
    pod_* over P pods with pod_usage_r f32[P, Rd] already restricted to
    the threshold dims; rdims_onehot f32[Rd, R] selects those dims;
    low/high/weights f32[Rd]; every tensor on one device. Returns
    (take bool[P], order i32[P]): the plan is
    `[int(i) for i in order if take[i]]`."""
    active, order, budget0, high_abs, usage_sel = _plan_prelude(
        usage, capacity, fresh, source_mask, pod_node, pod_usage_r,
        pod_req, pod_eligible, low, high, weights, rdims_onehot,
        use_deviation, node_fit, fit_dims)
    take = lnl_plan_prefix(order, active, pod_node, pod_usage_r, usage_sel,
                           high_abs, budget0, int(max_evictions))
    return take, order


def plan_kernel_capped(usage, capacity, fresh, source_mask, pod_node,
                       pod_usage_r, pod_req, pod_eligible, low, high,
                       weights, rdims_onehot, pod_ns, ns_counts0, per_node0,
                       max_evictions, max_per_node, max_per_ns,
                       use_deviation: bool = False, node_fit: bool = True,
                       fit_dims: tuple = None):
    """The balance plan under per-node / per-namespace / per-cycle caps:
    the limiter's exact decision sequence along the global order (a
    refused pod subtracts nothing and the walk goes on). pod_ns i32[P]
    indexes ns_counts0 i32[NS] (padded to a power of two);
    `per_node0[n]` and `ns_counts0` seed the counts from a limiter
    already part-used. Returns (take, order) like plan_kernel."""
    active, order, budget0, high_abs, usage_sel = _plan_prelude(
        usage, capacity, fresh, source_mask, pod_node, pod_usage_r,
        pod_req, pod_eligible, low, high, weights, rdims_onehot,
        use_deviation, node_fit, fit_dims)
    take = lnl_plan_capped(order, active, pod_node, pod_usage_r, usage_sel,
                           high_abs, budget0, pod_ns, ns_counts0, per_node0,
                           int(max_evictions), int(max_per_node),
                           int(max_per_ns))
    return take, order


def _pad_pow2(n: int, lo: int = 8) -> int:
    k = lo
    while k < n:
        k *= 2
    return k


def columnarize(nodes: Sequence[api.Node],
                metrics: Mapping[str, api.NodeMetric],
                pods_by_node: Mapping[str, Sequence[api.Pod]],
                args: LowNodeLoadArgs,
                usage: np.ndarray, capacity: np.ndarray,
                fresh: np.ndarray) -> Optional[dict]:
    """Typed host objects -> the plan's pod columns, in numpy (the node
    columns come in prebuilt from LowNodeLoad.node_columns). Pod usage
    is collected from EVERY NodeMetric, expired or not, as the host
    plugin does (only node freshness gates classification)."""
    rdims = sorted({int(k) for k in args.high_thresholds})
    name_to_idx = {node.meta.name: i for i, node in enumerate(nodes)}
    pod_usage_map: Dict[str, np.ndarray] = {}
    for name in name_to_idx:
        m = metrics.get(name)
        if m is not None:
            for pm in m.pods_metric:
                pod_usage_map[pm.namespaced_name] = resource_vec(pm.usage)

    pods: List[api.Pod] = []
    pod_node_l: List[int] = []
    for name, plist in pods_by_node.items():
        i = name_to_idx.get(name)
        if i is None:
            continue
        for pod in plist:
            pods.append(pod)
            pod_node_l.append(i)
    p = len(pods)
    if p == 0:
        return None
    pod_node = np.asarray(pod_node_l, np.int32)
    pod_req = np.zeros((p, NUM_RESOURCES), np.float32)
    pod_usage_r = np.zeros((p, len(rdims)), np.float32)
    pod_eligible = np.zeros((p,), bool)
    for j, pod in enumerate(pods):
        pod_req[j] = resource_vec(pod.requests)
        u = pod_usage_map.get(pod.meta.namespaced_name)
        if u is None:
            u = pod_req[j]
        pod_usage_r[j] = u[rdims]
        pod_eligible[j] = not pod.is_daemonset and (
            args.pod_filter is None or args.pod_filter(pod))

    low = np.array([args.low_thresholds.get(ResourceKind(d), 0.0)
                    for d in rdims], np.float32)
    high = np.array([args.high_thresholds.get(ResourceKind(d), 100.0)
                     for d in rdims], np.float32)
    weights = np.array([args.resource_weights.get(ResourceKind(d), 0.0)
                        for d in rdims], np.float32)
    rdims_onehot = np.zeros((len(rdims), NUM_RESOURCES), np.float32)
    rdims_onehot[np.arange(len(rdims)), rdims] = 1.0
    fit_dims = tuple(int(d) for d in np.flatnonzero(pod_req.any(0)))
    return dict(usage=usage, capacity=capacity, fresh=fresh,
                pod_node=pod_node, pod_usage_r=pod_usage_r,
                pod_req=pod_req, pod_eligible=pod_eligible,
                low=low, high=high, weights=weights,
                rdims_onehot=rdims_onehot, pods=pods,
                fit_dims=fit_dims)


class DeviceLowNodeLoad(LowNodeLoad):
    """LowNodeLoad with the balance plan computed on `device` ("cuda"
    by default; raises without a card unless "cpu" is asked for, where
    the kernels' plain versions run).

    Classification for the anomaly counters reuses the host classify()
    (cheap, stateful); the eviction selection, the O(N x P) part, runs
    on the device. Per-cycle caps ride the prefix plan; per-node /
    per-namespace caps switch to the capped walk, which replays the
    limiter's exact skip-and-continue decisions.
    """

    name = "LowNodeLoad"

    _BIG = 1 << 30

    def __init__(self, args: Optional[LowNodeLoadArgs] = None,
                 evictor=None, get_metrics=None, get_pods_by_node=None,
                 now_fn=None, device="cuda"):
        super().__init__(args, evictor, get_metrics, get_pods_by_node,
                         now_fn)
        self.device = resolve_device(device)

    def _limiter_caps(self):
        """(cycle_remaining, max_per_node, max_per_ns, limiter), with
        _BIG sentinels for unlimited dimensions."""
        limiter = getattr(self.evictor, "limiter", None)
        if limiter is None:
            return self._BIG, self._BIG, self._BIG, None
        cyc = (self._BIG if limiter.max_per_cycle is None
               else limiter.max_per_cycle - limiter._total)
        per_node = (self._BIG if limiter.max_per_node is None
                    else limiter.max_per_node)
        per_ns = (self._BIG if limiter.max_per_namespace is None
                  else limiter.max_per_namespace)
        return cyc, per_node, per_ns, limiter

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def balance_once(self, nodes, metrics, pods_by_node, now):
        args = self.args
        # the host plugin never consults the evictor in dry_run: neither
        # may the device caps
        if args.dry_run:
            cyc, per_node, per_ns, limiter = (self._BIG, self._BIG,
                                              self._BIG, None)
        else:
            cyc, per_node, per_ns, limiter = self._limiter_caps()
        if not nodes:
            return []
        # one flattening pass; anomaly gating stays on the host
        usage, capacity, fresh = self.node_columns(nodes, metrics, now)
        _, _, low_mask, high_mask, _ = self.classify_columns(
            usage, capacity, fresh)
        names = [nd.meta.name for nd in nodes]
        source_mask = self._gate_anomalies(names, high_mask)
        if not low_mask.any() or not source_mask.any():
            return []
        cols = columnarize(nodes, metrics, pods_by_node, args,
                           usage, capacity, fresh)
        if cols is None:
            return []
        pods = cols.pop("pods")
        fit_dims = cols.pop("fit_dims")
        pod_node = cols["pod_node"]
        t = {k: self._tensor(v) for k, v in cols.items()}
        t["source_mask"] = self._tensor(source_mask)
        max_evictions = max(min(cyc, self._BIG), 0)
        if per_node < self._BIG or per_ns < self._BIG:
            # namespace ids and seeded limiter state (mid-cycle reuse)
            ns_names = sorted({p.meta.namespace for p in pods})
            ns_of = {s: j for j, s in enumerate(ns_names)}
            pod_ns = np.asarray([ns_of[p.meta.namespace] for p in pods],
                                np.int32)
            ns_counts0 = np.zeros((_pad_pow2(len(ns_names)),), np.int32)
            per_node0 = np.zeros((len(nodes),), np.int32)
            if limiter is not None:
                for s, j in ns_of.items():
                    ns_counts0[j] = limiter._per_ns.get(s, 0)
                for i, name in enumerate(names):
                    per_node0[i] = limiter._per_node.get(name, 0)
            take, order = plan_kernel_capped(
                pod_ns=self._tensor(pod_ns),
                ns_counts0=self._tensor(ns_counts0),
                per_node0=self._tensor(per_node0),
                max_evictions=max_evictions,
                max_per_node=min(per_node, self._BIG),
                max_per_ns=min(per_ns, self._BIG),
                use_deviation=args.use_deviation_thresholds,
                node_fit=args.node_fit, fit_dims=fit_dims, **t)
        else:
            take, order = plan_kernel(
                max_evictions=max_evictions,
                use_deviation=args.use_deviation_thresholds,
                node_fit=args.node_fit, fit_dims=fit_dims, **t)
        take = take.cpu().numpy()
        sel_idx = [int(i) for i in order.cpu().numpy() if take[int(i)]]
        if args.dry_run or self.evictor is None:
            return [pods[i] for i in sel_idx]
        selected = []
        for i in sel_idx:
            # honor the live verdict: a custom evictor may refuse pods
            # the limiter model did not predict (refused pods are not
            # re-planned; the host loop drops them the same way)
            if self.evictor.evict(
                    pods[i], f"node {names[int(pod_node[i])]} is "
                             f"overutilized"):
                selected.append(pods[i])
        return selected
