"""ElasticQuota overuse revocation: the host consumer of the quota
tree's used and runtime arrays.

Counterpart of the overuse half of
`koordinator_tpu/scheduler/plugins/quota_revoke.py`
(plugins/elasticquota/quota_overuse_revoke.go): a per-quota monitor
trips when used > runtime holds for the trigger duration (the
water-filled runtime shrinks when other quotas' demand grows, :61-90);
its victims (:92-148) are revoked from the least important pod up
until used <= runtime, then assigned back from the most important
down where they still fit, so only the revocations needed stay. The
fit tolerance is the device gates' `batching.EPS`. The quota-constrained
preemption half (`select_victims_on_node`) needs the scheduler's
preemption module and is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from koordinator_tpu_torch.api import types as api
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.snapshot.builder import resource_vec

ANNOTATION_PREEMPTIBLE = "scheduling.koordinator.sh/preemptible"


def _fits(used: np.ndarray, limit: np.ndarray) -> bool:
    return bool((used <= limit + EPS).all())


class QuotaOverUsedGroupMonitor:
    """One quota's overuse tracker (quota_overuse_revoke.go:45-90)."""

    def __init__(self, quota_name: str,
                 trigger_evict_duration_seconds: float = 300.0):
        self.quota_name = quota_name
        self.trigger = trigger_evict_duration_seconds
        self._last_under_used: Optional[float] = None

    def monitor(self, used: np.ndarray, runtime: np.ndarray,
                now: float) -> bool:
        """True when overuse persisted past the trigger duration."""
        if self._last_under_used is None:
            self._last_under_used = now
        if _fits(used, runtime):
            self._last_under_used = now
            return False
        if now - self._last_under_used > self.trigger:
            self._last_under_used = now
            return True
        return False


def select_revoke_victims(pods: Sequence[api.Pod], used: np.ndarray,
                          runtime: np.ndarray) -> List[api.Pod]:
    """getToRevokePodList (:92-148): revoke least-important-first until
    used <= runtime, then assign back most-important-first where
    possible. Pods annotated not preemptible are skipped."""
    order = sorted(pods, key=lambda p: (p.priority or 0))
    tried: List[api.Pod] = []
    u = used.astype(np.float64).copy()
    for pod in order:
        if _fits(u, runtime):
            break
        if pod.meta.annotations.get(ANNOTATION_PREEMPTIBLE) == "false":
            continue
        u -= resource_vec(pod.requests)
        tried.append(pod)
    if not _fits(u, runtime):
        return tried  # even revoking everything preemptible is not enough
    revoked: List[api.Pod] = []
    for pod in reversed(tried):
        req = resource_vec(pod.requests)
        u += req
        if not _fits(u, runtime):
            u -= req
            revoked.append(pod)
    return revoked


class QuotaOverUsedRevokeController:
    """Drives the per-quota monitors over the live quota arrays (used,
    and the runtime of K18's water-fill) and returns the pods to evict
    (quota_overuse_revoke.go:149-273)."""

    def __init__(self, trigger_evict_duration_seconds: float = 300.0):
        self.trigger = trigger_evict_duration_seconds
        self.monitors: Dict[str, QuotaOverUsedGroupMonitor] = {}

    def revoke_pods(self, quota_names: Sequence[str], used: np.ndarray,
                    runtime: np.ndarray,
                    pods_by_quota: Dict[str, Sequence[api.Pod]],
                    now: float) -> List[api.Pod]:
        """used, runtime: [Q, R] rows aligned with quota_names."""
        for stale in set(self.monitors) - set(quota_names):
            del self.monitors[stale]
        out: List[api.Pod] = []
        for qi, name in enumerate(quota_names):
            mon = self.monitors.get(name)
            if mon is None:
                mon = self.monitors[name] = QuotaOverUsedGroupMonitor(
                    name, self.trigger)
            if mon.monitor(np.asarray(used[qi]), np.asarray(runtime[qi]),
                           now):
                out.extend(select_revoke_victims(
                    pods_by_quota.get(name, ()), np.asarray(used[qi]),
                    np.asarray(runtime[qi])))
        return out
