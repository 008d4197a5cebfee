"""ElasticQuota overuse revoke (the overuse half of
`scheduler/plugins/quota_revoke.py`) in the port against the JAX
package: tests/test_quota_controllers.py's revoke scenarios (:93-138) on
the port's controller, the same victims by name as the reference's on
the same pods, and a sweep of random quotas where both packages choose
the same victims. The pods are the port's `api.Pod`, carried to the
reference by attribute."""

from __future__ import annotations

import numpy as np
import pytest

from koordinator_tpu.scheduler.plugins import quota_revoke as jrevoke
from koordinator_tpu_torch.api import types as api
from koordinator_tpu_torch.api.extension import NUM_RESOURCES, ResourceKind
from koordinator_tpu_torch.scheduler.plugins.quota_revoke import (
    ANNOTATION_PREEMPTIBLE,
    QuotaOverUsedGroupMonitor,
    QuotaOverUsedRevokeController,
    select_revoke_victims,
)

from torch_port_ref import (  # noqa: F401 (one_torch_thread: a fixture)
    api_to_reference,
    one_torch_thread,
)

CPU = int(ResourceKind.CPU)


def quota_pod(name, cpu, prio, quota="q", mem=None):
    req = {ResourceKind.CPU: cpu}
    if mem is not None:
        req[ResourceKind.MEMORY] = mem
    return api.Pod(meta=api.ObjectMeta(name=name), requests=req,
                   priority=prio, quota_name=quota)


def _vec(cpu, mem=0.0):
    v = np.zeros(NUM_RESOURCES)
    v[CPU] = cpu
    v[int(ResourceKind.MEMORY)] = mem
    return v


def _names(pods):
    return [p.meta.name for p in pods]


def both_victims(pods, used, runtime):
    """(port victims, reference victims) by name, in order."""
    got = select_revoke_victims(pods, used, runtime)
    want = jrevoke.select_revoke_victims(api_to_reference(pods), used,
                                         runtime)
    return _names(got), _names(want)


# (pods, used, runtime, victims) of tests/test_quota_controllers.py
SCENARIOS = {
    # used 100, runtime 60: p1, p2 tried; both stay revoked
    "minimal_set": ([("p3", 50.0, 9000), ("p2", 30.0, 7000),
                     ("p1", 10.0, 5000)], 100.0, 60.0, {"p1", "p2"}),
    # used 100, runtime 55: p3 covers the others, which are reprieved
    "assign_back": ([("p3", 50.0, 9000), ("p2", 30.0, 7000),
                     ("p1", 10.0, 5000)], 100.0, 55.0, {"p3"}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_revoke_scenarios_equal_reference(name):
    spec, used, runtime, victims = SCENARIOS[name]
    pods = [quota_pod(*s) for s in spec]
    got, want = both_victims(pods, _vec(used), _vec(runtime))
    assert got == want and set(got) == victims


def test_revoke_skips_non_preemptible():
    shielded = quota_pod("s", 80.0, 5000)
    shielded.meta.annotations[ANNOTATION_PREEMPTIBLE] = "false"
    pods = [shielded, quota_pod("p", 20.0, 7000)]
    got, want = both_victims(pods, _vec(100.0), _vec(10.0))
    assert got == want == ["p"]


def test_overuse_controller_requires_sustained_overuse():
    """The monitor trips only after the trigger duration of overuse, and
    under-use resets the streak; each step equal to the reference's."""
    used = np.stack([_vec(100.0)])
    runtime = np.stack([_vec(60.0)])
    pods = {"q": [quota_pod("p", 50.0, 5000)]}
    ref_pods = api_to_reference(pods)
    ctl = QuotaOverUsedRevokeController(trigger_evict_duration_seconds=100.0)
    ref = jrevoke.QuotaOverUsedRevokeController(
        trigger_evict_duration_seconds=100.0)
    for now, want in ((0.0, []), (50.0, []), (150.0, ["p"])):
        got = _names(ctl.revoke_pods(["q"], used, runtime, pods, now=now))
        assert got == want == _names(ref.revoke_pods(
            ["q"], used, runtime, ref_pods, now=now))
    ctl2 = QuotaOverUsedRevokeController(trigger_evict_duration_seconds=100.0)
    ctl2.revoke_pods(["q"], used, runtime, pods, now=0.0)
    ctl2.revoke_pods(["q"], np.stack([_vec(10.0)]), runtime, pods, now=90.0)
    assert ctl2.revoke_pods(["q"], used, runtime, pods, now=150.0) == []


def test_monitor_forgets_removed_quotas():
    """A quota gone from the list loses its monitor; a new one starts
    its streak afresh."""
    ctl = QuotaOverUsedRevokeController(trigger_evict_duration_seconds=10.0)
    used, runtime = np.stack([_vec(100.0)] * 2), np.stack([_vec(60.0)] * 2)
    ctl.revoke_pods(["a", "b"], used, runtime, {}, now=0.0)
    assert set(ctl.monitors) == {"a", "b"}
    ctl.revoke_pods(["a"], used[:1], runtime[:1], {}, now=5.0)
    assert set(ctl.monitors) == {"a"}
    assert isinstance(ctl.monitors["a"], QuotaOverUsedGroupMonitor)


@pytest.mark.parametrize("seed", range(8))
def test_random_quotas_choose_the_reference_victims(seed):
    """Random quotas of 2-12 pods over CPU and memory, some not
    preemptible, used above runtime by 0-60 %: the same victims, in the
    same order, as the reference."""
    rng = np.random.default_rng(seed)
    for trial in range(20):
        n = int(rng.integers(2, 13))
        pods = [quota_pod(f"p{trial}-{i}", float(rng.integers(1, 20) * 500),
                          int(rng.integers(3000, 9999)),
                          mem=float(rng.integers(1, 16) * 256))
                for i in range(n)]
        for p in pods:
            if rng.uniform() < 0.15:
                p.meta.annotations[ANNOTATION_PREEMPTIBLE] = "false"
        used = sum(_vec(p.requests[ResourceKind.CPU],
                        p.requests[ResourceKind.MEMORY]) for p in pods)
        runtime = used * rng.uniform(0.4, 1.0, NUM_RESOURCES)
        got, want = both_victims(pods, used, runtime)
        assert got == want
