"""The port's topology manager (scheduler/topologymanager.py) and kernel
K5's plain version against the JAX package's topologymanager module,
with the CPU+memory hint provider and DeviceShare's."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.scheduler import topologymanager as jtm
from koordinator_tpu.scheduler.plugins import deviceshare as jds
from koordinator_tpu_torch.kernels.topology import (
    topology_admit,
    topology_admit_plain,
)
from koordinator_tpu_torch.scheduler import topologymanager as tm

from torch_port_ref import to_port
from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)

POLICIES = (tm.POLICY_NONE, tm.POLICY_BEST_EFFORT, tm.POLICY_RESTRICTED,
            tm.POLICY_SINGLE_NUMA_NODE)


def hint_inputs(seed, p, z, fractional=False):
    """free_z f32[P, Z, 2], req f32[P, 2] (about 10 % zero requests, some
    larger than one zone), valid bool[P, Z] (zone 0 always valid),
    policy i32[P] over every code, as numpy."""
    rng = np.random.default_rng(seed)
    if fractional:
        free = rng.uniform(0, 8000, (p, z, 2)).astype(np.float32)
        req = rng.uniform(0, 12000, (p, 2)).astype(np.float32)
    else:
        free = np.stack([rng.integers(0, 16, (p, z)) * 500,
                         rng.integers(0, 16, (p, z)) * 512],
                        axis=-1).astype(np.float32)
        req = np.stack([rng.integers(0, 24, p) * 500,
                        rng.integers(0, 24, p) * 512],
                       axis=-1).astype(np.float32)
    req[rng.uniform(size=p) < 0.1] = 0.0
    valid = rng.uniform(size=(p, z)) < 0.8
    valid[:, 0] = True
    policy = rng.integers(0, 4, p).astype(np.int32)
    return free, req, valid, policy


# Z = 8: two sockets at NPS4 or SNC-4, 256 masks (fault C8's width)
CASES = [(seed, z, frac) for seed in (0, 1) for z in (2, 4)
         for frac in (False, True)] + [(0, 8, False), (0, 8, True)]
IDS = [f"seed{s}-Z{z}-{'fractional' if f else 'integer'}" for s, z, f in CASES]


@functools.lru_cache(maxsize=None)
def _inputs(seed, z, frac):
    return hint_inputs(seed, 256, z, frac)


def test_mask_table_equal_reference():
    for z in (1, 2, 3, 4):
        for got, want in zip(tm.mask_table(z), jtm.mask_table(z)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_capacity_and_merged_hints_equal_reference(case):
    free, req, valid, _ = _inputs(*case)
    want = jax.jit(lambda f, r, v: jtm.merge_hints(
        [jtm.capacity_hints(f, r, v)]))(free, req, valid)
    raw = tm.capacity_hints(torch.from_numpy(free), torch.from_numpy(req),
                            torch.from_numpy(valid))
    got = tm.merge_hints([raw])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # two providers: AND of fits, preferred only where both prefer
    two = tm.merge_hints([raw, (raw[0], torch.zeros_like(raw[1]))])
    assert not bool(two[1].any()) and torch.equal(two[0], raw[0])


@pytest.mark.parametrize("strategy", ["most", "least"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_resolve_equal_reference(case, strategy):
    """All four policies (and an unknown code) in one batch, both
    strategies, zero-request pods included."""
    free, req, valid, policy = _inputs(*case)
    policy = policy.copy()
    policy[:4] = 7   # an unknown code engages but resolves to every zone

    @functools.partial(jax.jit, static_argnums=4)
    def ref(f, r, v, pol, strat):
        fit, pref = jtm.merge_hints([jtm.capacity_hints(f, r, v)])
        return jtm.resolve(fit, pref, pol, f[..., 0], v, strat)

    want = ref(free, req, valid, policy, strategy)
    t = [torch.from_numpy(x) for x in (free, req, valid, policy)]
    fit, pref = tm.merge_hints([tm.capacity_hints(*t[:3])])
    got = tm.resolve(fit, pref, t[3], t[0][..., 0], t[2], strategy)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # with one provider a fit always has a preferred hint, so only the
    # single-numa-node policy rejects (a pod that fits only across zones)
    admit = np.asarray(want[1])
    assert not admit[policy == tm.POLICY_SINGLE_NUMA_NODE].all()
    assert admit[policy != tm.POLICY_SINGLE_NUMA_NODE].all()


@pytest.mark.parametrize("strategy", ["most", "least"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_greedy_take_bit_equal_reference(case, strategy):
    free, req, valid, _ = _inputs(*case)
    rng = np.random.default_rng(7)
    affinity = (rng.uniform(size=valid.shape) < 0.6) & valid
    want = jax.jit(jtm.greedy_take, static_argnums=3)(free, req, affinity,
                                                      strategy)
    got = tm.greedy_take(torch.from_numpy(free), torch.from_numpy(req),
                         torch.from_numpy(affinity), strategy)
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    split = (np.asarray(want[0])[:, :, 0] > 0).sum(axis=1)
    assert (split > 1).any() and not np.asarray(want[1]).all()


def reference_step(choice, trying, single, demand, cap, used, valid,
                   node_policy, strategy):
    """The reference's topology-manager block of one inner step
    (core.py:907-948, zone1 of :1068), no GPU provider, no slots."""
    s = cap.shape[0]
    nc = jnp.clip(choice, 0, s - 1)
    pol = jnp.where(single, jtm.POLICY_SINGLE_NUMA_NODE, node_policy[nc])
    pol = jnp.where(trying, pol, 0)
    engaged = pol > jtm.POLICY_NONE
    free_z = jnp.maximum(cap[nc] - used[nc], 0.0)
    validz = valid[nc]
    req = demand * engaged[:, None]
    fit, pref = jtm.merge_hints([jtm.capacity_hints(free_z, req, validz)])
    affinity, admit, _ = jtm.resolve(fit, pref, pol, free_z[..., 0], validz,
                                     strategy)
    take, filled = jtm.greedy_take(free_z, req, affinity, strategy)
    zone1 = jnp.argmax(affinity, axis=-1).astype(jnp.int32)
    return affinity, engaged, admit & (~engaged | filled), take, zone1


_ref_step = jax.jit(reference_step, static_argnums=8)


@pytest.mark.parametrize("strategy", ["most", "least"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_topology_admit_plain_equals_reference_composition(case, strategy):
    """K5's plain version (through its wrapper, on CPU tensors) against
    the composition of the reference's functions as its inner step
    composes them: chosen nodes out of range (dropped pods), pods not
    trying, NUMA-bound pods, every node policy."""
    seed, z, frac = case
    rng = np.random.default_rng(seed + 40)
    s, p = 24, 300
    cap = np.stack([rng.integers(0, 24, (s, z)) * 500,
                    rng.integers(0, 24, (s, z)) * 512],
                   axis=-1).astype(np.float32)
    used = (np.floor(cap * rng.uniform(0, 1.2, (s, z, 1)) / 500)
            * 500).astype(np.float32)
    if frac:
        used = (cap * rng.uniform(0, 1.2, (s, z, 1))).astype(np.float32)
    valid = rng.uniform(size=(s, z)) < 0.8
    node_policy = rng.integers(0, 4, s).astype(np.int32)
    choice = rng.integers(0, s + 1, p).astype(np.int32)   # s = dropped
    trying = (rng.uniform(size=p) < 0.8) & (choice < s)
    single = rng.uniform(size=p) < 0.4
    demand = np.stack([rng.integers(0, 20, p) * 500,
                       rng.integers(0, 20, p) * 512],
                      axis=-1).astype(np.float32)
    demand[rng.uniform(size=p) < 0.1] = 0.0
    want = _ref_step(choice, trying, single, demand, cap, used, valid,
                     node_policy, strategy)
    args = [torch.from_numpy(x) for x in (choice, trying, single, demand,
                                          cap, used, valid, node_policy)]
    got = topology_admit(*args, strategy)
    for name, w in zip(("affinity", "engaged", "admit", "take", "zone1"),
                       want):
        g = getattr(got, name).numpy()
        assert g.dtype == np.asarray(w).dtype, name
        assert g.tobytes() == np.asarray(w).tobytes(), name
    engaged = np.asarray(want[1])
    assert engaged.any() and (~np.asarray(want[2]) & engaged).any()


def test_topology_admit_wrapper_checks_its_inputs():
    p, s, z = 4, 3, 2
    args = [torch.zeros(p, dtype=torch.int32), torch.ones(p, dtype=torch.bool),
            torch.zeros(p, dtype=torch.bool), torch.zeros((p, 2)),
            torch.ones((s, z, 2)), torch.zeros((s, z, 2)),
            torch.ones((s, z), dtype=torch.bool),
            torch.zeros(s, dtype=torch.int32)]
    with pytest.raises(ValueError, match="strategy"):
        topology_admit(*args, "spread")
    bad = list(args)
    bad[0] = args[0].long()
    with pytest.raises(TypeError, match="choice"):
        topology_admit(*bad, "most")
    bad = list(args)
    bad[5] = torch.zeros((s, z + 1, 2))
    with pytest.raises(ValueError, match="numa_used"):
        topology_admit(*bad, "most")
    assert topology_admit_plain(*args, "least").admit.all()


@pytest.mark.parametrize("z", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_count_hints_and_both_providers_equal_reference(seed, z):
    """DeviceShare's provider alone (need <= 0 pods: no preference), and
    merged after the CPU+memory provider, as the reference merges them."""
    rng = np.random.default_rng(seed + 30)
    p = 256
    counts = rng.integers(0, 4, (p, z)).astype(np.int32)
    need = rng.integers(-1, 6, p).astype(np.int32)
    free, req, valid, _ = hint_inputs(seed, p, z)

    @jax.jit
    def ref(c, nd, f, r, v):
        cnt = jtm.count_hints(c, nd)
        return cnt, jtm.merge_hints([jtm.capacity_hints(f, r, v), cnt])

    want_cnt, want_merged = ref(counts, need, free, req, valid)
    cnt = tm.count_hints(torch.from_numpy(counts), torch.from_numpy(need))
    merged = tm.merge_hints([tm.capacity_hints(
        *(torch.from_numpy(x) for x in (free, req, valid))), cnt])
    for got, want in ((cnt, want_cnt), (merged, want_merged)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    fit, pref = (np.asarray(x) for x in want_merged)
    assert fit.any() and not fit.all()
    assert (fit & ~pref).any() == (z > 1)   # one zone: every fit preferred


def gpu_pool(seed, s, z, i=4):
    """numpy gpu_total f32[S, 3], gpu_free f32[S, I, 3], gpu_valid
    bool[S, I], gpu_numa i32[S, I] (instances spread over the z zones,
    about 10 % of zone -1 and 10 % invalid, partly used), and a pod
    batch's gpu requests (JAX PodBatch, 60 % GPU pods)."""
    rng = np.random.default_rng(seed + 90)
    total = np.tile(np.array([[100.0, 81920.0, 100.0]], np.float32), (s, 1))
    total[rng.uniform(size=s) < 0.2] = 0.0
    free = np.floor(total[:, None, :] * rng.uniform(0, 1, (s, i, 1)))
    full = rng.uniform(size=(s, i)) < 0.5
    free[full] = np.broadcast_to(total[:, None, :], (s, i, 3))[full]
    valid = (total[:, None, 0] > 0) & (rng.uniform(size=(s, i)) < 0.9)
    numa = np.tile(np.arange(i) * z // i, (s, 1)).astype(np.int32)
    numa[rng.uniform(size=(s, i)) < 0.1] = -1
    return total, free.astype(np.float32), valid, numa


@functools.partial(jax.jit, static_argnums=10)
def reference_step_gpu(choice, trying, single, demand, cap, used, valid,
                       node_policy, devices, pods, strategy):
    """`reference_step` with DeviceShare's provider merged after the
    CPU+memory one (core.py:898-906, :930-940)."""
    s = cap.shape[0]
    nc = jnp.clip(choice, 0, s - 1)
    pol = jnp.where(single, jtm.POLICY_SINGLE_NUMA_NODE, node_policy[nc])
    pol = jnp.where(trying, pol, 0)
    engaged = pol > jtm.POLICY_NONE
    free_z = jnp.maximum(cap[nc] - used[nc], 0.0)
    validz = valid[nc]
    req = demand * engaged[:, None]
    g_count, g_per = jds.per_instance_at(devices, pods, choice)
    zcounts = jds.gpu_zone_counts(devices.gpu_free, devices, choice, g_per,
                                  cap.shape[1])
    fit, pref = jtm.merge_hints([jtm.capacity_hints(free_z, req, validz),
                                 jtm.count_hints(zcounts, g_count * engaged)])
    affinity, admit, _ = jtm.resolve(fit, pref, pol, free_z[..., 0], validz,
                                     strategy)
    take, filled = jtm.greedy_take(free_z, req, affinity, strategy)
    zone1 = jnp.argmax(affinity, axis=-1).astype(jnp.int32)
    return affinity, engaged, admit & (~engaged | filled), take, zone1


@pytest.mark.parametrize("strategy", ["most", "least"])
@pytest.mark.parametrize("z", [2, 4, 8])
def test_topology_admit_plain_with_gpu_provider_equals_reference(z, strategy):
    """K5's plain version with DeviceShare's hint provider against the
    reference's composition: GPU pods that are NUMA-bound or on policy
    nodes, instances of zone -1, invalid and partly used instances; at
    Z = 8 with 56 instances a node (8 GPUs in 7 MIG slices)."""
    from koordinator_tpu.snapshot.schema import DeviceState
    from koordinator_tpu.utils import synthetic as jsyn
    from koordinator_tpu_torch.scheduler.plugins import deviceshare

    rng = np.random.default_rng(z + 5)
    s, p = 24, 300
    cap = np.stack([rng.integers(4, 24, (s, z)) * 500,
                    rng.integers(4, 24, (s, z)) * 512],
                   axis=-1).astype(np.float32)
    used = (np.floor(cap * rng.uniform(0, 0.8, (s, z, 1)) / 500)
            * 500).astype(np.float32)
    valid = rng.uniform(size=(s, z)) < 0.9
    valid[:, 0] = True
    node_policy = rng.integers(0, 4, s).astype(np.int32)
    choice = rng.integers(0, s + 1, p).astype(np.int32)
    trying = (rng.uniform(size=p) < 0.8) & (choice < s)
    single = rng.uniform(size=p) < 0.4
    demand = np.stack([rng.integers(0, 8, p) * 500,
                       rng.integers(0, 8, p) * 512],
                      axis=-1).astype(np.float32)
    total, free, gvalid, numa = gpu_pool(z, s, z, i=56 if z == 8 else 4)
    pods = jsyn.synthetic_pods(p, seed=z, gpu_pod_frac=0.6)
    devices = DeviceState(
        gpu_total=total, gpu_free=free, gpu_valid=gvalid, gpu_numa=numa,
        gpu_pcie=np.zeros_like(numa),
        aux_free=np.zeros((s, 2, 0), np.float32),
        aux_valid=np.zeros((s, 2, 0), bool))
    want = reference_step_gpu(choice, trying, single, demand, cap, used,
                              valid, node_policy, devices, pods, strategy)
    args = [torch.from_numpy(x) for x in (choice, trying, single, demand,
                                          cap, used, valid, node_policy)]
    tdev = to_port("DeviceState", devices)
    tpods = to_port("PodBatch", pods)
    gpu_req = deviceshare.gpu_request(tpods.requests, tpods.gpu_ratio)
    got = topology_admit(*args, strategy, gpu_req, tdev)
    for name, w in zip(("affinity", "engaged", "admit", "take", "zone1"),
                       want):
        g = getattr(got, name).numpy()
        assert g.dtype == np.asarray(w).dtype, name
        assert g.tobytes() == np.asarray(w).tobytes(), name
    # the GPU provider changes some outcome against the CPU+memory one
    alone = topology_admit(*args, strategy)
    assert not (torch.equal(alone.affinity, got.affinity)
                and torch.equal(alone.admit, got.admit))
    with pytest.raises(ValueError, match="go together"):
        topology_admit(*args, strategy, gpu_req, None)
