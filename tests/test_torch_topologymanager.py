"""The port's topology manager (scheduler/topologymanager.py) and kernel
K5's plain version against the JAX package's topologymanager module."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.scheduler import topologymanager as jtm
from koordinator_tpu_torch.kernels.topology import (
    topology_admit,
    topology_admit_plain,
)
from koordinator_tpu_torch.scheduler import topologymanager as tm

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


CASES = [(seed, z, frac) for seed in (0, 1) for z in (2, 4)
         for frac in (False, True)]
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
