"""The port's NodeNUMAResource functions and kernel K4's plain version
against the JAX package's numaaware plugin and the policy node's
combined-fit prefilter of schedule_batch (core.py:355-370)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.scheduler import topologymanager as jtm
from koordinator_tpu.scheduler.batching import EPS as JEPS
from koordinator_tpu.scheduler.plugins import numaaware as jnuma
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch.kernels.numa_terms import (
    numa_pair_terms,
    numa_pair_terms_plain,
)
from koordinator_tpu_torch.scheduler.plugins import numaaware

from torch_port_ref import to_port
from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)


def zone_state(seed, n, z, *, fractional=False):
    """A node snapshot of n nodes with z zone slots: capacities and usage
    in multiples of 500 mC / 512 MiB (or, `fractional`, any float32),
    about 15 % of the zones invalid (zone 0 always valid), some zones of
    zero capacity, every topology policy code, and the pods of the same
    seed with 40 % NUMA-bound."""
    rng = np.random.default_rng(seed)
    snap = jsyn.synthetic_cluster(n, seed=seed, num_quotas=4)
    pods = jsyn.synthetic_pods(3 * n // 2, seed=seed + 1, prod_frac=0.8,
                               num_quotas=4)
    if fractional:
        cap = rng.uniform(0, 40000, (n, z, 2)).astype(np.float32)
        used = (cap * rng.uniform(0, 1.1, (n, z, 2))).astype(np.float32)
    else:
        # above four zones, narrower zones: a node's total stays near
        # the pods' requests, so that the policy gate bites
        k = 4 / max(z, 4)
        cap = np.stack([rng.integers(0, int(40 * k), (n, z)) * 500,
                        rng.integers(0, int(80 * k), (n, z)) * 512],
                       axis=-1).astype(np.float32)
        used = np.floor(cap * rng.uniform(0, 1.1, (n, z, 1)) / 500) * 500
    valid = rng.uniform(size=(n, z)) < 0.85
    valid[:, 0] = True
    nodes = snap.nodes.replace(
        numa_cap=jnp.asarray(cap),
        numa_free=jnp.asarray(np.maximum(cap - used, 0).astype(np.float32)),
        numa_valid=jnp.asarray(valid),
        numa_policy=jnp.asarray(rng.integers(0, 4, n).astype(np.int32)))
    pods = pods.replace(numa_single=jnp.asarray(
        rng.uniform(size=pods.num_pods) < 0.4))
    return nodes, pods


def reference_pair_terms(nodes, pods, strategy):
    """The reference's batch-start NUMA gates and score, as
    schedule_batch forms them (core.py:329-370)."""
    req2_all = jnp.stack([pods.requests[:, jnuma.CPU],
                          pods.requests[:, jnuma.MEM]], axis=-1)
    total = jnp.sum(nodes.numa_free * nodes.numa_valid[:, :, None], axis=1)
    policy_ok = ((nodes.numa_policy == jtm.POLICY_NONE)[None]
                 | jnp.all(total[None] + JEPS >= req2_all[:, None, :],
                           axis=-1))
    ok = jnuma.zone_prefilter(nodes, pods) & policy_ok
    return ok, jnuma.numa_score_matrix(nodes, pods, strategy)


_ref_terms = jax.jit(reference_pair_terms, static_argnums=2)


@functools.lru_cache(maxsize=None)
def _case(seed, z, fractional, kind="plain", n=48):
    """`zone_state` of n nodes, made one of the cases K4's design
    branches on (csrc/numa_terms.cu): "no-policy" (no policy node, the
    full gate's kind), "all-bound" / "none-bound" (every pod NUMA-bound,
    none), "none-bound-no-policy" (both: every pair passes); else as it
    is."""
    nodes, pods = zone_state(seed, n, z, fractional=fractional)
    if "no-policy" in kind:
        nodes = nodes.replace(numa_policy=jnp.zeros_like(nodes.numa_policy))
    if kind.startswith(("all-bound", "none-bound")):
        pods = pods.replace(numa_single=jnp.full(
            pods.numa_single.shape, kind.startswith("all")))
    return nodes, pods, to_port("NodeState", nodes), to_port("PodBatch", pods)


# Z = 8: two sockets at NPS4 or SNC-4 (fault C8's width)
CASES = [(seed, z, frac) for seed in (0, 1) for z in (2, 4)
         for frac in (False, True)] + [(0, 8, False), (0, 8, True)]
IDS = [f"seed{s}-Z{z}-{'fractional' if f else 'integer'}" for s, z, f in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pod_zone_requests_equal_reference(case):
    nodes, pods, tn, tp = _case(*case)
    want = np.asarray(jax.jit(jnuma.pod_zone_requests)(pods))
    got = numaaware.pod_zone_requests(tp).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_zone_prefilter_equal_reference(case):
    nodes, pods, tn, tp = _case(*case)
    want = np.asarray(jax.jit(jnuma.zone_prefilter)(nodes, pods))
    got = numaaware.zone_prefilter(tn, tp).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("strategy", ["most", "least"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_numa_score_matrix_bit_equal_reference(case, strategy):
    nodes, pods, tn, tp = _case(*case)
    want = np.asarray(jax.jit(jnuma.numa_score_matrix, static_argnums=2)(
        nodes, pods, strategy))
    got = numaaware.numa_score_matrix(tn, tp, strategy).numpy()
    assert got.tobytes() == want.tobytes()
    # scores strictly inside (0, 100) occur: the arithmetic is exercised
    assert ((want > 0) & (want < 100)).any()


# (seed, Z, fractional, kind, N): the cases K4's design branches on
# (`_case`; "prefix-of-mask": the first half of the pods ANDed into a
# mask of all of them), and rows that start mid-word (N = 17, 1001) or
# hold one pair (N = 1, one pod)
K4_CASES = [(0, 2, False, "no-policy", 48), (1, 2, False, "all-bound", 48),
            (0, 4, True, "all-bound-no-policy", 48),
            (1, 2, False, "none-bound", 48),
            (0, 2, False, "none-bound-no-policy", 48),
            (1, 2, False, "prefix-of-mask", 48), (0, 2, False, "plain", 1),
            (1, 2, True, "plain", 17), (0, 2, False, "plain", 1001)]
K4_IDS = [f"seed{s}-Z{z}-{k}-N{n}" for s, z, _, k, n in K4_CASES]


@pytest.mark.parametrize("strategy", ["most", "least"])
@pytest.mark.parametrize("case", CASES + K4_CASES, ids=IDS + K4_IDS)
def test_numa_pair_terms_equal_reference(case, strategy):
    """K4's plain version (through its wrapper, on CPU tensors) against
    the reference's zone prefilter AND policy combined fit, and its zone
    score; every policy code occurs, zone-less nodes too, and the cases
    of K4_CASES (a given mask's rows beyond a prefix stay as they
    are)."""
    nodes, pods, tn, tp = _case(*case)
    kind, n = case[3:] if len(case) > 3 else ("plain", 48)
    want_ok, want_score = (np.asarray(x) for x in
                           _ref_terms(nodes, pods, strategy))
    rows, mask = None, None
    if kind == "prefix-of-mask":
        rows = pods.num_pods // 2
        mask = torch.from_numpy(np.random.default_rng(case[0]).uniform(
            size=want_ok.shape) < 0.7)
        want_ok = np.concatenate([mask.numpy()[:rows] & want_ok[:rows],
                                  mask.numpy()[rows:]])
    got_ok, got_score = numa_pair_terms(
        numaaware.zone_demand(tp)[:rows], tp.numa_single[:rows],
        tn.numa_cap, tn.numa_free, tn.numa_valid, tn.numa_policy, strategy,
        pair_ok=mask)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    assert got_score.numpy().tobytes() == want_score[:rows].tobytes()
    policy_ok = numaaware.policy_fit_terms(
        numaaware.zone_demand(tp), tn.numa_free, tn.numa_valid,
        tn.numa_policy)
    if "no-policy" in kind:
        assert bool(policy_ok.all())
    elif n > 1:
        assert not bool(policy_ok.all()), "the policy gate never bites"
    if kind.startswith("none-bound"):
        assert not want_score.any()
    if kind == "none-bound-no-policy":
        assert want_ok.all()


def test_numa_pair_terms_wrapper_checks_its_inputs():
    _, _, tn, tp = _case(0, 2, False)
    args = [numaaware.zone_demand(tp), tp.numa_single, tn.numa_cap,
            tn.numa_free, tn.numa_valid, tn.numa_policy]
    with pytest.raises(ValueError, match="strategy"):
        numa_pair_terms(*args, "spread")
    bad = list(args)
    bad[5] = tn.numa_policy.long()
    with pytest.raises(TypeError, match="numa_policy"):
        numa_pair_terms(*bad, "most")
    bad = list(args)
    bad[3] = tn.numa_free[:, :1].contiguous()
    with pytest.raises(ValueError, match="numa_free"):
        numa_pair_terms(*bad, "most")
    assert numa_pair_terms_plain(*args, "most")[0].dtype == torch.bool
