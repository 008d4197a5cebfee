"""The port's LoadAware filter and score against the JAX plugin, exactly,
across the configuration variants. The reference functions run jitted,
as the scheduler runs them (its compiler fuses multiply-adds there)."""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest

from koordinator_tpu.api.extension import ResourceKind as RK
from koordinator_tpu.scheduler.plugins import loadaware as jla
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch.scheduler.plugins import loadaware

from torch_port_ref import to_port
from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)

VARIANTS = {
    "default": {},
    "prod_thresholds": dict(prod_usage_thresholds={RK.CPU: 40.0,
                                                   RK.MEMORY: 55.0}),
    "filter_agg": dict(filter_agg_type="p95",
                       agg_usage_thresholds={RK.CPU: 50.0, RK.MEMORY: 70.0}),
    "score_agg": dict(score_agg_type="p90"),
    "score_prod_usage": dict(score_according_prod_usage=True),
    # integer weights, as LoadAwareSchedulingArgs has them (int64)
    "weights": dict(resource_weights={RK.CPU: 3.0, RK.MEMORY: 2.0,
                                      RK.BATCH_MEMORY: 5.0}),
    # fractional weights: the weighted sum's rounding shows (ROADMAP C1)
    "fractional_weights": dict(resource_weights={RK.CPU: 3.0,
                                                 RK.MEMORY: 0.7}),
    "all": dict(prod_usage_thresholds={RK.CPU: 45.0},
                filter_agg_type="avg",
                agg_usage_thresholds={RK.CPU: 60.0, RK.MEMORY: 90.0},
                score_agg_type="p99", score_according_prod_usage=True,
                resource_weights={RK.CPU: 1.0, RK.MEMORY: 2.0,
                                  RK.BATCH_CPU: 1.0}),
}


def _inputs(seed):
    """A cluster with stale metrics, missing percentiles, assigned
    estimates (non-integer) and corrections, and usage near the
    thresholds; pods with DaemonSets and both priority tiers."""
    rng = np.random.default_rng(seed)
    snap = jsyn.synthetic_cluster(48, seed=seed, usage_cpu_frac=(0.3, 0.9))
    n = snap.nodes
    alloc = np.asarray(n.allocatable)
    est = (rng.uniform(0, 0.3, alloc.shape) * alloc).astype(np.float32) + 0.25
    corr = (rng.uniform(0, 0.2, alloc.shape) * alloc).astype(np.float32)
    nodes = n.replace(
        assigned_estimated=est, assigned_correction=corr,
        prod_assigned_estimated=(est * 0.5).astype(np.float32),
        prod_assigned_correction=(corr * 2.0).astype(np.float32),
        metric_fresh=rng.uniform(size=48) < 0.8,
        has_agg=rng.uniform(size=48) < 0.7)
    pods = jsyn.synthetic_pods(40, seed=seed)
    pods = pods.replace(daemonset=rng.uniform(size=40) < 0.2)
    return nodes, pods


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("seed", [0, 1])
def test_filter_and_score_exactly_equal_reference(variant, seed):
    jnodes, jpods = _inputs(seed)
    jcfg = jla.LoadAwareConfig.make(**VARIANTS[variant])
    tcfg = loadaware.LoadAwareConfig.make(**VARIANTS[variant], device="cpu")
    tnodes, tpods = to_port("NodeState", jnodes), to_port("PodBatch", jpods)

    want = np.asarray(jax.jit(jla.filter_mask)(jnodes, jpods, jcfg))
    got = loadaware.filter_mask(tnodes, tpods, tcfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size

    for dims in (None, (0, 1)):
        score = jax.jit(functools.partial(jla.score_matrix, score_dims=dims))
        want = np.asarray(score(jnodes, jpods, jcfg))
        got = loadaware.score_matrix(tnodes, tpods, tcfg, dims).numpy()
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(want)) > 5


# eleven fractional weights: every term of the weighted sum rounds
FRACTIONAL_11 = {RK(i): w for i, w in enumerate(
    (3.0, 0.7, 1.3, 0.1, 2.9, 0.3, 1.7, 0.9, 0.6, 1.1, 2.2))}


@pytest.mark.parametrize("dims", [None, (0,), (0, 1), (0, 1, 2), (1, 4, 7),
                                  tuple(range(5)), tuple(range(11))],
                         ids=str)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_sum_rounds_as_reference(dims, seed):
    """The score's weighted sum over every width the reference can be
    asked for, with weights whose products and sums all round: the FMA
    chain for listed dims, the 8-lane sum for all dims."""
    jnodes, jpods = _inputs(seed)
    jcfg = jla.LoadAwareConfig.make(resource_weights=FRACTIONAL_11)
    tcfg = loadaware.LoadAwareConfig.make(resource_weights=FRACTIONAL_11,
                                          device="cpu")
    score = jax.jit(functools.partial(jla.score_matrix, score_dims=dims))
    want = np.asarray(score(jnodes, jpods, jcfg))
    got = loadaware.score_matrix(to_port("NodeState", jnodes),
                                 to_port("PodBatch", jpods), tcfg, dims)
    np.testing.assert_array_equal(got.numpy(), want)
