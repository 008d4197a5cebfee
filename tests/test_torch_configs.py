"""The port's BASELINE config 2 (configs.run_config_2_numa, the NUMA
path) against the JAX composition bench_configs.config_2_numa runs:
core.schedule_batch(enable_numa=True) in lax.scan over the pod chunks,
with the bench's arguments, at a cut size."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch import configs
from koordinator_tpu_torch.scheduler.core import overcommit_ok, quota_ok

PODS, NODES, CHUNK = 1200, 80, 400


def reference_config_2():
    """bench_configs.config_2_numa's inputs and sweep at PODS x NODES."""
    snap = jsyn.with_two_numa_zones(
        jsyn.synthetic_cluster(NODES, num_quotas=32, seed=0))
    pods = jsyn.synthetic_pods(PODS, seed=1, prod_frac=0.6, num_quotas=32)
    pods = pods.replace(numa_single=jnp.asarray(
        np.asarray(pods.priority_class) == 4))
    step = functools.partial(jcore.schedule_batch, **configs.CONFIG_2_KW)

    @jax.jit
    def sweep(snap, stacked, pods, cfg):
        def body(s, cols):
            res = step(s, pods.replace(**cols), cfg)
            return res.snapshot, (res.assignment, res.numa_zone,
                                  res.numa_take)
        return jax.lax.scan(body, snap, stacked)

    snap, (assign, zone, take) = sweep(
        snap, jsyn.stack_pod_chunks(pods, CHUNK), pods, JCfg.make())
    return (snap, np.asarray(assign).reshape(-1),
            np.asarray(zone).reshape(-1),
            np.asarray(take).reshape(PODS, *np.asarray(take).shape[2:]))


@functools.lru_cache(maxsize=None)
def _both():
    want = reference_config_2()
    line, run = configs.run_config_2_numa(PODS, NODES, CHUNK, device="cpu")
    return want, line, run


@pytest.mark.parametrize("field", ["assignment", "numa_zone", "numa_take"])
def test_sweep_results_equal(field):
    (_, *want), _, run = _both()
    w = dict(zip(("assignment", "numa_zone", "numa_take"), want))[field]
    g = getattr(run, field).numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("part,field", [
    ("nodes", "requested"), ("nodes", "numa_free"), ("quotas", "used"),
    ("nodes", "assigned_estimated")])
def test_final_snapshot_equal(part, field):
    (want_snap, *_), _, run = _both()
    w = np.asarray(getattr(getattr(want_snap, part), field))
    g = getattr(getattr(run.snapshot, part), field).numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()


def test_final_snapshot_sound():
    _, line, run = _both()
    snap = run.snapshot
    assert overcommit_ok(snap) and quota_ok(snap)
    used = (snap.nodes.numa_cap - snap.nodes.numa_free).numpy()
    assert (used >= 0).all()
    assert line["metric"] == configs.CONFIG_2_METRIC
    assert line["platform"] == "cpu" and line["num_pods"] == PODS
    assert line["placed"] == int((run.assignment >= 0).sum()) > 0
    assert 0 < line["numa_bound_placed"] <= line["placed"]
