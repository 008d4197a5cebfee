"""The port's slim flagship (chunk sweep plus straggler tail) against the
JAX composition bench.py runs: core.schedule_batch in lax.scan, then
core.tail_compaction_loop, with the bench's arguments."""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest

from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch import flagship
from koordinator_tpu_torch.scheduler.core import overcommit_ok, quota_ok
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig

from torch_port_ref import to_port

PODS, NODES, CHUNK, TAIL_CHUNK = 2048, 128, 512, 128


def reference_flagship(snap, pods, cfg):
    step = functools.partial(jcore.schedule_batch, **flagship.STEP_KW)
    tail_step = functools.partial(jcore.schedule_batch, **flagship.TAIL_KW)

    @jax.jit
    def run(snap, stacked, pods, cfg):
        def body(snap, cols):
            res = step(snap, pods.replace(**cols), cfg)
            return res.snapshot, res.assignment
        snap, assign = jax.lax.scan(body, snap, stacked)
        counts = tuple(getattr(pods, f) for f in jcore.COUNT_FIELDS)
        return jcore.tail_compaction_loop(
            tail_step, snap, counts, assign.reshape(-1), pods, cfg,
            tail_chunk=TAIL_CHUNK, min_passes=flagship.MIN_TAIL_PASSES,
            max_passes=flagship.DEFAULT_MAX_TAIL_PASSES,
            charge_counts=False)

    snap, _, assign, stats = run(snap, jsyn.stack_pod_chunks(pods, CHUNK),
                                 pods, cfg)
    return snap, np.asarray(assign), np.asarray(stats)


@pytest.fixture(scope="module")
def both():
    snap = jsyn.synthetic_cluster(NODES, seed=7, num_quotas=32)
    pods = jsyn.synthetic_pods(PODS, seed=1, num_quotas=32)
    want = reference_flagship(snap, pods, JCfg.make())
    got = flagship.sweep_and_tail(
        to_port("ClusterSnapshot", snap), to_port("PodBatch", pods),
        LoadAwareConfig.make(device="cpu"), CHUNK, tail_chunk=TAIL_CHUNK)
    return want, got


def test_assignment_equal(both):
    (_, want_assign, _), got = both
    np.testing.assert_array_equal(got.assignment.numpy(), want_assign)


def test_tail_stats_equal(both):
    (_, _, want_stats), got = both
    np.testing.assert_array_equal(got.stats.numpy(), want_stats)
    # the sweep leaves stragglers, the tail places some of them over
    # more than the mandatory passes, and every straggler is retried
    after_sweep, final, never_retried, passes = want_stats
    assert after_sweep > final > 0 and never_retried == 0
    assert passes > flagship.MIN_TAIL_PASSES


def test_final_snapshot_equal_and_sound(both):
    (want_snap, _, _), got = both
    for part, field in (("nodes", "requested"), ("quotas", "used"),
                        ("nodes", "assigned_estimated")):
        w = np.asarray(getattr(getattr(want_snap, part), field))
        g = getattr(getattr(got.snapshot, part), field).numpy()
        assert g.tobytes() == w.tobytes(), (part, field)
    assert overcommit_ok(got.snapshot) and quota_ok(got.snapshot)


def test_run_northstar_line_on_the_host():
    line, run = flagship.run_northstar(256, 32, 128, device="cpu")
    assert line["platform"] == "cpu" and line["num_pods"] == 256
    assert line["placed"] == int((run.assignment >= 0).sum()) > 0
    assert line["stragglers_final"] <= line["stragglers_after_sweep"]
    assert line["tail_passes"] >= flagship.MIN_TAIL_PASSES
