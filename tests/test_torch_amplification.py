"""Amplified CPU (ROADMAP B21) in the port against the JAX package:
`schedule_batch(..., enable_amplification=True)`, `forget_pods` of an
amplified result and `guarded_schedule_batch` with amplification, on
the reference's own scenarios of tests/test_numaaware.py (a CPU-bind
pod costs its request times the node's ratio, a shared pod does not,
a running bind pod and forget, fit_dims without CPU) and on a small
amplified full-gate batch (the cascade, the three prefixes and the
domain classes; the ratios from `utils.synthetic.amplified_cpu`,
applied to both packages' snapshots as the same numpy arrays).

Tolerances: none. Every field is compared bit for bit."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.api.extension import ResourceKind as JRK
from koordinator_tpu.api.types import NodeMetric, ObjectMeta, Pod
from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler import guards as jguards
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.snapshot import delta as jdelta
from koordinator_tpu.snapshot.builder import SnapshotBuilder
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch import configs
from koordinator_tpu_torch.scheduler import core, guards
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.snapshot import delta
from koordinator_tpu_torch.utils import synthetic

from test_numaaware import NOW, amplified_node, bind_pod

from torch_port_ref import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_bits_equal,
    one_torch_thread,
    ref_tree,
    to_port,
    tree,
)

CPU = int(JRK.CPU)


def _both(snap, pods, **kw):
    """(reference result, port result) of one batch with `kw`."""
    want = jcore.schedule_batch(snap, pods, JCfg.make(), **kw)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", pods),
                              LoadAwareConfig.make(device="cpu"), **kw)
    return want, got


def _built(nodes, pods, running=()):
    """tests/test_numaaware.py's build: fresh metrics, the reference's
    SnapshotBuilder; (builder, snapshot, batch)."""
    b = SnapshotBuilder(max_nodes=len(nodes))
    for n in nodes:
        b.add_node(n)
        b.set_node_metric(NodeMetric(node_name=n.meta.name,
                                     update_time=NOW - 2,
                                     node_usage={JRK.CPU: 0.0}))
    for r in running:
        b.add_running_pod(r)
    snap, ctx = b.build(now=NOW)
    return b, snap, b.build_pod_batch(pods, ctx)


def _scenarios():
    node = amplified_node("amp", zone_cpu=8000.0, zones=2, ratio=2.0)
    shared = [Pod(meta=ObjectMeta(name=f"s{i}"), priority=9000,
                  requests={JRK.CPU: 10000.0, JRK.MEMORY: 512.0})
              for i in range(3)]
    big = [Pod(meta=ObjectMeta(name="big"), priority=9000,
               requests={JRK.CPU: 50_000.0, JRK.MEMORY: 512.0})]
    return {
        # test_numaaware.py:290 test_amplified_cpu_bind_pod_costs_ratio
        "bind_pod_costs_ratio": (
            [node], [bind_pod(f"p{i}", 6000.0, 1024.0) for i in range(3)],
            {}, 2),
        # :307 test_amplified_shared_pod_unaffected
        "shared_pod_unaffected": ([node], shared, {}, 3),
        # :349 test_amplification_respects_fit_dims
        "respects_fit_dims": ([node], big,
                              dict(fit_dims=(int(JRK.MEMORY),)), 1),
    }


@pytest.mark.parametrize("name", sorted(_scenarios()))
def test_amplified_scenarios_equal_reference(name):
    """Each scenario through both packages with the reference test's
    knobs (3 rounds, amplification on): every result field and the
    snapshot equal, and the placements the reference's test expects."""
    nodes, pods, kw, placed = _scenarios()[name]
    _, snap, batch = _built(nodes, pods)
    want, got = _both(snap, batch, num_rounds=3, enable_amplification=True,
                      **kw)
    assert_bits_equal(tree(got), ref_tree(want))
    assert got.amplified and want.amplified
    assert int((got.assignment >= 0).sum()) == placed
    if name == "bind_pod_costs_ratio":
        assert float(got.snapshot.nodes.requested[0, CPU]) == 24000.0


def test_amplified_running_pod_and_forget_roundtrip():
    """test_numaaware.py:318: a running CPU-bind pod charged amplified at
    build, an in-cycle bind pod charged amplified by the batch, and
    forget (no explicit flag: it follows result.amplified) returning
    exactly that charge, in both packages."""
    node = amplified_node("amp", zone_cpu=8000.0, zones=2, ratio=2.0)
    running = Pod(meta=ObjectMeta(name="r"), requests={JRK.CPU: 4000.0},
                  qos_label="LSR", required_cpu_bind=True, phase="Running",
                  node_name="amp", allocated_numa_zone=0)
    _, snap, batch = _built([node], [bind_pod("p", 6000.0, 1024.0)],
                            running=[running])
    want, got = _both(snap, batch, num_rounds=2, enable_amplification=True)
    assert_bits_equal(tree(got), ref_tree(want))
    assert float(got.snapshot.nodes.requested[0, CPU]) == 8000.0 + 12000.0
    mask = np.ones((batch.valid.shape[0],), bool)
    want_back = jdelta.forget_pods(want.snapshot, batch, want,
                                   jnp.asarray(mask))
    got_back = delta.forget_pods(got.snapshot, to_port("PodBatch", batch),
                                 got, torch.from_numpy(mask))
    assert_bits_equal(tree(got_back), ref_tree(want_back))
    assert float(got_back.nodes.requested[0, CPU]) == 8000.0


# --- a small amplified full-gate batch --------------------------------------

NODES, PODS, CHUNK = 96, 1024, 256


def amplified_reference_cluster(nodes, seed=0, **kw):
    """The reference's full-gate cluster with the port's amplification
    draw applied as numpy arrays."""
    snap = jsyn.full_gate_cluster(nodes, seed=seed, **kw)
    ratio, alloc = synthetic.amplified_cpu(np.asarray(snap.nodes.allocatable))
    return snap.replace(nodes=snap.nodes.replace(
        cpu_amplification=jnp.asarray(ratio),
        allocatable=jnp.asarray(alloc)))


@functools.lru_cache(maxsize=None)
def _full_gate_chunk():
    """The first packed chunk of the amplified full gate at NODES x PODS,
    both packages' inputs and the step's knobs (FULL_GATE_KW, the three
    prefixes, the domain classes, amplification on)."""
    jsnap = amplified_reference_cluster(NODES)
    jpods = jsyn.full_gate_pods(PODS, NODES, seed=1)
    packed, prefixes, _ = jsyn.pack_gate_prefixes(jpods, CHUNK)
    kw = dict(configs.FULL_GATE_KW, enable_amplification=True,
              topo_prefix=prefixes["topo"], numa_prefix=prefixes["numa"],
              gpu_prefix=prefixes["gpu"], dom_classes=jsyn.dom_classes(packed))
    chunk = packed.replace(**{k: v[0] for k, v in
                              jsyn.stack_pod_chunks(packed, CHUNK).items()})
    return jsnap, chunk, kw


@functools.lru_cache(maxsize=None)
def _full_gate_both():
    jsnap, jpods, kw = _full_gate_chunk()
    return _both(jsnap, jpods, **kw)


def test_amplified_full_gate_batch_equals_reference():
    """Every result field and the snapshot equal; the batch places
    CPU-bind pods on amplified nodes, charged at their ratio."""
    jsnap, jpods, _ = _full_gate_chunk()
    want, got = _full_gate_both()
    assert_bits_equal(tree(got), ref_tree(want))
    ratio = np.asarray(jsnap.nodes.cpu_amplification)
    assign = got.assignment.numpy()
    bind = np.asarray(jpods.numa_single) & (assign >= 0)
    assert (ratio[assign[bind]] > 1.0).any()


def test_amplified_full_gate_differs_from_unamplified():
    """The same batch without amplification places differently: the
    comparison above is not of a path amplification leaves alone."""
    jsnap, jpods, kw = _full_gate_chunk()
    _, got = _full_gate_both()
    plain = core.schedule_batch(
        to_port("ClusterSnapshot", jsnap), to_port("PodBatch", jpods),
        LoadAwareConfig.make(device="cpu"),
        **dict(kw, enable_amplification=False))
    assert not torch.equal(plain.snapshot.nodes.requested,
                           got.snapshot.nodes.requested)


@pytest.mark.parametrize("share", [0.5, 1.0])
def test_amplified_full_gate_forget_equals_reference(share):
    """forget_pods of the amplified batch's result (a share of its pods)
    equals the reference's, following result.amplified."""
    _, jpods, _ = _full_gate_chunk()
    want, got = _full_gate_both()
    mask = np.random.default_rng(5).uniform(size=CHUNK) < share
    want_back = jdelta.forget_pods(want.snapshot, jpods, want,
                                   jnp.asarray(mask))
    got_back = delta.forget_pods(got.snapshot, to_port("PodBatch", jpods),
                                 got, torch.from_numpy(mask))
    assert_bits_equal(tree(got_back), ref_tree(want_back))


def test_guarded_amplified_batch_equals_reference():
    """guarded_schedule_batch with amplification on tests/test_guards.py's
    small full-gate inputs, amplified: result, health and masks equal
    the reference's, and the result equals the unguarded batch."""
    kw = dict(num_rounds=2, k_choices=4, enable_amplification=True)
    jsnap = amplified_reference_cluster(32, seed=8, num_quotas=4,
                                        num_gangs=4)
    jpods = jsyn.full_gate_pods(64, 32, seed=15, num_quotas=4, num_gangs=4)
    j_res, j_health, j_nb, j_pb = jguards.guarded_schedule_batch(
        jsnap, jpods, JCfg.make(), **kw)
    snap, pods = to_port("ClusterSnapshot", jsnap), to_port("PodBatch", jpods)
    cfg = LoadAwareConfig.make(device="cpu")
    res, health, nb, pb = guards.guarded_schedule_batch(snap, pods, cfg, **kw)
    assert_bits_equal(tree(res), ref_tree(j_res))
    assert res.amplified
    np.testing.assert_array_equal(health.numpy(),
                                  np.asarray(j_health).astype(np.int64))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(j_nb))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(j_pb))
    plain = core.schedule_batch(snap, pods, cfg, **kw)
    assert_bits_equal(tree(res), tree(plain))


def test_amplified_full_gate_run_on_the_host():
    """configs.run_full_gate(amplified=True) at a cut size: its line, and
    amplification's invariant on the final snapshot: each node's CPU
    requested equals the recount of its placed pods' charges (a CPU-bind
    pod's request times the node's ratio, in f32), within the f32 sums'
    rounding, and no node is overcommitted."""
    line, run, setup = configs.run_full_gate(600, 64, 300, device="cpu",
                                             amplified=True)
    assert line["metric"] == configs.FULL_GATE_AMPLIFIED_METRIC
    assert line["amplified"] and line["placed"] > 0
    assert setup["step_kw"]["enable_amplification"]
    snap0, pods = setup["snap"], setup["pods"]
    assign = run.assignment
    on_node = (assign >= 0) & (run.res_slot < 0)
    ratio = snap0.nodes.cpu_amplification
    f = torch.where(pods.numa_single, ratio[assign.clamp_min(0).long()], 1.0)
    charge = torch.where(on_node, pods.requests[:, CPU] * f, 0.0)
    want = snap0.nodes.requested[:, CPU].double().index_add(
        0, assign.clamp_min(0).long(), charge.double())
    got = run.snapshot.nodes.requested[:, CPU].double()
    assert torch.allclose(got, want, rtol=0, atol=1e-3)
    assert core.overcommit_ok(run.snapshot)
    assert bool(((ratio > 1.0)[assign[on_node].long()]
                 & pods.numa_single[on_node]).any())
