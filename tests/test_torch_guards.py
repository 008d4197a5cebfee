"""The port's device health guards (`scheduler/guards.py`, kernels K14
`guard_nodes` and K15 `guard_pods` through their plain versions)
against the JAX package's `scheduler/guards.py`, on the inputs of
tests/test_guards.py (full_gate_cluster(32), 64 full-gate pods) carried
over as numpy arrays, and the port's fault injector against the
reference's (the same seed corrupts the same rows).

Tolerances: none. Every f32 field is compared bit for bit (signs of
zero and NaN payloads included), every other field exactly."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.scheduler import guards as jguards
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.testing import faults as jfaults
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch import configs
from koordinator_tpu_torch.kernels._xla import scrub, xla_max, xla_min
from koordinator_tpu_torch.scheduler import core, guards
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.testing import faults
from koordinator_tpu_torch.utils import synthetic

from torch_port_ref import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_bits_equal,
    numpy_tree,
    one_torch_thread,
    ref_tree,
    to_port,
    tree,
    with_zones,
)

N, P = 32, 64
KW = dict(num_rounds=2, k_choices=4)



def make_inputs(seed=0, zones=None):
    """tests/test_guards.py's inputs: (reference snap, pods, port snap,
    pods); with `zones`, that many NUMA zones a node (`with_zones`)."""
    snap = jsyn.full_gate_cluster(N, seed=seed, num_quotas=4, num_gangs=4)
    if zones is not None:
        snap = with_zones(snap, zones, seed + 50)
    pods = jsyn.full_gate_pods(P, N, seed=seed + 7, num_quotas=4,
                               num_gangs=4)
    return (snap, pods, to_port("ClusterSnapshot", snap),
            to_port("PodBatch", pods))


# --- the word and the float rules -----------------------------------------


def test_word_layout_and_names_equal_reference():
    assert guards.DEFECT_NAMES == jguards.DEFECT_NAMES
    for name in ("NODE_METRIC_NONFINITE", "NODE_BAD_ALLOCATABLE",
                 "NODE_BAD_REQUESTED", "NODE_OVERCOMMIT",
                 "NODE_NUMA_INVALID", "POD_NONFINITE", "POD_NEGATIVE",
                 "POD_ID_RANGE", "POD_DOMAIN_RANGE", "OVERCOMMIT_TOL",
                 "HEALTH_OK"):
        assert getattr(guards, name) == getattr(jguards, name), name
    word = guards.NODE_OVERCOMMIT | guards.POD_ID_RANGE
    assert guards.decode_health_word(word) == ("node_overcommit",
                                               "pod_id_range")
    assert guards.decode_health_word(0) == ()
    assert faults.EXPECTED_BIT == jfaults.EXPECTED_BIT
    assert (faults.SNAPSHOT_FAULTS, faults.BATCH_FAULTS,
            faults.DELTA_FAULTS) == (jfaults.SNAPSHOT_FAULTS,
                                     jfaults.BATCH_FAULTS,
                                     jfaults.DELTA_FAULTS)


def _specials():
    """Signed zeros, NaN payloads, infinities and normal values. No
    subnormals: XLA:CPU reads and writes them as zeros (DAZ and FTZ),
    the port as they are (ROADMAP section C)."""
    payload = np.array([0x7fc01234, 0xffc00077], np.uint32).view(np.float32)
    return np.array([0.0, -0.0, 1.0, -1.0, 2.5, np.inf, -np.inf, np.nan,
                     *payload, 1e-30, -1e-30], np.float32)


@pytest.mark.parametrize("op", ["max", "min"])
def test_xla_max_min_equal_jnp_on_signed_zeros_and_nans(op):
    """torch.maximum(-0.0, 0.0) is -0.0 and torch.minimum keeps its first
    argument on a +-0 pair; the port's helpers follow XLA:CPU on every
    pair of specials, both orders."""
    s = _specials()
    a, b = np.meshgrid(s, s, indexing="ij")
    want = np.asarray((jnp.maximum if op == "max" else jnp.minimum)(
        jnp.asarray(a), jnp.asarray(b)))
    got = (xla_max if op == "max" else xla_min)(torch.from_numpy(a),
                                                torch.from_numpy(b))
    assert_bits_equal(got.numpy(), want)


def test_scrub_equals_reference():
    s = _specials()
    want = np.asarray(jnp.maximum(jnp.nan_to_num(
        jnp.asarray(s), nan=0.0, posinf=0.0, neginf=0.0), 0.0))
    assert_bits_equal(scrub(torch.from_numpy(s)).numpy(), want)


# --- scans and quarantine -------------------------------------------------


def test_healthy_inputs_scan_clean():
    jsnap, jpods, snap, pods = make_inputs()
    for (word, mask), (jword, jmask) in (
            (guards.snapshot_health(snap), jguards.snapshot_health(jsnap)),
            (guards.batch_health(snap, pods),
             jguards.batch_health(jsnap, jpods))):
        assert int(word) == int(jword) == guards.HEALTH_OK
        assert not mask.any()
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_apply_quarantine_is_identity_on_false_masks():
    _, _, snap, pods = make_inputs(5)
    q_snap, q_pods = guards.apply_quarantine(
        snap, pods, torch.zeros(N, dtype=torch.bool),
        torch.zeros(P, dtype=torch.bool))
    assert_bits_equal(tree(q_snap), tree(snap))
    assert_bits_equal(tree(q_pods), tree(pods))


def _quarantine_equal(jsnap, jpods, snap, pods, node_bad, pod_bad):
    j_snap, j_pods = jguards.apply_quarantine(
        jsnap, jpods, jnp.asarray(node_bad), jnp.asarray(pod_bad))
    q_snap, q_pods = guards.apply_quarantine(
        snap, pods, torch.from_numpy(node_bad), torch.from_numpy(pod_bad))
    assert_bits_equal(tree(q_snap), ref_tree(j_snap))
    assert_bits_equal(tree(q_pods), ref_tree(j_pods))


@pytest.mark.parametrize("seed", [11, 29])
@pytest.mark.parametrize("kind", faults.SNAPSHOT_FAULTS)
def test_snapshot_fault_equals_reference(kind, seed):
    """The same injector seed corrupts the same rows on both sides; the
    word, the mask and every quarantined field equal the reference's."""
    jsnap, jpods, snap, pods = make_inputs(2)
    j_bad, j_rows = jfaults.FaultInjector(seed).corrupt_snapshot(
        jsnap, kind, n_rows=3)
    bad, rows = faults.FaultInjector(seed).corrupt_snapshot(snap, kind,
                                                            n_rows=3)
    np.testing.assert_array_equal(rows, j_rows)
    assert_bits_equal(tree(bad), ref_tree(j_bad))
    word, mask = guards.snapshot_health(bad)
    j_word, j_mask = jguards.snapshot_health(j_bad)
    assert int(word) == int(j_word)
    assert int(word) & faults.EXPECTED_BIT[kind]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    assert set(np.flatnonzero(mask.numpy())) == set(rows.tolist())
    _quarantine_equal(j_bad, jpods, bad, pods, mask.numpy(),
                      np.zeros(P, bool))


@pytest.mark.parametrize("kind", faults.SNAPSHOT_FAULTS)
def test_snapshot_fault_at_eight_zones_equals_reference(kind):
    """K14's plain version at eight NUMA zones a node (two sockets at
    NPS4 or SNC-4; fault C8's width): each snapshot fault's word, mask
    and quarantined fields equal the reference's."""
    jsnap, jpods, snap, pods = make_inputs(4, zones=8)
    j_bad, _ = jfaults.FaultInjector(17).corrupt_snapshot(jsnap, kind,
                                                          n_rows=3)
    bad, rows = faults.FaultInjector(17).corrupt_snapshot(snap, kind,
                                                          n_rows=3)
    assert_bits_equal(tree(bad), ref_tree(j_bad))
    word, mask = guards.snapshot_health(bad)
    j_word, j_mask = jguards.snapshot_health(j_bad)
    assert int(word) == int(j_word)
    assert int(word) & faults.EXPECTED_BIT[kind]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    _quarantine_equal(j_bad, jpods, bad, pods, mask.numpy(),
                      np.zeros(P, bool))


@pytest.mark.parametrize("seed", [13, 31])
@pytest.mark.parametrize("kind", faults.BATCH_FAULTS)
def test_batch_fault_equals_reference(kind, seed):
    jsnap, jpods, snap, pods = make_inputs(3)
    j_bad, j_rows = jfaults.FaultInjector(seed).corrupt_batch(
        jpods, kind, n_rows=3)
    bad, rows = faults.FaultInjector(seed).corrupt_batch(pods, kind,
                                                         n_rows=3)
    np.testing.assert_array_equal(rows, j_rows)
    assert_bits_equal(tree(bad), ref_tree(j_bad))
    word, mask = guards.batch_health(snap, bad)
    j_word, j_mask = jguards.batch_health(jsnap, j_bad)
    assert int(word) == int(j_word)
    assert int(word) & faults.EXPECTED_BIT[kind]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    assert set(rows.tolist()) <= set(np.flatnonzero(mask.numpy()))
    _quarantine_equal(jsnap, j_bad, snap, bad, np.zeros(N, bool),
                      mask.numpy())


def test_scrub_of_signed_zeros_and_nans_equals_reference():
    """Bad rows holding -0.0, NaN payloads and infinities, next to
    healthy rows holding the same (copied untouched): every field of
    the quarantine equals the reference's bit for bit."""
    jsnap, jpods, _, _ = make_inputs(4)
    special = _specials()
    tr = numpy_tree(jsnap)
    ptr = numpy_tree(jpods)
    for f in ("usage", "requested", "allocatable", "agg_usage"):
        rows = tr["nodes"][f].reshape(N, -1)
        k = min(len(special), rows.shape[1])
        rows[:4, :k] = special[None, :k]
    tr["nodes"]["numa_free"][:4, 0] = [[-0.0, np.nan], [-np.inf, 0.0],
                                       [-0.0, -0.0], [1e9, -5.0]]
    tr["nodes"]["numa_cap"][:4, 0, 0] = [-0.0, np.nan, 0.0, 3.0]
    for f in ("requests", "estimated"):
        k = min(len(special), ptr[f].shape[1])
        ptr[f][:4, :k] = special[None, :k]
    ptr["gpu_ratio"][:4] = [-0.0, np.nan, -np.inf, 0.0]
    jsnap = jsnap.replace(nodes=jsnap.nodes.replace(
        **{f: jnp.asarray(v) for f, v in tr["nodes"].items()}))
    jpods = jpods.replace(**{f: jnp.asarray(ptr[f]) for f in (
        "requests", "estimated", "gpu_ratio")})
    snap, pods = to_port("ClusterSnapshot", jsnap), to_port("PodBatch", jpods)
    node_bad = np.zeros(N, bool)
    node_bad[[0, 2]] = True
    pod_bad = np.zeros(P, bool)
    pod_bad[[1, 3]] = True
    _quarantine_equal(jsnap, jpods, snap, pods, node_bad, pod_bad)
    _quarantine_equal(jsnap, jpods, snap, pods, ~node_bad, ~pod_bad)


def test_id_range_allows_the_none_sentinel():
    _, _, snap, pods = make_inputs(4)
    neg1 = torch.full_like(pods.gang_id, -1)
    pods = pods.replace(gang_id=neg1, quota_id=neg1, selector_id=neg1)
    word, mask = guards.batch_health(snap, pods)
    assert not int(word) & guards.POD_ID_RANGE
    assert not mask.any()


# --- the guarded batch ----------------------------------------------------


def _result_equal(res, j_res):
    want = ref_tree(j_res)
    got = tree(res)
    assert_bits_equal(got, want)


@pytest.mark.parametrize("node_fault,pod_fault", [
    (None, None), ("nan_metric_column", "nan_pod_request"),
    ("negative_allocatable", "bad_gang_id")],
    ids=["healthy", "nan", "ids"])
def test_guarded_schedule_batch_equals_reference(node_fault, pod_fault):
    """Healthy: the result equals the reference's and the unguarded
    one's. Under a snapshot fault on 2 rows and a batch fault on 3
    (test_guards.py's oracle case, and a gang id far beyond the table,
    which the reference's gathers clamp): result, health and masks equal
    the reference's."""
    faulty = node_fault is not None
    jsnap, jpods, snap, pods = make_inputs(9 if faulty else 8)
    if faulty:
        inj, jinj = faults.FaultInjector(23), jfaults.FaultInjector(23)
        snap, _ = inj.corrupt_snapshot(snap, node_fault, n_rows=2)
        jsnap, _ = jinj.corrupt_snapshot(jsnap, node_fault, n_rows=2)
        pods, _ = inj.corrupt_batch(pods, pod_fault, n_rows=3)
        jpods, _ = jinj.corrupt_batch(jpods, pod_fault, n_rows=3)
    j_res, j_health, j_nb, j_pb = jguards.guarded_schedule_batch(
        jsnap, jpods, JCfg.make(), **KW)
    res, health, nb, pb = guards.guarded_schedule_batch(
        snap, pods, LoadAwareConfig.make(device="cpu"), **KW)
    _result_equal(res, j_res)
    assert health.dtype == torch.int32
    np.testing.assert_array_equal(health.numpy(),
                                  np.asarray(j_health).astype(np.int64))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(j_nb))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(j_pb))
    if not faulty:
        plain = core.schedule_batch(snap, pods,
                                    LoadAwareConfig.make(device="cpu"), **KW)
        assert_bits_equal(tree(res), tree(plain))
    else:
        assert int(health[0]) & faults.EXPECTED_BIT[node_fault]
        assert int(health[0]) & faults.EXPECTED_BIT[pod_fault]
        assert int(health[1]) == 2 and int(health[2]) == 3


# --- the masked oracle at the full gate (port only) -----------------------

GATE_NODES, GATE_PODS, GATE_CHUNK = 96, 1024, 256


def _full_gate_chunk():
    snap, pods = synthetic.gpu_share_inputs(GATE_PODS, GATE_NODES,
                                            device="cpu")
    packed, _, _, step_kw, _ = configs.pack_full_gate(snap, pods, GATE_CHUNK)
    return snap, synthetic.slice_batch(packed, 0, GATE_CHUNK), step_kw


@pytest.mark.parametrize("kind", faults.SNAPSHOT_FAULTS + faults.BATCH_FAULTS)
def test_guarded_full_gate_matches_masked_oracle(kind):
    """With the full gate's kwargs (the cascade, the three prefixes and
    the domain classes): the guarded batch on corrupted inputs places
    every clean row as the unguarded batch does on the clean inputs with
    the corrupted rows masked by hand (tools/chaos_smoke.py's oracle);
    the fault's bit is set, its nodes end unschedulable and its pods
    unplaced."""
    snap, batch, step_kw = _full_gate_chunk()
    cfg = LoadAwareConfig.make(device="cpu")
    inj = faults.FaultInjector(7)
    sched, valid = snap.nodes.schedulable.clone(), batch.valid.clone()
    if kind in faults.SNAPSHOT_FAULTS:
        bad_snap, rows = inj.corrupt_snapshot(snap, kind, n_rows=2)
        bad_batch = batch
        sched[torch.from_numpy(rows)] = False
    else:
        bad_batch, rows = inj.corrupt_batch(batch, kind, n_rows=2)
        bad_snap = snap
        valid[torch.from_numpy(rows)] = False
    res, health, _, _ = guards.guarded_schedule_batch(bad_snap, bad_batch,
                                                      cfg, **step_kw)
    oracle = core.schedule_batch(
        snap.replace(nodes=snap.nodes.replace(schedulable=sched)),
        batch.replace(valid=valid), cfg, **step_kw)
    assert int(health[0]) & faults.EXPECTED_BIT[kind]
    assert torch.equal(res.assignment, oracle.assignment)
    assert (res.assignment >= 0).sum() > 0
    if kind in faults.SNAPSHOT_FAULTS:
        assert not res.snapshot.nodes.schedulable[torch.from_numpy(
            rows)].any()
    else:
        assert (res.assignment[torch.from_numpy(rows)] == -1).all()
        assert len(rows) > 0
