"""The port's snapshot deltas, forget and store (`snapshot/delta.py`,
`snapshot/store.py`; kernel K16 `delta_rows` and K3 through their plain
versions) against the JAX package's, and the guarded cycle
(`configs.run_guarded_cycles`) at a cut size against the same sequence
run through the reference's store, guards and deltas.

Tolerances: none. Every f32 field is compared bit for bit (signs of
zero included), every other field exactly."""

from __future__ import annotations

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler import guards as jguards
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.snapshot import delta as jdelta
from koordinator_tpu.snapshot import schema as jschema
from koordinator_tpu.snapshot.store import SnapshotStore as JStore
from koordinator_tpu.testing import faults as jfaults
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch import configs
from koordinator_tpu_torch.bridge import to_numpy
from koordinator_tpu_torch.kernels.delta_rows import delta_rows_plain
from koordinator_tpu_torch.snapshot import delta, schema
from koordinator_tpu_torch.snapshot.store import SnapshotStore
from koordinator_tpu_torch.utils import synthetic

from torch_port_ref import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_bits_equal,
    one_torch_thread,
    ref_tree,
    to_port,
    tree,
)

N, P = 32, 64
KW = dict(num_rounds=2, k_choices=4)



def to_reference(name: str, fields: dict):
    """The reference struct `name` from a port struct's numpy tree."""
    cls = jschema.STRUCT_CLASSES[name]
    specs = jschema.STRUCT_SPECS[name]
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if specs.get(f.name) in jschema.STRUCT_SPECS and v is not None:
            kw[f.name] = to_reference(specs[f.name], v)
        elif isinstance(v, np.ndarray):
            kw[f.name] = jnp.asarray(v)
        else:
            kw[f.name] = v
    return cls(**kw)


def port_ref(name: str, x):
    """(port struct on the host, its reference twin)."""
    return x, to_reference(name, to_numpy(x))


@pytest.mark.parametrize("name", ["NodeMetricDelta", "NodeTopologyDelta"])
def test_delta_specs_match_reference(name):
    assert schema.STRUCT_SPECS[name] == jschema.STRUCT_SPECS[name]
    fields = {f.name for f in dataclasses.fields(getattr(delta, name))}
    assert fields == set(jschema.STRUCT_SPECS[name])


# --- the row replacement ----------------------------------------------------


def _snapshot():
    return synthetic.full_gate_cluster(N, seed=3, device="cpu")


def _with_repeats(idx: torch.Tensor) -> torch.Tensor:
    """idx with repeated indices (three rows naming one node, the last
    of them winning), a -1 pad, and indices past the table and below -1
    (both dropped)."""
    out = idx.clone()
    out[1] = out[0]
    out[4] = out[0]
    out[2] = -1
    out[3] = N + 5
    out[5] = -7
    return out


def test_last_writer_wins_on_repeats():
    """XLA:CPU's set-scatter with indices [2, 4, 2, 6, 2] into 6 rows:
    row 2 holds the fifth row, index 6 is dropped."""
    col = torch.zeros((6, 2))
    rows = torch.arange(10, dtype=torch.float32).view(5, 2) + 1.0
    idx = torch.tensor([2, 4, 2, 6, 2], dtype=torch.int32)
    (got,) = delta_rows_plain([(col, rows, 0)], [idx])
    want = np.asarray(jnp.zeros((6, 2)).at[jnp.asarray(idx)].set(
        jnp.asarray(rows), mode="drop"))
    assert_bits_equal(got.numpy(), want)
    assert got[2].tolist() == [9.0, 10.0]


@pytest.mark.parametrize("repeats", [False, True])
def test_metric_delta_equals_reference(repeats):
    snap, jsnap = port_ref("ClusterSnapshot", _snapshot())
    d = synthetic.metric_delta_rows(snap, 12, seed=5, version=1)
    if repeats:
        d = d.replace(idx=_with_repeats(d.idx))
    d, jd = port_ref("NodeMetricDelta", d)
    got = delta.apply_metric_delta(snap, d)
    want = jdelta.apply_metric_delta(jsnap, jd)
    assert_bits_equal(tree(got), ref_tree(want))
    assert int(got.version) == int(snap.version) + 1
    assert_bits_equal(tree(snap), ref_tree(jsnap))  # the input untouched


@pytest.mark.parametrize("repeats", [False, True])
def test_topology_delta_equals_reference(repeats):
    snap, jsnap = port_ref("ClusterSnapshot", _snapshot())
    d = synthetic.topology_delta_rows(snap, 10, seed=6, version=2)
    assert d.schedulable.any() and not d.schedulable.all()
    if repeats:
        d = d.replace(idx=_with_repeats(d.idx),
                      metric=d.metric.replace(idx=_with_repeats(d.idx)))
    d, jd = port_ref("NodeTopologyDelta", d)
    got = delta.apply_topology_delta(snap, d)
    want = jdelta.apply_topology_delta(jsnap, jd)
    assert_bits_equal(tree(got), ref_tree(want))


def test_delta_rows_avoid_slot_hosts():
    snap = synthetic.full_gate_cluster(64, seed=0, device="cpu")
    hosts = set(snap.reservations.node[snap.reservations.valid].tolist())
    for d in (synthetic.metric_delta_rows(snap, 24, 1, 1),
              synthetic.topology_delta_rows(snap, 24, 2, 2)):
        idx = d.idx.tolist()
        assert len(set(idx)) == 24 and not hosts & set(idx)


# --- the store's version guard (tests/test_delta.py:133-233) --------------


def _store_and_deltas():
    snap = _snapshot()
    store = SnapshotStore(device="cpu")
    store.publish(snap)
    d1 = synthetic.metric_delta_rows(snap, 4, seed=1, version=1)
    d2 = synthetic.metric_delta_rows(snap, 4, seed=2, version=2)
    return store, snap, d1, d2


def test_stale_and_duplicate_deltas_noop_idempotently():
    store, _, d1, d2 = _store_and_deltas()
    store.ingest(d2)
    assert store.take_delta_rejection() is None
    v_after = store.version
    fresh = store.current()
    out = store.ingest(d1)
    assert store.take_delta_rejection() is delta.DeltaRejectReason.STALE_VERSION
    assert store.version == v_after and out is fresh
    store.ingest(d2)
    assert store.take_delta_rejection() \
        is delta.DeltaRejectReason.DUPLICATE_VERSION
    assert store.version == v_after and store.delta_rejections == 2
    assert store.current() is fresh
    assert int(store.current().version) == int(fresh.version)


def test_publish_opens_a_new_delta_epoch():
    store, snap, d1, d2 = _store_and_deltas()
    store.ingest(d1)
    store.ingest(d2)
    assert store.applied_delta_version == 2
    store.publish(snap)
    assert store.applied_delta_version == 0
    store.ingest(d1)
    assert store.take_delta_rejection() is None
    assert store.applied_delta_version == 1


def test_unversioned_delta_always_applies():
    store, _, d1, _ = _store_and_deltas()
    d = d1.replace(source_version=None)
    v0 = store.version
    for _ in range(2):
        store.ingest(d)
        assert store.take_delta_rejection() is None
    assert store.version == v0 + 2 and store.applied_delta_version == 0


def test_store_refuses_before_publish():
    store = SnapshotStore(device="cpu")
    with pytest.raises(RuntimeError, match="no snapshot"):
        store.current()
    assert not store.restore("/nonexistent/checkpoint")


# --- forget ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _scheduled():
    """tests/test_guards.py's inputs at seed 6 scheduled by the
    reference (slots, two NUMA zones, GPU pods), in both packages."""
    jsnap = jsyn.full_gate_cluster(N, seed=6, num_quotas=4, num_gangs=4)
    jpods = jsyn.full_gate_pods(P, N, seed=13, num_quotas=4, num_gangs=4)
    jres = jcore.schedule_batch(jsnap, jpods, JCfg.make(), **KW)
    return (jpods, jres, to_port("PodBatch", jpods),
            to_port("ScheduleResult", jres))


@pytest.mark.parametrize("share", [0.5, 1.0])
def test_forget_pods_equals_reference(share):
    jpods, jres, pods, res = _scheduled()
    assign = np.asarray(jres.assignment)
    placed = assign >= 0
    assert (np.asarray(jres.res_slot) >= 0).any()
    assert (np.asarray(jres.gpu_take).any(axis=1) & placed).any()
    assert (np.asarray(jres.numa_take).any(axis=(1, 2)) & placed).any()
    mask = np.random.default_rng(3).uniform(size=P) < share
    want = jdelta.forget_pods(jres.snapshot, jpods, jres, jnp.asarray(mask))
    got = delta.forget_pods(res.snapshot, pods, res, torch.from_numpy(mask))
    assert_bits_equal(tree(got), ref_tree(want))


def test_forget_refuses_amplification():
    """Forget with amplification is ported (ROADMAP B21): on the inputs
    above with the nodes' CPU amplified (`utils.synthetic.amplified_cpu`)
    and the batch scheduled with amplification by the reference, forget
    with `enable_amplification=True` given explicitly equals the
    reference's, and returns the bind pods' amplified charges."""
    jsnap = jsyn.full_gate_cluster(N, seed=6, num_quotas=4, num_gangs=4)
    ratio, alloc = synthetic.amplified_cpu(np.asarray(jsnap.nodes.allocatable),
                                           seed=2)
    jsnap = jsnap.replace(nodes=jsnap.nodes.replace(
        cpu_amplification=jnp.asarray(ratio), allocatable=jnp.asarray(alloc)))
    jpods = jsyn.full_gate_pods(P, N, seed=13, num_quotas=4, num_gangs=4)
    jres = jcore.schedule_batch(jsnap, jpods, JCfg.make(),
                                enable_amplification=True, **KW)
    pods, res = to_port("PodBatch", jpods), to_port("ScheduleResult", jres)
    mask = np.ones(P, bool)
    want = jdelta.forget_pods(jres.snapshot, jpods, jres, jnp.asarray(mask),
                              enable_amplification=True)
    got = delta.forget_pods(res.snapshot, pods, res, torch.from_numpy(mask),
                            enable_amplification=True)
    assert_bits_equal(tree(got), ref_tree(want))
    assign = np.asarray(jres.assignment)
    bind = np.asarray(jpods.numa_single) & (assign >= 0)
    assert (ratio[assign[bind]] > 1.0).any()


# --- checkpoints across the packages --------------------------------------


def _snap_pair():
    jsnap = jsyn.full_gate_cluster(N, seed=8, num_quotas=4, num_gangs=4)
    return to_port("ClusterSnapshot", jsnap), jsnap


def test_port_checkpoint_restores_in_reference(tmp_path):
    snap, _ = _snap_pair()
    store = SnapshotStore(device="cpu")
    store.publish(snap)
    store.ingest(synthetic.metric_delta_rows(snap, 4, seed=1, version=3))
    path = store.checkpoint(str(tmp_path / "port.ckpt"))
    ref = JStore()
    assert ref.restore(path)
    assert ref.version == store.version == 2
    assert ref.applied_delta_version == store.applied_delta_version == 3
    assert_bits_equal(ref_tree(ref.current()), tree(store.current()))


def test_reference_checkpoint_restores_in_port(tmp_path):
    snap, jsnap = _snap_pair()
    ref = JStore()
    ref.publish(jsnap)
    d = synthetic.metric_delta_rows(snap, 4, seed=2, version=5)
    ref.ingest(to_reference("NodeMetricDelta", to_numpy(d)))
    path = ref.checkpoint(str(tmp_path / "ref.ckpt"))
    store = SnapshotStore(device="cpu")
    assert store.restore(path)
    assert store.version == ref.version == 2
    assert store.applied_delta_version == 5
    assert store.last_checkpoint_version == 2
    assert_bits_equal(tree(store.current()), ref_tree(ref.current()))
    # the watermark came back: the same delta replays as a duplicate
    store.ingest(d)
    assert store.take_delta_rejection() \
        is delta.DeltaRejectReason.DUPLICATE_VERSION


@pytest.mark.parametrize("damage", ["corrupt", "torn", "magic"])
def test_damaged_checkpoint_does_not_restore(tmp_path, damage):
    snap, _ = _snap_pair()
    store = SnapshotStore(device="cpu")
    store.publish(snap)
    path = store.checkpoint(str(tmp_path / "x.ckpt"))
    data = bytearray(open(path, "rb").read())
    if damage == "corrupt":
        data[len(data) // 2] ^= 0xFF
    elif damage == "torn":
        data = data[:len(data) - 100]
    else:
        data[0] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    fresh = SnapshotStore(device="cpu")
    assert not fresh.restore(path)
    assert not JStore().restore(path)
    with pytest.raises(RuntimeError):
        fresh.current()
    assert os.path.exists(path)


def test_maybe_checkpoint_cadence_equals_reference(tmp_path):
    """Every `checkpoint_every` versions, as the reference's store
    counts them; never without a path."""
    snap, jsnap = _snap_pair()
    store = SnapshotStore(device="cpu", checkpoint_every=3,
                          checkpoint_path=str(tmp_path / "port.ckpt"))
    ref = JStore(checkpoint_every=3,
                 checkpoint_path=str(tmp_path / "ref.ckpt"))
    seen = {}
    for name, s, first in (("port", store, snap), ("ref", ref, jsnap)):
        s.publish(first)
        seen[name] = [(s.maybe_checkpoint(), s.last_checkpoint_version,
                       s.checkpoints_written)]
        for _ in range(6):
            s.update(lambda x: x)
            seen[name].append((s.maybe_checkpoint(),
                               s.last_checkpoint_version,
                               s.checkpoints_written))
    assert seen["port"] == seen["ref"] == [
        (False, 0, 0), (False, 0, 0), (True, 3, 1), (False, 3, 1),
        (False, 3, 1), (True, 6, 2), (False, 6, 2)]
    fresh = SnapshotStore(device="cpu")
    assert fresh.restore(str(tmp_path / "port.ckpt"))
    assert fresh.version == 6
    no_path = SnapshotStore(device="cpu", checkpoint_every=1)
    no_path.publish(snap)
    assert not no_path.maybe_checkpoint()


def test_kill_mid_checkpoint_leaves_a_torn_file_and_the_last_whole(
        tmp_path):
    """The crash hook's mid_checkpoint point, killing the second
    checkpoint: its half-written file restores in neither package, and
    the first checkpoint stays whole at its path."""
    class Killed(Exception):
        pass

    points = []

    def hook(point):
        points.append(point)
        if len(points) == 2:
            raise Killed(point)
    snap, _ = _snap_pair()
    path = str(tmp_path / "x.ckpt")
    store = SnapshotStore(device="cpu", checkpoint_path=path,
                          crash_hook=hook)
    store.publish(snap)
    assert store.maybe_checkpoint()
    store.ingest(synthetic.metric_delta_rows(snap, 4, seed=1, version=3))
    with pytest.raises(Killed):
        store.maybe_checkpoint()
    assert points == ["mid_checkpoint", "mid_checkpoint"]
    assert store.last_checkpoint_version == 1
    assert store.checkpoints_written == 1
    torn = path + ".tmp"
    assert os.path.getsize(torn) < os.path.getsize(path)
    fresh = SnapshotStore(device="cpu")
    assert not fresh.restore(torn)
    assert not JStore().restore(torn)
    assert fresh.restore(path)
    assert fresh.version == 1 and fresh.applied_delta_version == 0
    assert_bits_equal(tree(fresh.current()), tree(snap))


# --- the guarded cycle against the reference's ----------------------------


@functools.lru_cache(maxsize=None)
def _port_cycle():
    return configs.run_guarded_cycles(num_nodes=64, batches=3, chunk=128,
                                      seed=0, device="cpu")


def test_guarded_cycles_equal_reference():
    """run_guarded_cycles(64 nodes, 3 batches of 128) on the host against
    the same sequence through the reference: the four ingests' reasons,
    each batch's clean snapshot, its fault rows, its result, health and
    masks, the snapshot after each forget, and the checkpoint restored
    by the reference."""
    line, run = _port_cycle()
    step_kw = run.setup["step_kw"]
    store = JStore()
    store.publish(to_reference("ClusterSnapshot",
                               to_numpy(run.setup["snap"])))
    inj = jfaults.FaultInjector(0)
    metric = to_reference("NodeMetricDelta", to_numpy(run.deltas["metric"]))
    stale = inj.stale_delta(metric, 1)
    assert int(np.asarray(stale.source_version)) == int(
        run.deltas["stale"].source_version)
    topo = to_reference("NodeTopologyDelta",
                        to_numpy(run.deltas["topology"]))
    reasons = []
    for d in (metric, metric, stale, topo):
        store.ingest(d)
        r = store.take_delta_rejection()
        reasons.append(None if r is None else r.value)
    assert reasons == [None if r is None else r.value
                       for r in run.rejections]
    assert reasons == [None, "duplicate_version", "stale_version", None]
    cfg = JCfg.make()
    counts = None
    for i, b in enumerate(run.batches):
        batch = to_reference("PodBatch", to_numpy(b["batch"]))
        if counts is None:
            counts = tuple(getattr(batch, f) for f in jcore.COUNT_FIELDS)
        batch = batch.replace(**dict(zip(jcore.COUNT_FIELDS, counts)))
        clean = store.current()
        assert_bits_equal(tree(b["snapshot"]), ref_tree(clean))
        run_snap, run_batch = clean, batch
        kind = b["kind"]
        assert kind == (jfaults.SNAPSHOT_FAULTS + jfaults.BATCH_FAULTS)[i]
        if kind in jfaults.SNAPSHOT_FAULTS:
            run_snap, rows = inj.corrupt_snapshot(clean, kind, i % 3 + 1)
        else:
            run_batch, rows = inj.corrupt_batch(batch, kind, i % 3 + 1)
        np.testing.assert_array_equal(b["rows"], rows)
        res, health, nb, pb = jguards.guarded_schedule_batch(
            run_snap, run_batch, cfg, **step_kw)
        assert_bits_equal(tree(b["result"]), ref_tree(res))
        np.testing.assert_array_equal(b["health"].numpy(),
                                      np.asarray(health).astype(np.int64))
        np.testing.assert_array_equal(b["node_bad"].numpy(), np.asarray(nb))
        np.testing.assert_array_equal(b["pod_bad"].numpy(), np.asarray(pb))
        assert int(health[0]) & jfaults.EXPECTED_BIT[kind]
        store.update(lambda _s, res=res: res.snapshot)
        counts = jcore.charge_all_counts(counts, run_batch, res.assignment)
        forgotten = store.forget(run_batch, res, np.asarray(b["forget"]))
        assert_bits_equal(tree(b["forgotten"]), ref_tree(forgotten))
    assert_bits_equal(tree(run.restored.current()), tree(run.store.current()))
    assert run.restored.version == run.store.version
    assert run.restored.applied_delta_version == 2
    assert line["deltas_applied"] == 2 and line["deltas_rejected"] == 2
    assert line["placed"] == sum(
        int((b["result"].assignment >= 0).sum()) for b in run.batches) > 0
    assert line["quarantined_nodes"] == sum(len(b["rows"])
                                            for b in run.batches)
    assert line["forgotten"] > 0


def test_guarded_cycles_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        configs.run_guarded_cycles(num_nodes=16, batches=1, chunk=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SnapshotStore()
