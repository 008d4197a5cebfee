"""The Filter->Score gate cascade in the port against the JAX package:
`ops/feasibility.py` (resource_fit, pod_ancestors, quota_ceiling_ok),
`scheduler/cascade.py` stage1_mask and candidate_counts (K9's plain
version), `schedule_batch` with the cascade and the packing prefixes
(`topo_prefix`, `numa_prefix`, `gpu_prefix`, `dom_classes`), and the
straggler tail with the topology budget, on the fixtures of
tests/test_cascade.py (P = 512, N = 96, chunks of 256, the sparse
full-gate workload packed by the reference's pack_gate_prefixes, the
16-node overcommitted tail).

Tolerances: none. Bools and ints are compared exactly, floats bit for
bit (array equality: a -0.0 where the reference adds a zero row equals
its +0.0)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import feasibility as jfeas
from koordinator_tpu.scheduler import cascade as jcascade
from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch.kernels.stage1 import stage1_mask_plain
from koordinator_tpu_torch.ops import feasibility
from koordinator_tpu_torch.scheduler import cascade, core
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.scheduler.domains import (
    COUNT_FIELDS,
    charge_all_counts,
)
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig

from torch_port_ref import to_port
from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)

P, N, CHUNK = 512, 96, 256
KW = dict(num_rounds=2, k_choices=8, score_dims=(0, 1), tie_break=True,
          quota_depth=2, fit_dims=(0, 1, 2, 3), enable_numa=True,
          enable_devices=True)
FIELDS = ("assignment", "chosen_score", "numa_zone", "numa_take",
          "gpu_take", "aux_inst", "res_slot", "gang_failed")


def _flat(x, prefix=""):
    """{dotted field: np.ndarray} of a result or snapshot of either
    package."""
    out = {}
    for f in x.__dataclass_fields__:
        v = getattr(x, f)
        if hasattr(v, "__dataclass_fields__"):
            out.update(_flat(v, f"{prefix}{f}."))
        elif isinstance(v, (torch.Tensor, jax.Array, np.ndarray)):
            out[prefix + f] = np.asarray(v.cpu() if isinstance(
                v, torch.Tensor) else v)
    return out


def assert_leaves_equal(want: dict, got: dict):
    """{name: array} of either package equal leaf by leaf: dtype, shape
    and values."""
    assert set(want) == set(got)
    for k, w in want.items():
        w, g = np.asarray(w), np.asarray(got[k])
        assert w.dtype == g.dtype and w.shape == g.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def assert_same(want, got):
    """Every per-pod result field and every snapshot leaf equal."""
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert_leaves_equal(_flat(want.snapshot), _flat(got.snapshot))


@functools.lru_cache(maxsize=None)
def sparse_workload(seed=1):
    """tests/test_cascade.py's sparse full-gate pods, packed: classes well
    below the chunk, so the prefixes are proper."""
    pods = jsyn.full_gate_pods(P, N, seed=seed, num_quotas=8, num_gangs=8,
                               n_anti_groups=4, anti_members=8,
                               n_aff_groups=2, aff_members=6,
                               spread_frac=0.08, numa_bind_frac=0.12,
                               gpu_pod_frac=0.08)
    packed, prefixes, masks = jsyn.pack_gate_prefixes(pods, CHUNK)
    assert prefixes["numa"] < CHUNK and prefixes["gpu"] < CHUNK
    return packed, prefixes, masks


@functools.lru_cache(maxsize=None)
def full_gate_cluster(seed=0, n=N):
    return jsyn.full_gate_cluster(n, seed=seed, num_quotas=8, num_gangs=8)


def prefix_kw(pods, prefixes):
    return dict(topo_prefix=prefixes["topo"],
                dom_classes=jsyn.dom_classes(pods),
                numa_prefix=prefixes["numa"], gpu_prefix=prefixes["gpu"])


def port_run(snap, batch, **kw):
    return core.schedule_batch(to_port("ClusterSnapshot", snap),
                               to_port("PodBatch", batch),
                               LoadAwareConfig.make(device="cpu"), **kw)


def ref_run(snap, batch, **kw):
    return jcore.schedule_batch(snap, batch, JCfg.make(), **kw)


# --- ops/feasibility and stage 1 ------------------------------------------


@pytest.mark.parametrize("fit_dims", [(0, 1, 2, 3), None], ids=str)
@pytest.mark.parametrize("quota_depth", [2, 6])
def test_feasibility_equal_reference(fit_dims, quota_depth):
    """resource_fit, pod_ancestors and quota_ceiling_ok against the
    reference's on a full-gate chunk, with loaded nodes and quotas."""
    pods, _, _ = sparse_workload()
    batch = jsyn.slice_batch(pods, 0, CHUNK)
    snap = full_gate_cluster()
    rng = np.random.default_rng(3)
    alloc = np.asarray(snap.nodes.allocatable)
    requested = np.floor(alloc * rng.uniform(0, 1, alloc.shape) / 500) * 500
    runtime = np.asarray(snap.quotas.runtime)
    full = rng.uniform(size=(runtime.shape[0], 1)) < 0.3
    used = np.where(np.isfinite(runtime),
                    np.where(full, runtime, np.floor(runtime * 0.5)),
                    0.0).astype(np.float32)
    jnodes = snap.nodes.replace(requested=jnp.asarray(requested, jnp.float32))
    jquotas = snap.quotas.replace(used=jnp.asarray(used))
    tnodes = to_port("NodeState", jnodes)
    tquotas = to_port("QuotaState", jquotas)
    tpods = to_port("PodBatch", batch)
    fit = feasibility.resource_fit(tnodes.allocatable, tnodes.requested,
                                   tpods.requests, fit_dims)
    want = jfeas.resource_fit(jnodes.allocatable, jnodes.requested,
                              batch.requests, fit_dims)
    np.testing.assert_array_equal(fit.numpy(), np.asarray(want))
    assert 0 < int(fit.sum()) < fit.numel()
    np.testing.assert_array_equal(
        feasibility.pod_ancestors(tquotas, tpods).numpy(),
        np.asarray(jfeas.pod_ancestors(jquotas, batch)))
    ok = feasibility.quota_ceiling_ok(tquotas, tpods, quota_depth, fit_dims)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(
        jfeas.quota_ceiling_ok(jquotas, batch, quota_depth, fit_dims)))
    assert 0 < int(ok.sum()) < ok.numel()


def _out_of_range_ids(snap, batch):
    """The snapshot and batch with table indices the reference's rule
    must resolve: selector ids below -1 (match all) and past the table
    (its last row), label and taint groups counted from the end or past
    the table (its last column), toleration ids below 0 (row 0) and past
    the table (its last row)."""
    rng = np.random.default_rng(11)
    s, labels = np.asarray(batch.selector_match).shape
    t, groups = np.asarray(batch.tol_forbid).shape

    def spread(x, values):
        x = np.asarray(x).copy()
        hit = rng.uniform(size=x.shape) < 0.3
        x[hit] = rng.choice(values, int(hit.sum()))
        return jnp.asarray(x.astype(np.int32))

    n = np.asarray(snap.nodes.label_group).shape[0]
    nodes = snap.nodes.replace(
        label_group=spread(snap.nodes.label_group,
                           [-1, -labels, labels, labels + 7]),
        taint_group=spread(snap.nodes.taint_group,
                           [-1, -groups, groups, groups + 3]))
    assert n == nodes.label_group.shape[0]
    batch = batch.replace(
        selector_id=spread(batch.selector_id, [-3, s, s + 5, s - 1]),
        toleration_id=spread(batch.toleration_id, [-2, t, t + 4]))
    return snap.replace(nodes=nodes), batch


# (the device term, an edit): the edits put P and N off every tile and
# store width of K9 (N = 1, 17, 1001; P = 1, 65), table ids out of range
# and no quota level
K9_CASES = [pytest.param((False, None), id="False"),
            pytest.param((True, None), id="True")] + [
    pytest.param((True, e), id=e)
    for e in ("N=1", "N=17", "N=1001", "P=1", "P=65", "ids out of range",
              "quota depth 0")]


@pytest.mark.parametrize("devices", K9_CASES)
def test_stage1_mask_equal_reference(devices):
    """cascade.stage1_mask (K9's plain version over the factored gates)
    equals the reference's stage1_mask over its static gates, ANDed with
    the device prefilter's per-pod row where the gates carry it; the
    candidate counts too. `devices` is (the device term, an edit of
    K9_CASES)."""
    devices, edit = devices
    p = {"P=1": 1, "P=65": 65}.get(edit, CHUNK)
    n = {"N=1": 1, "N=17": 17, "N=1001": 1001}.get(edit, N)
    depth = 0 if edit == "quota depth 0" else 2
    pods, _, _ = sparse_workload()
    batch = jsyn.slice_batch(pods, 0, p)
    snap = full_gate_cluster(n=n)
    if edit == "ids out of range":
        snap, batch = _out_of_range_ids(snap, batch)
    # jitted, as the reference runs them: a traced gather clamps an
    # index out of range (an eager one raises)
    static_ok, _ = jax.jit(jcascade.static_gates)(snap.nodes, batch,
                                                  JCfg.make())
    want = np.asarray(jcascade.stage1_mask(snap, batch, static_ok,
                                           fit_dims=(0, 1, 2, 3),
                                           quota_depth=depth))
    tsnap = to_port("ClusterSnapshot", snap)
    tpods = to_port("PodBatch", batch)
    gates = cascade.static_gate_terms(
        tsnap.nodes, tpods, LoadAwareConfig.make(device="cpu"),
        tsnap.devices if devices else None)
    got = cascade.stage1_mask(tsnap, tpods, gates, (0, 1, 2, 3), depth)
    want = want & gates.device_ok.numpy()[:, None]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cascade.candidate_counts(got).numpy(),
        np.asarray(jcascade.candidate_counts(jnp.asarray(want))))
    assert 0 < int(got.sum()) < got.numel()


def test_stage1_mask_is_sound():
    """The reference's test_stage1_mask_is_sound in the port: every node
    placement survives the mask, and a quota at its ceiling kills its
    pods' rows (the ceiling equal to the reference's)."""
    pods, prefixes, _ = sparse_workload(seed=7)
    jsnap = full_gate_cluster(seed=6)
    batch = jsyn.slice_batch(pods, 0, CHUNK)
    snap = to_port("ClusterSnapshot", jsnap)
    tpods = to_port("PodBatch", batch)
    cfg = LoadAwareConfig.make(device="cpu")
    gates = cascade.static_gate_terms(snap.nodes, tpods, cfg, None)
    mask = cascade.stage1_mask(snap, tpods, gates, (0, 1, 2, 3), 2).numpy()
    res = core.schedule_batch(snap, tpods, cfg, cascade=False,
                              **KW, **prefix_kw(pods, prefixes))
    assign, slot = res.assignment.numpy(), res.res_slot.numpy()
    rows = np.flatnonzero((assign >= 0) & (slot < 0))
    assert rows.size > 0
    assert mask[rows, assign[rows]].all()

    qid = int(tpods.quota_id[0])
    assert qid >= 0
    used = snap.quotas.used.clone()
    used[qid] = snap.quotas.runtime[qid]
    full = snap.replace(quotas=snap.quotas.replace(used=used))
    ok = feasibility.quota_ceiling_ok(full.quotas, tpods, 2, (0, 1, 2, 3))
    want = jfeas.quota_ceiling_ok(
        jsnap.quotas.replace(used=jnp.asarray(used.numpy())), batch,
        quota_depth=2, fit_dims=(0, 1, 2, 3))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want))
    hit = tpods.quota_id.numpy() == qid
    finite = np.isfinite(snap.quotas.runtime[qid, :4].numpy())
    blocked = hit & (tpods.requests[:, :4].numpy()[:, finite] > 0.5).any(1)
    assert blocked.any() and not ok.numpy()[blocked].any()
    assert ok.numpy()[~hit].all()
    killed = cascade.stage1_mask(full, tpods, gates, (0, 1, 2, 3), 2)
    assert not killed.numpy()[blocked].any()
    assert (cascade.candidate_counts(killed).numpy()[blocked] == 0).all()


def test_stage1_mask_plain_is_gates_fit_and_ceiling():
    """K9's plain version is expand_gates & resource_fit & the quota
    ceiling, for every fit-dims and depth setting, the taint tables in."""
    pods, _, _ = sparse_workload()
    tsnap = to_port("ClusterSnapshot", full_gate_cluster())
    tpods = to_port("PodBatch", jsyn.slice_batch(pods, 0, CHUNK))
    gates = cascade.static_gate_terms(tsnap.nodes, tpods,
                                      LoadAwareConfig.make(device="cpu"),
                                      tsnap.devices)
    assert gates.tol_forbid is not None
    for fd, depth in (((0, 1, 2, 3), 2), (None, 6), ((0, 1), 0)):
        dims = (lambda x: x) if fd is None else (lambda x: x[:, list(fd)])
        got = stage1_mask_plain(
            gates, dims(tpods.requests), dims(tsnap.nodes.requested),
            dims(tsnap.nodes.allocatable),
            feasibility.pod_ancestors(tsnap.quotas, tpods),
            dims(tsnap.quotas.used), dims(tsnap.quotas.runtime), depth, EPS)
        want = (cascade.expand_gates(gates)
                & feasibility.resource_fit(tsnap.nodes.allocatable,
                                           tsnap.nodes.requested,
                                           tpods.requests, fd)
                & feasibility.quota_ceiling_ok(tsnap.quotas, tpods, depth,
                                               fd)[:, None])
        assert torch.equal(got, want)


def test_slot_columns_escape_the_mask():
    """A slot whose host node is full: the node's column dies in the
    stage-1 mask, but the slot's owners still reach the slot (the mask
    is never applied to slot columns), cascade on equal to off and to
    the reference."""
    pods, prefixes, _ = sparse_workload()
    jsnap = full_gate_cluster()
    batch = jsyn.slice_batch(pods, 0, CHUNK)
    owner = np.asarray(batch.reservation_owner)
    resv = jsnap.reservations
    group = np.asarray(resv.owner_group)
    slots = [v for v in range(group.shape[0])
             if np.asarray(resv.valid)[v] and (owner == group[v]).any()]
    assert slots
    v = slots[0]
    host = int(np.asarray(resv.node)[v])
    requested = np.asarray(jsnap.nodes.requested).copy()
    requested[host] = np.asarray(jsnap.nodes.allocatable)[host]
    jsnap = jsnap.replace(nodes=jsnap.nodes.replace(
        requested=jnp.asarray(requested)))
    kw = dict(KW, **prefix_kw(pods, prefixes))
    on = port_run(jsnap, batch, cascade=True, **kw)
    off = port_run(jsnap, batch, cascade=False, **kw)
    assert_same(off, on)
    assert_same(ref_run(jsnap, batch, cascade=True, **kw), on)
    owners = np.flatnonzero(owner == group[v])
    assert (on.res_slot.numpy()[owners] == v).any()
    tsnap, tpods = to_port("ClusterSnapshot", jsnap), to_port("PodBatch",
                                                             batch)
    gates = cascade.static_gate_terms(tsnap.nodes, tpods,
                                      LoadAwareConfig.make(device="cpu"),
                                      tsnap.devices)
    mask = cascade.stage1_mask(tsnap, tpods, gates, (0, 1, 2, 3), 2)
    assert not mask[torch.from_numpy(owners), host].any()


# --- schedule_batch with the cascade and the prefixes ---------------------


@functools.lru_cache(maxsize=None)
def _full_gate_chunk():
    pods, prefixes, _ = sparse_workload()
    snap = full_gate_cluster()
    batch = jsyn.slice_batch(pods, 0, CHUNK)
    kw = dict(KW, **prefix_kw(pods, prefixes))
    return (snap, batch, kw, ref_run(snap, batch, cascade=False, **kw),
            ref_run(snap, batch, cascade=True, **kw))


@pytest.mark.parametrize("cascade_on", [True, False], ids=["on", "off"])
def test_cascade_full_gate_equal_reference(cascade_on):
    """schedule_batch with every prefix and dom_classes, cascade on and
    off, equals the reference with the same arguments in every field
    and the snapshot; the reference's on and off are equal too (its
    own property), so the port's cascade-on run equals the reference's
    cascade-off oracle."""
    snap, batch, kw, want_off, want_on = _full_gate_chunk()
    got = port_run(snap, batch, cascade=cascade_on, **kw)
    assert_same(want_on if cascade_on else want_off, got)
    assert_same(want_off, got)
    assert int((got.assignment >= 0).sum()) > 0
    assert int((got.gpu_take.any(dim=1)).sum()) > 0
    assert int((got.numa_zone >= 0).sum()) > 0


def test_cascade_across_carried_chunks():
    """Chunk by chunk with carried topology counts (the bench sweep):
    the port with the cascade on equals the reference's cascade-off
    oracle chunk by chunk, and the carried counts stay equal."""
    pods, prefixes, _ = sparse_workload()
    snap_w = full_gate_cluster()
    tsnap = to_port("ClusterSnapshot", snap_w)
    kw = dict(KW, **prefix_kw(pods, prefixes))
    counts_w = tuple(jnp.asarray(getattr(pods, f)) for f in COUNT_FIELDS)
    tpods = to_port("PodBatch", pods)
    counts_g = tuple(getattr(tpods, f) for f in COUNT_FIELDS)
    cfg = LoadAwareConfig.make(device="cpu")
    for s in range(0, P, CHUNK):
        batch = jsyn.slice_batch(pods, s, CHUNK)
        bw = batch.replace(**dict(zip(COUNT_FIELDS, counts_w)))
        bg = to_port("PodBatch", batch).replace(
            **dict(zip(COUNT_FIELDS, counts_g)))
        want = ref_run(snap_w, bw, cascade=False, **kw)
        got = core.schedule_batch(tsnap, bg, cfg, cascade=True, **kw)
        assert_same(want, got)
        counts_w = jcore.charge_all_counts(counts_w, bw, want.assignment)
        counts_g = charge_all_counts(counts_g, bg, got.assignment)
        snap_w, tsnap = want.snapshot, got.snapshot
    for a, b in zip(counts_w, counts_g):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@functools.lru_cache(maxsize=None)
def overcommitted_tail_setup(seed=2, n_nodes=16):
    """tests/test_cascade.py's tight tail fixture: 512 full-gate pods,
    all unplaced, against 16 nodes."""
    snap = full_gate_cluster(n=n_nodes)
    pods = jsyn.full_gate_pods(P, n_nodes, seed=seed, num_quotas=8,
                               num_gangs=8)
    packed, prefixes, masks = jsyn.pack_gate_prefixes(pods, CHUNK)
    return snap, packed, masks


TAIL_KW = dict(num_rounds=4, k_choices=8, score_dims=(0, 1), tie_break=True,
               quota_depth=2, fit_dims=(0, 1, 2, 3), enable_numa=True,
               enable_devices=True)


def test_cascade_no_prefix_equal_reference():
    """Cascade on without packing contracts (the service shape): only
    stage 1 is in play; equal to the reference's cascade off."""
    snap, packed, _ = overcommitted_tail_setup()
    counts = tuple(getattr(packed, f) for f in COUNT_FIELDS)
    batch = jsyn.slice_batch(packed, 0, 64).replace(
        **dict(zip(COUNT_FIELDS, counts)))
    want = ref_run(snap, batch, **TAIL_KW)
    assert_same(want, port_run(snap, batch, cascade=True, **TAIL_KW))


@pytest.mark.parametrize("cascade_on", [False, True], ids=["off", "on"])
def test_prefix_larger_than_batch_equal_reference(cascade_on):
    """Prefixes above the batch clamp to it: equal to the unprefixed
    reference, cascade off and on."""
    snap = jsyn.synthetic_cluster(8, seed=5)
    pods = jsyn.synthetic_pods(32, seed=6)
    kw = dict(num_rounds=1, k_choices=2, quota_depth=1)
    big = dict(topo_prefix=4 * 32, numa_prefix=4 * 32, gpu_prefix=4 * 32)
    want = ref_run(snap, pods, **kw)
    assert_same(want, port_run(snap, pods, cascade=cascade_on, **kw, **big))
    assert_same(want, port_run(snap, pods, cascade=cascade_on, **kw))


@pytest.mark.parametrize("cascade_on", [False, True], ids=["off", "on"])
def test_zero_width_prefixes_equal_reference(cascade_on):
    """A chunk with no topology, CPU-bind or device pod on the full-gate
    cluster, every prefix 0: K4's and K6's batch-start terms run on no
    row (cascade on), and the topology, NUMA and GPU blocks of a step on
    no pod; equal to the reference with the same arguments and to the
    full-width run."""
    snap = full_gate_cluster()
    pods = jsyn.synthetic_pods(CHUNK, seed=9, num_quotas=8)
    zero = dict(topo_prefix=0, numa_prefix=0, gpu_prefix=0)
    want = ref_run(snap, pods, cascade=cascade_on, **KW, **zero)
    got = port_run(snap, pods, cascade=cascade_on, **KW, **zero)
    assert_same(want, got)
    assert_same(port_run(snap, pods, **KW), got)
    assert int((got.assignment >= 0).sum()) > 0


def test_device_prefilter_follows_the_gpu_prefix():
    """With the cascade on, the batch-start device prefilter reads only
    the gpu prefix's rows, as the reference's (core.py:304-313): on a
    snapshot without instances, GPU pods beyond the prefix pass it there
    too (the caller broke the packing contract), and the port places
    them as the reference does; the pods below it are gated."""
    snap = jsyn.synthetic_cluster(16, seed=5)
    pods = jsyn.synthetic_pods(64, seed=6, gpu_pod_frac=0.3)
    assert np.asarray(pods.gpu_ratio)[16:].any()
    kw = dict(num_rounds=2, k_choices=4, quota_depth=1, gpu_prefix=16,
              cascade=True, fit_dims=(0, 1, 2, 3))
    want = ref_run(snap, pods, **kw)
    got = port_run(snap, pods, **kw)
    assert_same(want, got)
    placed = got.assignment.numpy() >= 0
    gpu = np.asarray(pods.gpu_ratio) > 0
    assert not (placed[:16] & gpu[:16]).any()
    assert (placed[16:] & gpu[16:]).any()


def test_bad_dom_classes_raise():
    """dom_classes that do not partition a family's groups raise
    ValueError, as the reference's do."""
    pods, prefixes, _ = sparse_workload()
    snap = full_gate_cluster()
    batch = jsyn.slice_batch(pods, 0, CHUNK)
    s_cls, a_cls, f_cls = jsyn.dom_classes(pods)
    assert np.asarray(pods.anti_count0).shape[0] > 1
    bad = (s_cls, ((0,),), f_cls)                 # groups left out
    with pytest.raises(ValueError, match="dom_classes"):
        ref_run(snap, batch, **KW, dom_classes=bad)
    with pytest.raises(ValueError, match="dom_classes"):
        port_run(snap, batch, **KW, dom_classes=bad)
    with pytest.raises(ValueError, match="dom_classes"):
        port_run(snap, batch, **KW, dom_classes=(s_cls, a_cls, ((),)))


# --- the tail with the topology budget ------------------------------------


def test_tail_loop_with_budget_equal_reference():
    """tail_compaction_loop with topo_prefix = 48 and the topo mask,
    windows of 64, 2-3 passes: assignment, stats, snapshot and counts
    equal to the reference's device loop."""
    snap, packed, masks = overcommitted_tail_setup()
    counts = tuple(jnp.asarray(getattr(packed, f)) for f in COUNT_FIELDS)
    assign = jnp.full((P,), -1, jnp.int32)
    step = functools.partial(jcore.schedule_batch, **TAIL_KW)
    loop = jax.jit(functools.partial(
        jcore.tail_compaction_loop, step, tail_chunk=64, min_passes=2,
        max_passes=3, topo_prefix=48, topo_mask=jnp.asarray(masks["topo"])))
    wsnap, wcounts, wassign, wstats = loop(snap, counts, assign, packed,
                                           JCfg.make())
    tpods = to_port("PodBatch", packed)
    gsnap, gassign, gstats, _, gcounts = core.tail_compaction_loop(
        functools.partial(core.schedule_batch, **TAIL_KW),
        to_port("ClusterSnapshot", snap),
        torch.full((P,), -1, dtype=torch.int32), tpods,
        LoadAwareConfig.make(device="cpu"), tail_chunk=64, min_passes=2,
        max_passes=3, counts=tuple(getattr(tpods, f) for f in COUNT_FIELDS),
        topo_prefix=48, topo_mask=torch.from_numpy(masks["topo"]))
    np.testing.assert_array_equal(gstats.numpy(), np.asarray(wstats))
    np.testing.assert_array_equal(gassign.numpy(), np.asarray(wassign))
    assert_leaves_equal(_flat(wsnap), _flat(gsnap))
    assert_leaves_equal(dict(zip(COUNT_FIELDS, wcounts)),
                        dict(zip(COUNT_FIELDS, gcounts)))
    assert int(np.asarray(wstats)[3]) >= 2


@pytest.mark.parametrize("chunk,budget", [(8, 2), (6, 3), (12, 0)])
def test_tail_select_budget_equal_reference(chunk, budget):
    """tail_select on a hand-built pool: more constrained stragglers than
    the budget; the overflow is not attempted and untried pods of either
    class come first, as in the reference."""
    p = 12
    valid = np.ones((p,), bool)
    valid[11] = False
    assign = np.full((p,), -1, np.int32)
    assign[[3, 7]] = 0                                # placed
    topo = np.zeros((p,), bool)
    topo[[0, 1, 2, 4, 5, 8]] = True                   # constrained
    tried = np.zeros((p,), bool)
    tried[[0, 6]] = True
    jpods = jsyn.synthetic_pods(p, seed=1).replace(valid=jnp.asarray(valid))
    tpods = to_port("PodBatch", jpods)
    w_idx, w_att = jcore.tail_select(
        jpods, jnp.asarray(assign), jnp.asarray(tried), chunk, budget,
        jnp.asarray(topo))
    g_idx, g_att = core.tail_select(
        tpods, torch.from_numpy(assign), torch.from_numpy(tried), chunk,
        budget, torch.from_numpy(topo))
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(g_att.numpy(), np.asarray(w_att))
    att = g_idx.numpy()[g_att.numpy()]
    # constrained: at most the budget; unconstrained stragglers 6, 9, 10
    assert topo[att].sum() == budget
    assert (~topo[att]).sum() == 3
