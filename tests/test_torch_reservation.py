"""Reservation slots (V > 0) in the port against the JAX package:
`plugins/reservation.py` slot_columns and rebuild_reservations, K1's
plain version with the slot columns against the reference's masked
lax.top_k over N + V columns, schedule_batch on the scenarios of
tests/test_reservation.py, and the full-gate builders (the
full-gate sweep and tail, `configs.run_gpu_share`'s workload, is held
against the reference in tests/test_torch_configs.py).

Tolerances: none. Bools, ints and top-k indices are compared exactly,
floats bit for bit."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.api.extension import ResourceKind as RK
from koordinator_tpu.scheduler import cascade as jcascade
from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler.plugins import loadaware as jla
from koordinator_tpu.scheduler.plugins import reservation as jresv
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch.bridge import to_numpy
from koordinator_tpu_torch.kernels.score_topk import score_topk
from koordinator_tpu_torch.scheduler import core
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.scheduler.cascade import static_gate_terms
from koordinator_tpu_torch.scheduler.plugins import loadaware
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.scheduler.plugins.reservation import (
    rebuild_reservations,
    slot_columns,
)
from koordinator_tpu_torch.utils import synthetic

from torch_port_ref import assert_trees_equal, numpy_tree, to_port
from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)

FIT_DIMS = (0, 1, 2, 3)
SCORE_DIMS = (0, 1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def assert_results_equal(want, got):
    """Every field of two ScheduleResults (and their snapshots) equal:
    dtype, shape and bytes."""
    w, g = _flat(numpy_tree(want)), _flat(to_numpy(got))
    assert set(w) == set(g)
    for k in w:
        a, b = np.asarray(w[k]), np.asarray(g[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


# --- the full-gate builders -----------------------------------------------


@pytest.mark.parametrize("nodes,pods,seed", [(300, 1200, 0), (1000, 8000, 2),
                                             (40, 2000, 5)])
def test_full_gate_builders_equal_reference(nodes, pods, seed):
    """full_gate_cluster (slots from their own generator, their holds
    charged on the host nodes, taint classes) equal to the reference's
    leaf for leaf; full_gate_pods equal to the reference's leaf for
    leaf, the pod topology groups and the reservation owners (drawn
    after them) included."""
    jsnap = jsyn.full_gate_cluster(nodes, seed=seed)
    tsnap = synthetic.full_gate_cluster(nodes, seed=seed, device="cpu")
    assert_trees_equal(to_numpy(tsnap), numpy_tree(jsnap))
    jpods = jsyn.full_gate_pods(pods, nodes, seed=seed + 1)
    tpods = synthetic.full_gate_pods(pods, nodes, seed=seed + 1, device="cpu")
    assert_trees_equal(to_numpy(tpods), numpy_tree(jpods))
    v = jsyn.full_gate_reservations(nodes)
    owners = tpods.reservation_owner
    assert tsnap.reservations.valid.shape == (v,)
    assert int((owners >= 0).sum()) == min(2 * v, pods) > 0
    assert tpods.has_taints and bool((tsnap.nodes.taint_group > 0).any())


def test_synthetic_cluster_slots_equal_reference():
    """synthetic_cluster's live slots alone (no GPU nodes, and with
    them), and the count check."""
    for kw in (dict(), dict(gpu_node_frac=0.5, gpus_per_node=4)):
        jsnap = jsyn.synthetic_cluster(32, seed=3, num_quotas=4,
                                       num_reservations=9, **kw)
        tsnap = synthetic.synthetic_cluster(32, seed=3, num_quotas=4,
                                            num_reservations=9,
                                            device="cpu", **kw)
        assert_trees_equal(to_numpy(tsnap), numpy_tree(jsnap))
    with pytest.raises(ValueError, match="num_reservations"):
        synthetic.synthetic_cluster(4, num_reservations=5, device="cpu")


# --- slot_columns and rebuild_reservations --------------------------------


def _slot_case(seed):
    """A full-gate cluster and batch with many owners, some slots
    invalid or off any node, zone and instance holds on some slots,
    single-NUMA and GPU owners, and selector rows that bite."""
    rng = np.random.default_rng(seed)
    snap = jsyn.full_gate_cluster(120, seed=seed)
    pods = jsyn.full_gate_pods(600, 120, seed=seed + 1)
    resv = snap.reservations
    v = resv.valid.shape[0]
    i = resv.gpu_valid.shape[1]
    z = resv.numa_valid.shape[1]
    valid = rng.uniform(size=v) < 0.85
    node = np.where(rng.uniform(size=v) < 0.1, -1, np.asarray(resv.node))
    gpu_valid = rng.uniform(size=(v, i)) < 0.2
    numa_valid = rng.uniform(size=(v, z)) < 0.3
    snap = snap.replace(reservations=resv.replace(
        valid=valid, node=node.astype(np.int32), gpu_valid=gpu_valid,
        gpu_free=np.where(gpu_valid[..., None], 100.0, 0.0).astype(
            np.float32) * np.ones((1, 1, 3), np.float32),
        numa_valid=numa_valid,
        numa_free=np.where(numa_valid[..., None], 2000.0, 0.0).astype(
            np.float32) * np.ones((1, 1, 2), np.float32)))
    p = pods.valid.shape[0]
    owner = np.where(rng.uniform(size=p) < 0.5,
                     rng.integers(-1, v + 2, p), -1).astype(np.int32)
    match = rng.uniform(size=np.asarray(pods.selector_match).shape) < 0.6
    nodes = snap.nodes.replace(label_group=rng.integers(
        0, match.shape[1], 120).astype(np.int32))
    pods = pods.replace(
        reservation_owner=owner, selector_match=match,
        selector_id=rng.integers(-1, match.shape[0], p).astype(np.int32),
        numa_single=np.asarray(pods.numa_single)
        | (rng.uniform(size=p) < 0.2))
    return jax.tree_util.tree_map(jnp.asarray, (snap.replace(nodes=nodes),
                                                pods))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_columns_equal_reference(seed):
    """slot_ok, the slots' capacity and nodes: the reference's
    slot_columns on its static gates (taints included), the port's on
    the factored gates."""
    snap, pods = _slot_case(seed)
    jcfg = JCfg.make()
    static_base, _ = jax.jit(jcascade.static_gates)(snap.nodes, pods, jcfg)
    want = jresv.slot_columns(snap, pods, static_base)
    tsnap = to_port("ClusterSnapshot", snap)
    tpods = to_port("PodBatch", pods)
    gates = static_gate_terms(tsnap.nodes, tpods,
                              LoadAwareConfig.make(device="cpu"),
                              tsnap.devices)
    got = slot_columns(tsnap, tpods, gates)
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()
    ok = got[0].numpy()
    assert ok.any() and (~ok[np.asarray(pods.reservation_owner) >= 0]).any()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("paths", ["numa_gpu", "plain"])
def test_rebuild_reservations_equal_reference(seed, paths):
    """The post-batch reservation state from random consumers (some
    revoked, several on one slot, AllocateOnce slots among them), with
    the zone and instance draw-downs where the batch ran those paths."""
    rng = np.random.default_rng(seed)
    snap, pods = _slot_case(seed)
    resv = snap.reservations
    v, i, _ = np.asarray(resv.gpu_free).shape
    z = np.asarray(resv.numa_free).shape[1]
    p = pods.valid.shape[0]
    res_slot = np.where(rng.uniform(size=p) < 0.3,
                        rng.integers(0, v, p), -1).astype(np.int32)
    ok = rng.uniform(size=p) < 0.8
    numa_take = np.floor(rng.uniform(0, 800, (p, z, 2))).astype(np.float32)
    gpu_take = rng.uniform(size=(p, i)) < 0.2
    per = np.floor(rng.uniform(0, 60, (p, 3))).astype(np.float32)
    extra = (dict(numa_take=numa_take, gpu_take=gpu_take, gpu_per_inst=per)
             if paths == "numa_gpu" else {})
    want = jresv.rebuild_reservations(
        resv, pods, jnp.asarray(res_slot), jnp.asarray(ok),
        **{k: jnp.asarray(x) for k, x in extra.items()})
    got = rebuild_reservations(
        to_port("ReservationState", resv), to_port("PodBatch", pods),
        torch.from_numpy(res_slot), torch.from_numpy(ok),
        **{k: torch.from_numpy(x) for k, x in extra.items()})
    assert_trees_equal(to_numpy(got), numpy_tree(want))
    assert not np.array_equal(np.asarray(want.valid), np.asarray(resv.valid))


# --- K1 with slot columns --------------------------------------------------


@functools.partial(jax.jit, static_argnames=("k", "tie_break"))
def reference_select_slots(nodes, pods, cfg, ext_static, taint_penalty,
                           row_ok, requested, ext_alloc, blocked, addend, *,
                           k, tie_break):
    """The round prologue of koordinator_tpu/scheduler/core.py
    schedule_batch over N + V columns (core.py:565-577, :693-742):
    extended fit, static and slot gates, taken once slots, the LoadAware
    score plus an addend, the taint penalty floored at 0, the slots'
    flat score, jitter, the -1 mask and lax.top_k."""
    fd = list(FIT_DIMS)
    p = pods.requests.shape[0]
    n = nodes.allocatable.shape[0]
    n_ext = ext_alloc.shape[0]
    fit = jnp.all(pods.requests[:, None, fd] + requested[None][..., fd]
                  <= ext_alloc[None][..., fd] + EPS, axis=-1)
    feasible = fit & ext_static & row_ok[:, None]
    feasible &= ~jnp.concatenate([jnp.zeros((n,), bool), blocked])[None, :]
    scores = jla.score_matrix(nodes, pods, cfg, SCORE_DIMS) + addend
    if taint_penalty is not None:
        scores = jnp.maximum(scores - taint_penalty, 0.0)
    scores = jnp.concatenate(
        [scores, jnp.full((p, n_ext - n), 3.0 * 100.0 + 1.0)], axis=1)
    if tie_break:
        pi = jnp.arange(p, dtype=jnp.uint32)[:, None]
        ni = jnp.arange(n_ext, dtype=jnp.uint32)[None, :]
        h = (pi * jnp.uint32(2654435761) + ni * jnp.uint32(40503)) & 1023
        scores = scores + h.astype(jnp.float32) * (0.49 / 1024.0)
    masked = jnp.where(feasible, scores, -1.0)
    val, idx = jax.lax.top_k(masked, k)
    return val, idx.astype(jnp.int32)


def k1_slot_inputs(seed, n_nodes=120, p=600, taints=True):
    """A loaded full-gate chunk with its slots as columns: random slot
    use (integer shares of the free), random pair addends, a share of
    taken once slots. Returns (reference kwargs, port kwargs)."""
    rng = np.random.default_rng(seed)
    snap, pods = _slot_case(seed)
    if not taints:
        pods = pods.replace(has_taints=False)
    nodes = snap.nodes
    alloc = np.asarray(nodes.allocatable)
    load = rng.uniform(0, 0.9, alloc.shape)
    nodes = nodes.replace(
        requested=(np.floor(alloc * load / 500.0) * 500.0).astype(np.float32),
        assigned_estimated=(np.floor(alloc * load * 0.4) + 0.375).astype(
            np.float32))
    snap = snap.replace(nodes=nodes)
    resv = snap.reservations
    v = resv.valid.shape[0]
    slot_used = (np.floor(np.asarray(resv.free) * rng.uniform(
        0, 1, (v, 1)) / 500.0) * 500.0).astype(np.float32)
    blocked = rng.uniform(size=v) < 0.3
    addend = np.floor(rng.uniform(0, 60, (p, n_nodes))).astype(np.float32)
    addend[rng.uniform(size=(p, n_nodes)) < 0.5] = 0.0
    row_ok = rng.uniform(size=p) < 0.9
    jcfg = JCfg.make()
    static_ok, penalty = jax.jit(jcascade.static_gates)(nodes, pods, jcfg)
    slot_ok, slot_alloc, _ = jresv.slot_columns(snap, pods, static_ok)
    requested = np.concatenate([np.asarray(nodes.requested), slot_used])
    ext_alloc = np.concatenate([alloc, np.asarray(slot_alloc)])
    ref = dict(nodes=nodes, pods=pods, cfg=jcfg,
               ext_static=jnp.concatenate([static_ok, slot_ok], 1),
               taint_penalty=penalty, row_ok=jnp.asarray(row_ok),
               requested=jnp.asarray(requested),
               ext_alloc=jnp.asarray(ext_alloc), blocked=jnp.asarray(blocked),
               addend=jnp.asarray(addend))
    tsnap = to_port("ClusterSnapshot", snap)
    tpods = to_port("PodBatch", pods)
    cfg = LoadAwareConfig.make(device="cpu")
    gates = static_gate_terms(tsnap.nodes, tpods, cfg, None)
    node_term, prod_term, alloc_s, weights = loadaware.score_terms(
        tsnap.nodes, cfg, SCORE_DIMS)
    fd = list(FIT_DIMS)
    port = dict(
        gates=gates, pair_ok=None, row_ok=torch.from_numpy(row_ok),
        req_fit=tpods.requests[:, fd].contiguous(),
        requested_fit=torch.from_numpy(requested)[:, fd].contiguous(),
        alloc_fit=torch.from_numpy(ext_alloc)[:, fd].contiguous(),
        est=tpods.estimated[:, list(SCORE_DIMS)].contiguous(),
        prod_scored=loadaware.prod_scored(tpods, cfg), node_term=node_term,
        prod_term=prod_term, alloc_score=alloc_s, weights=weights,
        eps=EPS, fma_sum=True, pair_score=torch.from_numpy(addend),
        slot_ok=slot_columns(tsnap, tpods, gates)[0],
        slot_block=torch.from_numpy(blocked))
    return ref, port


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k,tie_break", [(8, True), (32, False), (32, True)])
@pytest.mark.parametrize("taints", [True, False], ids=["taints", "no_taints"])
def test_k1_slot_columns_equal_reference(seed, k, tie_break, taints):
    """K1's plain version with the V slot columns (and the taint term
    and an addend) against the reference's masked lax.top_k over N + V:
    indices exactly, values bit for bit; some rows pick a slot."""
    ref, port = k1_slot_inputs(seed, taints=taints)
    want = reference_select_slots(**ref, k=k, tie_break=tie_break)
    got = score_topk(**port, k=k, tie_break=tie_break)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    assert (got[1].numpy() >= ref["nodes"].allocatable.shape[0]).any()


def test_k1_selection_reaches_past_the_nodes():
    """N + V just above k: every node and slot column enters the lists,
    the -1 slot columns after the -1 node columns, as lax.top_k orders
    them."""
    ref, port = k1_slot_inputs(3)
    n = 120
    v = port["slot_ok"].shape[1]
    k = 32
    cols = torch.cat([torch.arange(8), torch.arange(n, n + v)])
    port = dict(port, gates=port["gates"].replace(
        label_group=port["gates"].label_group[:8],
        node_ok=port["gates"].node_ok[:8],
        prod_node_ok=port["gates"].prod_node_ok[:8],
        metric_fresh=port["gates"].metric_fresh[:8],
        schedulable=port["gates"].schedulable[:8],
        taint_group=port["gates"].taint_group[:8]),
        requested_fit=port["requested_fit"][cols].contiguous(),
        alloc_fit=port["alloc_fit"][cols].contiguous(),
        node_term=port["node_term"][:8], prod_term=port["prod_term"][:8],
        alloc_score=port["alloc_score"][:8],
        pair_score=port["pair_score"][:, :8].contiguous())
    nodes = jax.tree_util.tree_map(
        lambda x: x[:8] if getattr(x, "ndim", 0) and x.shape[0] == n else x,
        ref["nodes"])
    jcols = jnp.asarray(cols.numpy())
    ref = dict(ref, nodes=nodes, ext_static=ref["ext_static"][:, jcols],
               taint_penalty=ref["taint_penalty"][:, :8],
               requested=ref["requested"][jcols],
               ext_alloc=ref["ext_alloc"][jcols],
               addend=ref["addend"][:, :8])
    assert 8 < k < 8 + v
    want = reference_select_slots(**ref, k=k, tie_break=True)
    got = score_topk(**port, k=k, tie_break=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    assert (got[1].numpy() >= 8).any()


# --- schedule_batch on the reference's reservation scenarios ---------------


def _scenarios():
    """tests/test_reservation.py:61-356 as (snapshot, batch, kwargs),
    built with the reference's SnapshotBuilder: a non-owner kept off a
    fully reserved node, a consumer that does not recharge its node,
    AllocateOnce's single highest-priority winner, a shared slot filled
    in priority order, a gang rollback returning the hold, a
    quota-rejected once-winner that does not block, an oversize owner,
    no quota priority inversion, zero slot capacity, reserved GPU
    minors, a reserved zone cpuset, and a shared zone hold draining."""
    import test_reservation as tr
    from koordinator_tpu.api.types import (
        ElasticQuota,
        Node,
        NodeMetric,
        ObjectMeta,
        Pod,
        PodGroup,
        Reservation,
    )
    from koordinator_tpu.snapshot.builder import SnapshotBuilder

    def built(b, pods, runtime_max=False):
        snap, ctx = b.build(now=tr.NOW)
        if runtime_max:
            snap = snap.replace(quotas=snap.quotas.replace(
                runtime=np.asarray(snap.quotas.max).copy()))
        return snap, b.build_pod_batch(pods, ctx)

    def simple(cpu, mem, pods, once=True, node_cpu=10_000.0,
               node_mem=20_480.0):
        b = tr.two_node_builder(cpu=node_cpu, mem=node_mem)
        b.add_reservation(tr.reserve("r0", cpu, mem, once=once))
        return built(b, pods)

    def gang_rollback():
        b = SnapshotBuilder(max_nodes=1)
        b.add_node(Node(meta=ObjectMeta(name="n0"),
                        allocatable={RK.CPU: 4_000, RK.MEMORY: 4_096}))
        b.set_node_metric(NodeMetric(node_name="n0", update_time=tr.NOW - 2,
                                     node_usage={RK.CPU: 0.0}))
        b.add_gang(PodGroup(meta=ObjectMeta(name="g"), min_member=3))
        b.add_reservation(tr.reserve("r0", 4_000, 4_096))
        return built(b, [tr.owned_pod(f"p{i}", 3_000, 3_072, gang="g")
                         for i in range(3)])

    def quota_rejected():
        b = tr.two_node_builder()
        b.add_quota(ElasticQuota(meta=ObjectMeta(name="root"),
                                 max={RK.CPU: 20_000, RK.MEMORY: 40_960}))
        b.add_quota(ElasticQuota(meta=ObjectMeta(name="full"), parent="root",
                                 max={RK.CPU: 100, RK.MEMORY: 100}))
        b.add_quota(ElasticQuota(meta=ObjectMeta(name="roomy"),
                                 parent="root",
                                 max={RK.CPU: 10_000, RK.MEMORY: 10_240}))
        b.add_reservation(tr.reserve("r0", 6_000, 8_192))
        hi = tr.owned_pod("hi", 2_000, 2_048, priority=9500)
        hi.quota_name = "full"
        lo = tr.owned_pod("lo", 2_000, 2_048, priority=9001)
        lo.quota_name = "roomy"
        return built(b, [hi, lo], runtime_max=True)

    def no_inversion():
        b = tr.two_node_builder()
        b.add_quota(ElasticQuota(meta=ObjectMeta(name="q"),
                                 max={RK.CPU: 2_500, RK.MEMORY: 40_960}))
        b.add_reservation(tr.reserve("r0", 6_000, 8_192))
        hi = tr.owned_pod("hi", 2_000, 2_048, priority=9500,
                          labels={"team": "b"})
        hi.quota_name = "q"
        lo = tr.owned_pod("lo", 2_000, 2_048, priority=9001)
        lo.quota_name = "q"
        return built(b, [hi, lo], runtime_max=True)

    def zero_capacity():
        b = SnapshotBuilder(max_nodes=2, max_reservations=0)
        for i in range(2):
            b.add_node(Node(meta=ObjectMeta(name=f"n{i}"),
                            allocatable={RK.CPU: 8_000, RK.MEMORY: 16_384}))
            b.set_node_metric(NodeMetric(node_name=f"n{i}",
                                         update_time=tr.NOW - 2,
                                         node_usage={RK.CPU: 0.0}))
        return built(b, [tr.owned_pod("p", 2_000, 2_048)])

    def gpu_minors():
        b = tr.gpu_numa_builder()
        b.add_reservation(Reservation(
            meta=ObjectMeta(name="r0"),
            requests={RK.CPU: 2_000.0, RK.MEMORY: 2_048.0,
                      RK.GPU_CORE: 200.0, RK.GPU_MEMORY: 2000.0},
            owner_label_selector={"team": "a"}, allocate_once=True,
            node_name="n0", phase="Available", allocated_gpu_minors=(2, 3)))
        return built(b, [
            Pod(meta=ObjectMeta(name="x", labels={"team": "b"}),
                requests={RK.CPU: 1_000.0, RK.MEMORY: 1_024.0,
                          RK.GPU_CORE: 300.0, RK.GPU_MEMORY: 3000.0},
                priority=9500),
            Pod(meta=ObjectMeta(name="o", labels={"team": "a"}),
                requests={RK.CPU: 1_000.0, RK.MEMORY: 1_024.0,
                          RK.GPU_CORE: 200.0, RK.GPU_MEMORY: 2000.0},
                priority=9100)])

    def zone_hold(once, zone, pods):
        b = tr.gpu_numa_builder()
        b.add_reservation(Reservation(
            meta=ObjectMeta(name="r0"),
            requests={RK.CPU: 4_000.0, RK.MEMORY: 4_096.0},
            owner_label_selector={"team": "a"}, allocate_once=once,
            node_name="n0", phase="Available", required_cpu_bind=True,
            allocated_numa_zone=zone))
        return built(b, pods)

    def bind_owner(name, cpu, mem, priority):
        return Pod(meta=ObjectMeta(name=name, labels={"team": "a"}),
                   requests={RK.CPU: cpu, RK.MEMORY: mem},
                   priority=priority, qos_label="LSR",
                   required_cpu_bind=True)

    return {
        "non_owner_blocked": lambda: simple(10_000, 20_480, [tr.owned_pod(
            "s", 8_000, 8_192, labels={"team": "b"})]),
        "consumer_not_recharging": lambda: simple(
            6_000, 8_192, [tr.owned_pod("p", 4_000, 4_096)]),
        "once_single_winner": lambda: simple(6_000, 8_192, [
            tr.owned_pod("lo", 2_000, 2_048, priority=9001),
            tr.owned_pod("hi", 2_000, 2_048, priority=9500)]),
        "shared_fill_order": lambda: simple(5_000, 20_480, [
            tr.owned_pod(f"p{i}", 2_000, 1_024, priority=9000 + i)
            for i in range(4)], once=False),
        "gang_rollback": gang_rollback,
        "quota_rejected_once_winner": quota_rejected,
        "oversize_owner": lambda: simple(5_000, 20_480, [
            tr.owned_pod("hi", 6_000, 2_048, priority=9500),
            tr.owned_pod("lo", 2_000, 2_048, priority=9001)], once=False,
            node_cpu=20_000.0, node_mem=40_960.0),
        "no_priority_inversion": no_inversion,
        "zero_capacity": zero_capacity,
        "reserved_gpu_minors": gpu_minors,
        "reserved_zone_cpuset": lambda: zone_hold(
            True, 1, [bind_owner("o", 3_000.0, 2_048.0, 9100)]),
        "zone_hold_draining": lambda: zone_hold(
            False, 0, [bind_owner(f"o{i}", 1_500.0, 1_024.0, 9500 - i)
                       for i in range(3)]),
    }


# what each scenario shows in the reference (its own test's assertions):
# (pod row, assignment, res_slot)
SCENARIO_PLACEMENTS = {
    "non_owner_blocked": [(0, 1, -1)],
    "consumer_not_recharging": [(0, 0, 0)],
    "once_single_winner": [(1, 0, 0)],
    "shared_fill_order": [(3, 0, 0), (2, 0, 0)],
    "gang_rollback": [(0, -1, -1), (1, -1, -1), (2, -1, -1)],
    "quota_rejected_once_winner": [(0, -1, -1), (1, 0, 0)],
    "oversize_owner": [(1, 0, 0)],
    "no_priority_inversion": [(1, -1, -1)],
    "zero_capacity": [],
    "reserved_gpu_minors": [(0, -1, -1), (1, 0, 0)],
    "reserved_zone_cpuset": [(0, 0, 0)],
    "zone_hold_draining": [(0, 0, 0), (1, 0, 0)],
}


@functools.lru_cache(maxsize=None)
def _run_scenario(name):
    snap, batch = _scenarios()[name]()
    want = jcore.schedule_batch(snap, batch, JCfg.make(), num_rounds=3)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", batch),
                              LoadAwareConfig.make(device="cpu"),
                              num_rounds=3)
    return want, got


@pytest.mark.parametrize("name", sorted(SCENARIO_PLACEMENTS))
def test_reservation_scenarios_equal_reference(name):
    """Each scenario through both packages with the reference's defaults
    (3 rounds, NUMA and DeviceShare on): every result field, the
    post-batch snapshot and the reservation state equal, and the
    placements the reference's own test asserts."""
    want, got = _run_scenario(name)
    assert_results_equal(want, got)
    for row, node, slot in SCENARIO_PLACEMENTS[name]:
        assert int(got.assignment[row]) == node, (name, row)
        assert int(got.res_slot[row]) == slot, (name, row)


def test_reservation_scenarios_state():
    """The scenarios' reservation state as the reference's tests assert
    it: AllocateOnce exhausted after its consumer, the chosen score of a
    consumer capped at MaxNodeScore, holds drawn down, node requested
    not recharged, reserved minors and zone taken."""
    _, got = _run_scenario("consumer_not_recharging")
    rv = got.snapshot.reservations
    assert float(rv.free[0, int(RK.CPU)]) == 2_000.0
    assert not bool(rv.valid[0]) and float(got.chosen_score[0]) == 100.0
    _, got = _run_scenario("shared_fill_order")
    assert float(got.snapshot.reservations.free[0, int(RK.CPU)]) == 1_000.0
    _, got = _run_scenario("gang_rollback")
    rv = got.snapshot.reservations
    assert float(rv.free[0, int(RK.CPU)]) == 4_000.0 and bool(rv.valid[0])
    _, got = _run_scenario("reserved_gpu_minors")
    assert got.gpu_take[1].tolist() == [False, False, True, True]
    _, got = _run_scenario("reserved_zone_cpuset")
    assert int(got.numa_zone[0]) == 1
    np.testing.assert_array_equal(
        got.snapshot.reservations.numa_free[0, 1].numpy(), [1_000.0, 2_048.0])
    _, got = _run_scenario("zone_hold_draining")
    assert float(got.snapshot.reservations.numa_free[0, 0, 0]) == 1_000.0
