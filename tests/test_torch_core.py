"""The port's slim schedule_batch against the JAX package's under the
bench's exact arguments (bench.py:400-405)."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.api.extension import ResourceKind as RK
from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.snapshot.schema import PER_POD_FIELDS
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch.scheduler import cascade, core
from koordinator_tpu_torch.scheduler.plugins import deviceshare, loadaware
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.utils import synthetic

from torch_port_ref import to_port, with_zones
from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)

BENCH_KW = dict(num_rounds=2, k_choices=8, score_dims=(0, 1),
                tie_break=True, quota_depth=2, fit_dims=(0, 1, 2, 3),
                cascade=False, enable_numa=False)

# (pods, nodes, seed): roomy, contended (pods >> capacity: rejections
# and fall-through), and contended with strict gangs that end below
# quorum (the rollback fires). Two shapes, so JAX compiles twice.
CASES = {"roomy": (256, 64, 0), "contended": (512, 16, 1),
         "gangs_below_quorum": (512, 16, 2)}


@functools.lru_cache(maxsize=None)
def _run(case):
    p, n, seed = CASES[case]
    snap = jsyn.synthetic_cluster(n, seed=seed, num_quotas=8, num_gangs=6,
                                  gang_min_member=8)
    pods = jsyn.synthetic_pods(p, seed=seed + 10, num_quotas=8, num_gangs=6,
                               gang_min_member=8)
    want = jcore.schedule_batch(snap, pods, JCfg.make(), **BENCH_KW)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", pods),
                              LoadAwareConfig.make(device="cpu"), **BENCH_KW)
    return want, got


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("field", ["assignment", "chosen_score",
                                   "gang_failed", "res_slot", "numa_zone",
                                   "aux_inst"])
def test_result_fields_equal(case, field):
    want, got = _run(case)
    w, g = _np(getattr(want, field)), _np(getattr(got, field))
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("path", ["nodes.requested", "quotas.used",
                                  "nodes.assigned_estimated",
                                  "nodes.prod_assigned_estimated",
                                  "gangs.assumed", "version"])
def test_snapshot_state_bit_equal(case, path):
    want, got = _run(case)
    w, g = want.snapshot, got.snapshot
    for part in path.split("."):
        w, g = getattr(w, part), getattr(g, part)
    assert _np(g).tobytes() == _np(w).tobytes()


def test_cases_exercise_rejection_and_rollback():
    for case in CASES:
        want, _ = _run(case)
        placed = int((np.asarray(want.assignment) >= 0).sum())
        assert 0 < placed
        if case != "roomy":
            assert placed < CASES[case][0]
    assert np.asarray(_run("gangs_below_quorum")[0].gang_failed).any()
    _, got = _run("contended")
    assert core.overcommit_ok(got.snapshot) and core.quota_ok(got.snapshot)


def test_slim_path_builds_no_pair_gate(monkeypatch):
    """The slim schedule_batch forms no [P, N] gate mask: K1 takes the
    gates in factored form. The functions that build the mask (static_gates, the
    LoadAware filter_mask, the [P, N, 3] device prefilter) raise while
    it runs, and the result still equals the reference's."""
    def built(*args, **kwargs):
        raise AssertionError("the slim path built a [P, N] gate mask")

    for mod, name in ((cascade, "static_gates"), (deviceshare, "prefilter"),
                      (loadaware, "filter_mask")):
        monkeypatch.setattr(mod, name, built)
        if hasattr(core, name):   # a name imported into core itself
            monkeypatch.setattr(core, name, built)
    want, _ = _run("contended")
    p, n, seed = CASES["contended"]
    snap = jsyn.synthetic_cluster(n, seed=seed, num_quotas=8, num_gangs=6,
                                  gang_min_member=8)
    pods = jsyn.synthetic_pods(p, seed=seed + 10, num_quotas=8, num_gangs=6,
                               gang_min_member=8)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", pods),
                              LoadAwareConfig.make(device="cpu"), **BENCH_KW)
    for field in ("assignment", "chosen_score"):
        assert (_np(getattr(got, field)).tobytes()
                == _np(getattr(want, field)).tobytes())


def _slim_inputs():
    snap = synthetic.synthetic_cluster(8, num_quotas=4, device="cpu")
    pods = synthetic.synthetic_pods(16, num_quotas=4, device="cpu")
    return snap, pods, LoadAwareConfig.make(device="cpu")


@pytest.mark.parametrize("kw", [
    dict(enable_numa=True, enable_amplification=True),
    dict(cascade=True, enable_amplification=True),
    dict(approx_topk=True), dict(enable_amplification=True)], ids=str)
def test_unported_options_raise(kw):
    """Every option of schedule_batch is ported now, so none raises:
    amplification (ROADMAP B21) schedules with the result marked
    amplified (its equality with the reference is
    tests/test_torch_amplification.py's), and approx_topk (B22) runs
    K1's exact select, placing as the batch without it (its equality
    with the reference is tests/test_torch_aux.py's)."""
    snap, pods, cfg = _slim_inputs()
    res = core.schedule_batch(snap, pods, cfg, **dict(BENCH_KW, **kw))
    assert int((res.assignment >= 0).sum()) > 0
    if kw.get("approx_topk"):
        exact = core.schedule_batch(snap, pods, cfg, **BENCH_KW)
        assert torch.equal(res.assignment, exact.assignment)
        assert torch.equal(res.chosen_score, exact.chosen_score)
        return
    assert res.amplified


def test_unported_inputs_raise():
    snap, pods, cfg = _slim_inputs()
    gpu = to_port("ClusterSnapshot", jsyn.synthetic_cluster(
        8, gpu_node_frac=1.0, gpus_per_node=2))
    aux = gpu.replace(devices=gpu.devices.replace(
        aux_free=torch.ones((8, 2, 1)),
        aux_valid=torch.ones((8, 2, 1), dtype=torch.bool)))
    resv = jsyn.synthetic_cluster(8, num_reservations=2)
    # aux pools schedule (ROADMAP B8; their equality with the reference
    # is tests/test_torch_aux.py's): a pod asking for one RDMA VF takes it
    rdma = pods.requests.clone()
    rdma[:, int(RK.RDMA)] = torch.where(torch.arange(16) < 4, 1.0, 0.0)
    res = core.schedule_batch(aux, pods.replace(requests=rdma), cfg,
                              **BENCH_KW)
    took = res.aux_inst[:4, 0]
    assert bool(((took == 0) == (res.assignment[:4] >= 0)).all())
    # a spread family whose domain map is not one column a node
    with pytest.raises(ValueError, match="spread_domain"):
        core.schedule_batch(snap, pods.replace(has_spread=True), cfg,
                            **BENCH_KW)
    # reservation slots (with the NUMA path too), taints and a spread
    # family (one keyless group no pod carries) schedule
    spread = pods.replace(has_spread=True,
                          spread_domain=torch.full((1, 8), -1,
                                                   dtype=torch.int32))
    for ok_snap, ok_pods, kw in (
            (to_port("ClusterSnapshot", resv), pods, BENCH_KW),
            (to_port("ClusterSnapshot", resv), pods,
             dict(BENCH_KW, enable_numa=True)),
            (snap, pods.replace(has_taints=True), BENCH_KW),
            (snap, spread, BENCH_KW)):
        res = core.schedule_batch(ok_snap, ok_pods, cfg, **kw)
        assert int((res.assignment >= 0).sum()) > 0
    with pytest.raises(ValueError, match="numa_strategy"):
        core.schedule_batch(snap, pods, cfg, numa_strategy="spread",
                            **dict(BENCH_KW, enable_numa=True))
    with pytest.raises(ValueError, match="device_strategy"):
        core.schedule_batch(gpu, pods, cfg, device_strategy="spread",
                            **BENCH_KW)
    # GPU instances schedule (aux pools without enable_devices are not
    # looked at, as in the reference)
    core.schedule_batch(gpu, pods, cfg, **BENCH_KW)
    core.schedule_batch(aux, pods, cfg, **dict(BENCH_KW,
                                               enable_devices=False))


@pytest.mark.parametrize("weights", [None, "fractional"])
def test_all_dims_equal_reference(weights):
    """fit_dims=None and score_dims=None (the reference's defaults: all
    11 resource dims gated and scored), contended, with the default
    weights and with fractional ones whose weighted sum rounds."""
    snap = jsyn.synthetic_cluster(24, seed=4, num_quotas=8)
    pods = jsyn.synthetic_pods(384, seed=14, num_quotas=8)
    cfg_kw = {} if weights is None else dict(resource_weights={
        RK(i): w for i, w in enumerate((3.0, 0.7, 1.3, 0.1, 2.9, 0.3, 1.7,
                                        0.9, 0.6, 1.1, 2.2))})
    kw = dict(BENCH_KW, fit_dims=None, score_dims=None)
    want = jcore.schedule_batch(snap, pods, JCfg.make(**cfg_kw), **kw)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", pods),
                              LoadAwareConfig.make(**cfg_kw, device="cpu"),
                              **kw)
    placed = int((np.asarray(want.assignment) >= 0).sum())
    assert 0 < placed < 384
    for w, g in ((want.assignment, got.assignment),
                 (want.chosen_score, got.chosen_score),
                 (want.snapshot.nodes.requested, got.snapshot.nodes.requested),
                 (want.snapshot.quotas.used, got.snapshot.quotas.used),
                 (want.snapshot.nodes.assigned_estimated,
                  got.snapshot.nodes.assigned_estimated)):
        assert _np(g).tobytes() == _np(w).tobytes()


# --- the NodeNUMAResource path (enable_numa=True) -------------------------

NUMA_KW = dict(BENCH_KW, enable_numa=True)
NUMA_FIELDS = ["assignment", "numa_zone", "gang_failed", "numa_take",
               "chosen_score", "res_slot", "snapshot.nodes.numa_free",
               "snapshot.nodes.requested", "snapshot.quotas.used"]


def _field(res, path):
    for part in path.split("."):
        res = getattr(res, part)
    return _np(res)


def _chunk(pods, start, size):
    return pods.replace(**{f: getattr(pods, f)[start:start + size]
                           for f in PER_POD_FIELDS})


@functools.lru_cache(maxsize=None)
def _run_config2_shaped(seed, strategy):
    """BASELINE config 2's shape cut to 400 pods x 60 nodes, chunks of
    200 (each on the previous chunk's snapshot): two populated zones a
    node, 60 % prod pods, every prod pod NUMA-bound."""
    snap = jsyn.with_two_numa_zones(jsyn.synthetic_cluster(
        60, num_quotas=32, seed=seed))
    pods = jsyn.synthetic_pods(400, seed=seed + 1, prod_frac=0.6,
                               num_quotas=32)
    pods = pods.replace(numa_single=jnp.asarray(
        np.asarray(pods.priority_class) == 4))
    tsnap = to_port("ClusterSnapshot", snap)
    tpods = to_port("PodBatch", pods)
    cfg = LoadAwareConfig.make(device="cpu")
    out = []
    for start in (0, 200):
        want = jcore.schedule_batch(snap, _chunk(pods, start, 200),
                                    JCfg.make(), numa_strategy=strategy,
                                    **NUMA_KW)
        got = core.schedule_batch(tsnap, synthetic.slice_batch(
            tpods, start, 200), cfg, numa_strategy=strategy, **NUMA_KW)
        out.append((want, got))
        snap, tsnap = want.snapshot, got.snapshot
    return out


@pytest.mark.parametrize("field", NUMA_FIELDS)
@pytest.mark.parametrize("strategy", ["most", "least"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numa_config2_shaped_equal_reference(seed, strategy, field):
    """Every chunk's field equal to the reference's, bit for bit."""
    for want, got in _run_config2_shaped(seed, strategy):
        w, g = _field(want, field), _field(got, field)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes(), field
    want, _ = _run_config2_shaped(seed, strategy)[1]
    assert (np.asarray(want.numa_zone) >= 0).sum() > 50


def _policy_snapshot(n, seed, z):
    """n nodes whose zone capacity splits each node's allocatable over z
    zones (about 15 % of zones invalid, zone 0 valid), partly used,
    every topology policy code."""
    snap = jsyn.synthetic_cluster(n, num_quotas=8, seed=seed)
    rng = np.random.default_rng(seed + 100)
    alloc = np.asarray(snap.nodes.allocatable)
    share = rng.dirichlet(np.ones(z), n).astype(np.float32)
    cap = np.zeros((n, z, 2), np.float32)
    cap[:, :, 0] = np.floor(alloc[:, None, 0] * share / 500) * 500
    cap[:, :, 1] = np.floor(alloc[:, None, 1] * share / 512) * 512
    valid = rng.uniform(size=(n, z)) < 0.85
    valid[:, 0] = True
    cap = cap * valid[:, :, None]
    used = np.floor(cap * rng.uniform(0, 0.6, (n, z, 1)) / 500) * 500
    resv = snap.reservations
    return snap.replace(
        nodes=snap.nodes.replace(
            numa_cap=jnp.asarray(cap),
            numa_free=jnp.asarray((cap - used).astype(np.float32)),
            numa_valid=jnp.asarray(valid),
            numa_policy=jnp.asarray(np.arange(n, dtype=np.int32) % 4)),
        reservations=resv.replace(numa_free=resv.numa_free[:, :z],
                                  numa_valid=resv.numa_valid[:, :z]))


@functools.lru_cache(maxsize=None)
def _run_policy(z, strategy):
    """16 nodes with every policy code against 300 pods (70 % prod, half
    of those NUMA-bound): contended, so zone gates reject, and
    best-effort / restricted nodes split takes across zones."""
    snap = _policy_snapshot(16, z, z)
    pods = jsyn.synthetic_pods(300, seed=z + 1, prod_frac=0.7, num_quotas=8)
    rng = np.random.default_rng(z)
    pods = pods.replace(numa_single=jnp.asarray(
        (np.asarray(pods.priority_class) == 4)
        & (rng.uniform(size=300) < 0.5)))
    want = jcore.schedule_batch(snap, pods, JCfg.make(),
                                numa_strategy=strategy, **NUMA_KW)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", pods),
                              LoadAwareConfig.make(device="cpu"),
                              numa_strategy=strategy, **NUMA_KW)
    return want, got


@pytest.mark.parametrize("field", NUMA_FIELDS)
@pytest.mark.parametrize("strategy", ["most", "least"])
@pytest.mark.parametrize("zones", [2, 4])
def test_numa_policy_nodes_equal_reference(zones, strategy, field):
    want, got = _run_policy(zones, strategy)
    w, g = _field(want, field), _field(got, field)
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes(), field
    take = np.asarray(want.numa_take)
    assert ((take[:, :, 0] > 0).sum(axis=1) > 1).any()   # split takes
    assert 0 < (np.asarray(want.assignment) >= 0).sum() < 300


def _scenario(nodes, pods):
    from koordinator_tpu.snapshot.builder import SnapshotBuilder
    from test_numaaware import NOW
    from koordinator_tpu.api.types import NodeMetric
    b = SnapshotBuilder(max_nodes=len(nodes), max_reservations=0)
    for n in nodes:
        b.add_node(n)
        b.set_node_metric(NodeMetric(node_name=n.meta.name,
                                     update_time=NOW - 2,
                                     node_usage={RK.CPU: 0.0}))
    snap, ctx = b.build(now=NOW)
    return snap, b.build_pod_batch(pods, ctx)


def _scenarios():
    """The end-to-end NUMA scenarios of tests/test_numaaware.py
    (single-zone fit, zone contention, packing, unbound pods, and the
    four topology policies on plain pods), on snapshots built without
    reservation rows."""
    from test_numaaware import bind_pod, numa_node, plain_pod, policy_node
    return {
        "single_numa_fit": ([numa_node("small", zone_cpu=4000.0),
                             numa_node("big", zone_cpu=8000.0)],
                            [bind_pod("p", 6000.0, 1024.0)]),
        "zone_contention": ([numa_node("n0")],
                            [bind_pod(f"p{i}", 5000.0, 1024.0,
                                      priority=9500 - i) for i in range(3)]),
        "packing": ([numa_node("n0")],
                    [bind_pod("a", 2000.0, 1024.0, priority=9500),
                     bind_pod("b", 2000.0, 1024.0, priority=9400)]),
        "unbound": ([numa_node("n0", zone_cpu=2000.0)],
                    [plain_pod("p", 3000.0, 0.0)]),
        "policy_none": ([policy_node("n0", "None")],
                        [plain_pod("p", 3000.0, 1024.0)]),
        "best_effort_split": ([policy_node("n0", "BestEffort")],
                              [plain_pod("p", 3000.0, 1024.0)]),
        "restricted": ([policy_node("ok", "Restricted", zone_cpu=4000.0)],
                       [plain_pod("p", 3000.0, 1024.0)]),
        "single_numa_policy": ([policy_node("strict", "SingleNUMANode"),
                                policy_node("soft", "BestEffort")],
                               [plain_pod("p", 3000.0, 1024.0)]),
        "single_numa_policy_alone": ([policy_node("strict", "SingleNUMANode")],
                                     [plain_pod("p", 3000.0, 1024.0)]),
        "policy_contention": ([policy_node("n0", "BestEffort")],
                              [plain_pod(f"p{i}", 1500.0, 512.0,
                                         priority=9500 - i)
                               for i in range(3)]),
    }


@pytest.mark.parametrize("strategy", ["most", "least"])
@pytest.mark.parametrize("name", sorted(_scenarios()))
def test_numa_scenarios_equal_reference(name, strategy):
    """Each scenario through both packages with the reference's defaults
    (3 rounds; all dims fitted and scored; 4 zone slots, 2 populated):
    every result field and the zone state equal."""
    snap, pods = _scenario(*_scenarios()[name])
    want = jcore.schedule_batch(snap, pods, JCfg.make(), num_rounds=3,
                                numa_strategy=strategy)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", pods),
                              LoadAwareConfig.make(device="cpu"),
                              num_rounds=3, numa_strategy=strategy)
    for field in NUMA_FIELDS:
        w, g = _field(want, field), _field(got, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert g.tobytes() == w.tobytes(), field


# --- the DeviceShare path (enable_devices=True with GPU instances) --------

GPU_FIELDS = ["assignment", "chosen_score", "numa_zone", "numa_take",
              "gpu_take", "gang_failed", "snapshot.nodes.requested",
              "snapshot.nodes.numa_free", "snapshot.devices.gpu_free",
              "snapshot.quotas.used", "snapshot.gangs.assumed"]


def _assert_fields_equal(want, got, fields=GPU_FIELDS):
    for field in fields:
        w, g = _field(want, field), _field(got, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert g.tobytes() == w.tobytes(), field


def _gpu_scenarios():
    """The end-to-end DeviceShare scenarios of tests/test_deviceshare.py
    (:93-252), built with the reference's SnapshotBuilder without
    reservation rows: (SnapshotBuilder, pods, schedule_batch kwargs)."""
    from koordinator_tpu.api.types import (
        Device,
        DeviceInfo,
        Node,
        NodeMetric,
        ObjectMeta,
    )
    from koordinator_tpu.snapshot.builder import SnapshotBuilder
    from test_deviceshare import CPU, GC, GM, MEM, _topo, gpu_pod

    def nodes(**kw):
        from test_deviceshare import make_builder
        return make_builder(max_reservations=0, **kw)

    def running(b, name, core_, minors):
        r = gpu_pod(name, core=core_, ratio=core_)
        r.node_name = "n0"
        r.allocated_gpu_minors = minors
        b.add_running_pod(r)
        return b

    def bare(gpus):
        b = SnapshotBuilder(max_nodes=len(gpus), max_gpu_inst=1,
                            max_reservations=0)
        for i, gmem in enumerate(gpus):
            b.add_node(Node(meta=ObjectMeta(name=f"n{i}"),
                            allocatable={CPU: 32000.0, MEM: 64000.0}))
            b.set_node_metric(NodeMetric(node_name=f"n{i}", update_time=1e9,
                                         node_usage={CPU: 100.0,
                                                     MEM: 100.0}))
            if gmem:
                b.add_device(Device(node_name=f"n{i}", devices=[
                    DeviceInfo(minor=0, type="gpu",
                               resources={GC: 100.0, GM: gmem})]))
        return b

    def numa_nodes(gpus):
        b = nodes(num_nodes=1, gpus=gpus)
        b.nodes[0].topology = _topo()
        return b

    out = {
        "shared_pack": (nodes(num_nodes=1, gpus=2),
                        [gpu_pod(f"p{i}", core=60, ratio=60, prio=9000 - i)
                         for i in range(3)], {}),
        "multi_whole_p4": (running(nodes(num_nodes=1, gpus=4), "r", 10,
                                   (2,)),
                           [gpu_pod("p4", core=400, ratio=400)], {}),
        "multi_whole_p3": (running(nodes(num_nodes=1, gpus=4), "r", 10,
                                   (2,)),
                           [gpu_pod("p3", core=300, ratio=300)], {}),
        "ratio_only_no_gpus": (bare([0.0]), [gpu_pod("p", ratio=50)], {}),
        "gpuless_node": (bare([1000.0, 0.0]),
                         [gpu_pod("p", core=50, ratio=50)], {}),
        "memory_per_node": (bare([500.0, 1000.0]),
                            [gpu_pod("p", core=10, mem=600.0)], {}),
        "numa_alignment_p4": (numa_nodes(4),
                              [gpu_pod("p4", core=400, ratio=400,
                                       required_cpu_bind=True)], {}),
        "numa_alignment_p2": (numa_nodes(4),
                              [gpu_pod("p2", core=200, ratio=200,
                                       required_cpu_bind=True)], {}),
        "zone_merges_gpu_hint": (numa_nodes(4),
                                 [gpu_pod(f"p{i}", core=200, ratio=200,
                                          prio=9000 - i,
                                          required_cpu_bind=True)
                                  for i in range(2)], {}),
        "numa_disabled": (nodes(num_nodes=1, gpus=2),
                          [gpu_pod("p", core=50, ratio=50,
                                   required_cpu_bind=True)],
                          dict(enable_numa=False)),
        "restored_full": (running(nodes(num_nodes=1, gpus=2), "r", 200,
                                  (0, 1)),
                          [gpu_pod("p", core=50, ratio=50)], {}),
    }
    for strategy in ("least", "most"):
        out[f"strategy_{strategy}"] = (
            running(nodes(num_nodes=1, gpus=2), "r", 50, (0,)),
            [gpu_pod("p", core=30, ratio=30)],
            dict(device_strategy=strategy))
    return out


def _schedule_both(snap, pods, **kw):
    """The reference's and the port's schedule_batch on the same inputs,
    with the scenario tests' defaults (3 rounds, 4 choices)."""
    kw = dict(dict(num_rounds=3, k_choices=4), **kw)
    want = jcore.schedule_batch(snap, pods, JCfg.make(), **kw)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", pods),
                              LoadAwareConfig.make(device="cpu"), **kw)
    return want, got


@pytest.mark.parametrize("name", sorted(_gpu_scenarios()))
def test_gpu_scenarios_equal_reference(name):
    """Each DeviceShare scenario through both packages with the
    reference's defaults (NUMA on, all dims, device strategy "least"
    unless the scenario names one): every result field, the instance
    free and the zone state equal."""
    b, pod_list, kw = _gpu_scenarios()[name]
    snap, ctx = b.build(now=1e9)
    want, got = _schedule_both(snap, b.build_pod_batch(pod_list, ctx), **kw)
    _assert_fields_equal(want, got)


def test_gpu_scenarios_place_as_the_reference_tests_expect():
    """The outcomes tests/test_deviceshare.py asserts, on the port."""
    def run(name):
        b, pod_list, kw = _gpu_scenarios()[name]
        snap, ctx = b.build(now=1e9)
        return _schedule_both(snap, b.build_pod_batch(pod_list, ctx),
                              **kw)[1]

    res = run("shared_pack")
    assert res.assignment.tolist() == [0, 0, -1]
    assert not (res.gpu_take[0] & res.gpu_take[1]).any()
    assert res.snapshot.devices.gpu_free[0, :, 0].tolist() == [40.0, 40.0]
    assert run("multi_whole_p4").assignment.tolist() == [-1]
    res = run("multi_whole_p3")
    assert res.gpu_take[0].nonzero()[:, 0].tolist() == [0, 1, 3]
    assert run("ratio_only_no_gpus").assignment.tolist() == [-1]
    assert run("gpuless_node").assignment.tolist() == [0]
    assert run("memory_per_node").assignment.tolist() == [1]
    assert run("numa_alignment_p4").assignment.tolist() == [-1]
    res = run("zone_merges_gpu_hint")
    assert sorted(res.numa_zone.tolist()) == [0, 1]
    res = run("numa_disabled")
    assert res.assignment.tolist() == [0] and int(res.gpu_take.sum()) == 1
    assert run("restored_full").assignment.tolist() == [-1]
    assert run("strategy_least").gpu_take[0].nonzero()[:, 0].tolist() == [1]
    assert run("strategy_most").gpu_take[0].nonzero()[:, 0].tolist() == [0]


@pytest.mark.parametrize("seed", [0, 1])
def test_gpu_chunk1_matches_batch_capacity_as_reference(seed):
    """test_deviceshare.py test_chunk1_matches_batch_capacity through
    both packages: the batch and the one-pod-at-a-time runs (each pod on
    the previous pod's snapshot) equal field for field, and their placed
    GPU demand within one multi-GPU pod of each other."""
    snap = jsyn.synthetic_cluster(16, gpu_node_frac=1.0, seed=seed,
                                  gpus_per_node=4)
    pods = jsyn.synthetic_pods(48, gpu_pod_frac=1.0, seed=seed + 10)
    want, got = _schedule_both(snap, pods, k_choices=4, num_rounds=4)
    _assert_fields_equal(want, got)
    s, ts = snap, to_port("ClusterSnapshot", snap)
    tpods = to_port("PodBatch", pods)
    cfg, jcfg = LoadAwareConfig.make(device="cpu"), JCfg.make()
    placed_seq = np.zeros(48, bool)
    for i in np.argsort(-np.asarray(pods.priority), kind="stable"):
        w = jcore.schedule_batch(s, jsyn.slice_batch(pods, int(i), 1), jcfg,
                                 num_rounds=1, k_choices=4)
        g = core.schedule_batch(ts, synthetic.slice_batch(tpods, int(i), 1),
                                cfg, num_rounds=1, k_choices=4)
        _assert_fields_equal(w, g)
        s, ts = w.snapshot, g.snapshot
        placed_seq[i] = bool(g.assignment[0] >= 0)
    ratio = np.asarray(pods.gpu_ratio)
    count = np.where(ratio > 100, ratio // 100, 1)
    placed_b = got.assignment.numpy() >= 0
    assert abs((count * placed_b).sum() - (count * placed_seq).sum()) \
        <= count.max()


def test_eight_zones_and_56_instances_chunk_equals_reference():
    """One batch at fault C8's widths through both packages: eight NUMA
    zones a node (every policy code) and 56 GPU instances a GPU node (8
    GPUs in 7 MIG slices, spread over the zones), 60 % GPU pods, NUMA on
    (a third of the prod pods NUMA-bound). Every result field, the
    instance free and the zone state equal, the f32 ones bit for bit."""
    snap = with_zones(jsyn.synthetic_cluster(
        24, seed=3, num_quotas=8, gpu_node_frac=0.7, gpus_per_node=56),
        8, seed=8)
    pods = jsyn.synthetic_pods(240, seed=4, prod_frac=0.7, num_quotas=8,
                               gpu_pod_frac=0.6)
    rng = np.random.default_rng(5)
    pods = pods.replace(numa_single=jnp.asarray(
        (np.asarray(pods.priority_class) == 4)
        & (rng.uniform(size=240) < 0.33)))
    want, got = _schedule_both(snap, pods)
    _assert_fields_equal(want, got)
    placed = np.asarray(want.assignment) >= 0
    take = np.asarray(want.gpu_take)
    assert 0 < placed.sum() < 240 and (take.sum(axis=1) > 1).any()
    assert (np.asarray(want.numa_zone) >= 0).any()
