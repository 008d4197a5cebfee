"""The ElasticQuota fair share (ROADMAP B16) in the port against the JAX
package: `ops.quota_demand.add_pending_demand` (K3's plain version),
`ops.waterfill.propagate_demand` and `compute_runtime` (K18's plain
version) against the reference's jitted functions on the same inputs,
bit for bit (limited demand, runtime, folded demand):

- the reference's own scenarios (tests/test_waterfill.py: the oracle
  trees of seeds 0-5, a quota that does not lend, the child max clamp,
  a non-lending child flooring its parent, the fold -> runtime ->
  schedule_batch composition);
- the full-width `config_4_fair_share_500q_50k` tree (50 000 pods
  folded; rounds run at levels 1-3), config 4's own tree (no round
  runs), a six-level chain that lends nothing, unlimited maxes with
  zero weights, the cap `max_iters = 2`, a fold with quota-less,
  invalid and out-of-table pods;
- one case that shows the comparison sees the order of the segment
  sums: on a tree with fractional sibling weights, adding a parent's
  children in reverse row order changes some runtime bit;
- `configs.run_config_4_fair_share` cut to 5000 pods x 500 nodes: every
  field of the final snapshot and the assignment equal to the
  reference's composition driven from the host chunk by chunk.

Tolerances: none."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from koordinator_tpu.api.extension import NUM_RESOURCES, ResourceKind as RK
from koordinator_tpu.api.types import ElasticQuota, Node, ObjectMeta
from koordinator_tpu.ops import waterfill as jwf
from koordinator_tpu.ops.quota_demand import add_pending_demand as jfold
from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.snapshot.builder import SnapshotBuilder
from koordinator_tpu.snapshot.schema import QuotaState as JQuotaState
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch import configs
from koordinator_tpu_torch.kernels.quota_runtime import quota_runtime
from koordinator_tpu_torch.ops import waterfill
from koordinator_tpu_torch.ops.quota_demand import add_pending_demand
from koordinator_tpu_torch.scheduler import core
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.utils import synthetic

from test_waterfill import build_forest

from torch_port_ref import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_bits_equal,
    one_torch_thread,
    ref_tree,
    to_port,
    tree,
)

CPU, MEM = int(RK.CPU), int(RK.MEMORY)


def _total(**cols):
    t = np.zeros((NUM_RESOURCES,), np.float32)
    for k, v in cols.items():
        t[int(RK[k])] = v
    return t


def _both(jq, total, max_iters=64):
    """(reference runtime, limited), (port runtime, limited, rounds)."""
    want = (np.asarray(jwf.compute_runtime(jq, total, max_iters=max_iters)),
            np.asarray(jwf.propagate_demand(jq)))
    got = waterfill.compute_runtime_plain(to_port("QuotaState", jq),
                                          torch.from_numpy(total), max_iters)
    return want, got


def assert_runtime_equal(jq, total, max_iters=64):
    """The port's runtime and limited demand bit-equal to the
    reference's; returns (runtime, limited, rounds) of the port."""
    (rt, lim), (got_rt, got_lim, rounds) = _both(jq, total, max_iters)
    assert_bits_equal(got_lim.numpy(), lim, "limited")
    assert_bits_equal(got_rt.numpy(), rt, "runtime")
    port = to_port("QuotaState", jq)
    assert_bits_equal(waterfill.propagate_demand(port).numpy(), lim,
                      "propagate_demand")
    assert_bits_equal(waterfill.compute_runtime(
        port, torch.from_numpy(total), max_iters).numpy(), rt,
        "compute_runtime")
    return rt, lim, rounds


# --- the reference's scenarios ---------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_oracle_trees_equal_reference(seed):
    """tests/test_waterfill.py's oracle forests: a root of 100 000 CPU and
    six children with random min, max, weight and lending, random demand."""
    rng = np.random.default_rng(seed)
    b, spec, total = build_forest(rng)
    snap, _ = b.build(now=0.0)
    demand = np.array(snap.quotas.demand).copy()
    for i, q in enumerate(b.quotas):
        if q.meta.name != "root":
            demand[i, CPU] = float(rng.integers(0, 80) * 1000)
    assert_runtime_equal(snap.quotas.replace(demand=demand),
                         _total(CPU=total))


def _small_tree(quotas, demands, total):
    """A SnapshotBuilder forest of `quotas` (ElasticQuota) with CPU demand
    {name: value}; returns (reference QuotaState, names)."""
    b = SnapshotBuilder(max_nodes=1, max_quotas=8)
    b.add_node(Node(meta=ObjectMeta(name="n0"), allocatable={}))
    for q in quotas:
        b.add_quota(q)
    snap, _ = b.build(now=0.0)
    names = [q.meta.name for q in b.quotas]
    demand = np.array(snap.quotas.demand)
    for name, v in demands.items():
        demand[names.index(name), CPU] = v
    return snap.quotas.replace(demand=demand), names


def _eq(name, parent=None, **kw):
    return ElasticQuota(meta=ObjectMeta(name=name), parent=parent, **kw)


SCENARIOS = {
    # allowLentResource=false keeps min at zero demand
    "not_lending": ([
        _eq("root", max={RK.CPU: 10000.0}),
        _eq("hoarder", "root", min={RK.CPU: 4000.0}, max={RK.CPU: 8000.0},
            allow_lent_resource=False),
        _eq("hungry", "root", min={RK.CPU: 0.0}, max={RK.CPU: 10000.0},
            shared_weight={RK.CPU: 1.0})], {"hungry": 10000.0}, 10000.0,
        {"hoarder": 4000.0, "hungry": 6000.0}),
    # a child's demand is capped at its max before it reaches its parent
    "child_max_clamp": ([
        _eq("root", max={RK.CPU: 100000.0}),
        _eq("mid", "root", max={RK.CPU: 100000.0},
            shared_weight={RK.CPU: 1.0}, is_parent=True),
        _eq("capped", "mid", max={RK.CPU: 10000.0},
            shared_weight={RK.CPU: 1.0}),
        _eq("sib", "root", max={RK.CPU: 100000.0},
            shared_weight={RK.CPU: 1.0})],
        {"capped": 100000.0, "sib": 100000.0}, 100000.0,
        {"mid": 10000.0, "sib": 90000.0, "capped": 10000.0}),
    # a non-lending child floors its parent's subtree demand at its min
    "non_lending_floor": ([
        _eq("root", max={RK.CPU: 100000.0}),
        _eq("mid", "root", max={RK.CPU: 100000.0},
            shared_weight={RK.CPU: 1.0}, is_parent=True),
        _eq("hoard", "mid", min={RK.CPU: 30000.0}, max={RK.CPU: 50000.0},
            allow_lent_resource=False, shared_weight={RK.CPU: 1.0}),
        _eq("sib", "root", max={RK.CPU: 100000.0},
            shared_weight={RK.CPU: 1.0})], {"sib": 100000.0}, 100000.0,
        {"mid": 30000.0, "sib": 70000.0}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reference_scenarios_equal_reference(name):
    """tests/test_waterfill.py's three hand trees: equal to the reference
    and to the runtimes that file asserts."""
    quotas, demands, total, expect = SCENARIOS[name]
    jq, names = _small_tree(quotas, demands, total)
    rt, _, _ = assert_runtime_equal(jq, _total(CPU=total))
    for q, v in expect.items():
        assert rt[names.index(q), CPU] == v


def test_fold_runtime_and_gate_end_to_end():
    """tests/test_waterfill.py's composition: two equal siblings under a
    root of 30 000 CPU, four pods of 5000 each; the fold, the runtime and
    the batch equal the reference's, three pods placed a quota."""
    from koordinator_tpu.api.types import NodeMetric, Pod
    from koordinator_tpu.scheduler.plugins import loadaware

    b = SnapshotBuilder(max_nodes=2, max_quotas=8)
    for i in range(2):
        b.add_node(Node(meta=ObjectMeta(name=f"n{i}"),
                        allocatable={RK.CPU: 100000, RK.MEMORY: 1 << 20}))
        b.set_node_metric(NodeMetric(node_name=f"n{i}", update_time=1.0,
                                     node_usage={}))
    b.add_quota(_eq("root", max={RK.CPU: 30000.0, RK.MEMORY: 1 << 30}))
    for name in ("a", "b"):
        b.add_quota(_eq(name, "root",
                        max={RK.CPU: 30000.0, RK.MEMORY: 1 << 30},
                        shared_weight={RK.CPU: 1.0, RK.MEMORY: 1.0}))
    snap, ctx = b.build(now=1.0)
    pods = [Pod(meta=ObjectMeta(name=f"p{q}{j}"), priority=9000 - 1000 * k,
                requests={RK.CPU: 5000.0, RK.MEMORY: 64.0}, quota_name=q)
            for k, q in enumerate("ab") for j in range(4)]
    batch = b.build_pod_batch(pods, ctx)
    total = _total(CPU=30000.0, MEMORY=float(1 << 30))
    jq = jfold(snap.quotas, batch)
    jrt = jwf.compute_runtime(jq, total)
    jsnap = snap.replace(quotas=jq.replace(runtime=jrt))
    want = jcore.schedule_batch(jsnap, batch, loadaware.LoadAwareConfig.make(),
                                num_rounds=2)

    tsnap = to_port("ClusterSnapshot", snap)
    tbatch = to_port("PodBatch", batch)
    tq = add_pending_demand(tsnap.quotas, tbatch)
    assert_bits_equal(tq.demand.numpy(), np.asarray(jq.demand), "demand")
    trt = waterfill.compute_runtime(tq, torch.from_numpy(total))
    assert_bits_equal(trt.numpy(), np.asarray(jrt), "runtime")
    got = core.schedule_batch(tsnap.replace(quotas=tq.replace(runtime=trt)),
                              tbatch, LoadAwareConfig.make(device="cpu"),
                              num_rounds=2)
    a = got.assignment.numpy()
    np.testing.assert_array_equal(a, np.asarray(want.assignment))
    assert_bits_equal(tree(got.snapshot), ref_tree(want.snapshot))
    assert (a[:4] >= 0).sum() == 3 and (a[4:] >= 0).sum() == 3


# --- the fair-share workload's trees ---------------------------------------


@functools.lru_cache(maxsize=None)
def _fair_share(num_pods=50_000, num_nodes=5000):
    """(reference QuotaState with the folded demand, the unfolded one,
    the pods, cluster_total) of config_4_fair_share_500q_50k."""
    snap = jsyn.synthetic_cluster(num_nodes, num_quotas=500, max_quotas=512,
                                  seed=0)
    pods = jsyn.synthetic_pods(num_pods, seed=1, num_quotas=500)
    t = synthetic.fair_share_tree(np.asarray(snap.nodes.allocatable),
                                  np.asarray(snap.nodes.schedulable),
                                  num_pods)
    jq = JQuotaState(**t["quotas"])
    pods = pods.replace(quota_id=t["quota_id"])
    return jfold(jq, pods), jq, pods, t["cluster_total"]


def test_fair_share_tree_equals_reference_and_binds():
    """The full-width tree (500 quotas over four levels, 50 000 pods
    folded): the fold, the limited demand and the runtime bit-equal;
    the rounds run at levels 1-3, fractional runtimes fall below their
    limited demand at every level, and the leaves' CPU demand is
    1.1-1.5x the root's."""
    folded, jq, pods, total = _fair_share()
    port = add_pending_demand(to_port("QuotaState", jq),
                              to_port("PodBatch", pods))
    assert_bits_equal(port.demand.numpy(), np.asarray(folded.demand),
                      "demand")
    rt, lim, rounds = assert_runtime_equal(folded, total)
    assert all(r > 0 for r in rounds[1:4]) and rounds[4:] == [0, 0]
    depth = np.asarray(waterfill.quota_depth(port))
    for d in (1, 2, 3):
        assert (rt[depth == d, CPU] < lim[depth == d, CPU]).any()
    below = rt[:, CPU] < lim[:, CPU]
    assert (rt[below, CPU] != np.floor(rt[below, CPU])).any()
    ratio = np.asarray(folded.demand)[:, CPU].sum() / jq.max[0, CPU]
    assert 1.1 <= ratio <= 1.5


def test_config_4_tree_is_degenerate_in_cpu_and_memory():
    """Config 4's own tree (root and 499 children, 50 000 pods folded):
    equal to the reference, and degenerate for the water-fill in CPU and
    memory: every child's demand there is within its min, so its runtime
    is its limited demand. Rounds run only in the batch columns, where
    every max is unlimited and every child weighs 1."""
    snap = jsyn.synthetic_cluster(5000, num_quotas=500, max_quotas=512,
                                  seed=0)
    pods = jsyn.synthetic_pods(50_000, seed=1, num_quotas=500)
    jq = jfold(snap.quotas, pods)
    total = np.asarray(snap.nodes.allocatable).astype(np.float64).sum(
        0).astype(np.float32)
    rt, lim, rounds = assert_runtime_equal(jq, total)
    kids = np.asarray(snap.quotas.valid) & (np.asarray(snap.quotas.parent)
                                            == 0)
    assert_bits_equal(rt[kids][:, [CPU, MEM]], lim[kids][:, [CPU, MEM]])
    assert (np.asarray(jq.demand)[kids][:, [CPU, MEM]]
            <= np.asarray(jq.min)[kids][:, [CPU, MEM]]).all()
    assert rounds[2:] == [0] * 4


def _chain(rng, depth=6, width=3):
    """A six-level chain (root, then `width` children a level, one of
    which parents the next level) where no quota lends; fractional mins,
    maxes, weights and demand."""
    q, parent, head = 32, [-1], 0
    for _ in range(1, depth):
        first = len(parent)
        parent += [head] * width
        head = first
    n = len(parent)
    par = np.full((q,), -1, np.int32)
    par[:n] = parent
    da = np.full((q, 6), -1, np.int32)
    anc = np.zeros((q, q), bool)
    for i in range(n):
        chain = [i]
        while par[chain[-1]] >= 0:
            chain.append(int(par[chain[-1]]))
        da[i, :len(chain)] = chain[::-1]
        anc[i, chain] = True
    f32 = np.float32
    mx = np.full((q, NUM_RESOURCES), np.inf, f32)
    mx[:n, :2] = rng.uniform(2e4, 8e4, (n, 2))
    mn = np.zeros((q, NUM_RESOURCES), f32)
    mn[:n, :2] = rng.uniform(0, 1.5e4, (n, 2))
    sw = np.zeros((q, NUM_RESOURCES), f32)
    sw[:n, :2] = rng.uniform(0.1, 3.0, (n, 2))
    dem = np.zeros((q, NUM_RESOURCES), f32)
    dem[:n, :2] = rng.uniform(0, 6e4, (n, 2))
    return JQuotaState(
        min=mn, max=mx, shared_weight=sw, parent=par, ancestors=anc,
        depth_ancestor=da, used=np.zeros_like(mn), demand=dem,
        allow_lent=np.zeros((q,), bool), runtime=mx.copy(),
        valid=np.arange(q) < n)


def test_six_level_chain_without_lending_equals_reference():
    """Levels 1-5 all redistribute (MAX_QUOTA_DEPTH = 6) on a tree whose
    quotas keep their min."""
    jq = _chain(np.random.default_rng(3))
    _, _, rounds = assert_runtime_equal(jq, _total(CPU=1e5, MEMORY=2e5))
    assert np.asarray(jwf.propagate_demand(jq)).shape == (32, NUM_RESOURCES)
    assert int((np.asarray(waterfill.quota_depth(
        to_port("QuotaState", jq))) == 5).sum()) > 0
    assert sum(rounds) > 0


def test_unlimited_maxes_and_zero_weights_equal_reference():
    """The fair-share tree with every max unlimited in memory and the
    explicit weights zeroed in CPU (weights fall back to max, and to 1
    where max is infinite)."""
    folded, _, _, total = _fair_share()
    mx = np.array(folded.max)
    mx[1:, MEM] = np.inf
    sw = np.array(folded.shared_weight)
    sw[:, CPU] = 0.0
    assert_runtime_equal(folded.replace(max=mx, shared_weight=sw), total)


def test_max_iters_cap_binds_equal_reference():
    """max_iters = 2 on the fair-share tree: the cap stops some level's
    loop, and the capped runtime differs from the uncapped one."""
    folded, _, _, total = _fair_share()
    rt2, _, rounds = assert_runtime_equal(folded, total, max_iters=2)
    assert max(rounds) == 2
    rt, _, _ = assert_runtime_equal(folded, total)
    assert not np.array_equal(rt, rt2)


def test_fold_with_quota_less_and_invalid_pods_equals_reference():
    """Quota-less pods, invalid pods (valid False: they add 0), and quota
    ids beyond the table are dropped as the reference drops them."""
    _, jq, pods, _ = _fair_share(4000, 500)
    rng = np.random.default_rng(9)
    qid = np.array(pods.quota_id)
    qid[rng.uniform(size=qid.size) < 0.2] = -1
    qid[rng.uniform(size=qid.size) < 0.01] = 600
    valid = rng.uniform(size=qid.size) >= 0.1
    pods = pods.replace(quota_id=qid, valid=valid)
    want = jfold(jq, pods)
    got = add_pending_demand(to_port("QuotaState", jq),
                             to_port("PodBatch", pods))
    assert_bits_equal(got.demand.numpy(), np.asarray(want.demand))
    assert_runtime_equal(want, _fair_share(4000, 500)[3])


_CHILDREN = waterfill.children


def _reversed_children(parent, q):
    kids = _CHILDREN(parent, q)
    real = (kids < q).sum(dim=1, keepdim=True)
    f = kids.shape[1]
    idx = (real - 1 - torch.arange(f)[None]) % f
    return torch.where(torch.arange(f)[None] < real,
                       torch.gather(kids, 1, idx), q)


def test_segment_sums_order_is_seen(monkeypatch):
    """The comparison sees the order of additions: on the fair-share tree
    (fractional sibling weights) with a fractional part added to each
    leaf's demand, the port equals the reference, and adding each
    parent's children in reverse row order changes some runtime bit (a
    parent whose runtime is its limited demand, a sum of its children)."""
    folded, _, _, total = _fair_share()
    rng = np.random.default_rng(4)
    dem = np.array(folded.demand)
    leaves = np.asarray(folded.valid) & (np.asarray(
        folded.depth_ancestor)[:, 3] >= 0)
    dem[leaves, CPU] += rng.uniform(0.0, 1.0, int(leaves.sum())).astype(
        np.float32)
    jq = folded.replace(demand=dem)
    rt, _, _ = assert_runtime_equal(jq, total)
    monkeypatch.setattr(waterfill, "children", _reversed_children)
    got, _, _ = waterfill.compute_runtime_plain(to_port("QuotaState", jq),
                                                torch.from_numpy(total))
    assert not np.array_equal(got.numpy().view(np.uint32),
                              rt.view(np.uint32))


def test_quota_runtime_wrapper_on_the_host():
    """K18's wrapper given CPU tensors returns the plain version's
    runtime, limited demand and rounds a level; with demand_only the
    limited demand alone; it checks its inputs."""
    folded, _, _, total = _fair_share()
    port = to_port("QuotaState", folded)
    res = quota_runtime(port, torch.from_numpy(total))
    rt, lim, rounds = waterfill.compute_runtime_plain(
        port, torch.from_numpy(total))
    assert torch.equal(res.runtime, rt) and torch.equal(res.limited, lim)
    assert res.rounds.tolist() == rounds and res.rounds.dtype == torch.int32
    only = quota_runtime(port, None, demand_only=True)
    assert only.runtime is None and torch.equal(only.limited, lim)
    with pytest.raises(TypeError):
        quota_runtime(port.replace(parent=port.parent.long()),
                      torch.from_numpy(total))
    with pytest.raises(ValueError):
        quota_runtime(port, torch.from_numpy(total)[:3])


# --- config_4_fair_share cut to 5000 pods x 500 nodes ----------------------

FS_PODS, FS_NODES, FS_CHUNK = 5000, 500, 2500


def test_config_4_fair_share_equals_reference():
    """`run_config_4_fair_share` at 5000 pods x 500 nodes in chunks of
    2500 against the reference's fold, runtime and chunked
    `schedule_batch` (config 4's knobs, four quota levels): the
    assignment and every leaf of the final snapshot equal; the line
    counts the placed pods and the quotas held below their demand; the
    pods turned away by the runtime are counted against a run at
    runtime = max; quota used within runtime."""
    folded, _, pods, total = _fair_share(FS_PODS, FS_NODES)
    snap = jsyn.synthetic_cluster(FS_NODES, num_quotas=500, max_quotas=512,
                                  seed=0)
    rt = jwf.compute_runtime(folded, total)
    snap = snap.replace(quotas=folded.replace(runtime=rt))
    assign = []
    for cols in (dict(zip(c.keys(), v)) for c in [jsyn.stack_pod_chunks(
            pods, FS_CHUNK)] for v in zip(*c.values())):
        res = jcore.schedule_batch(snap, pods.replace(**cols), JCfg.make(),
                                   **configs.FAIR_SHARE_KW)
        snap = res.snapshot
        assign.append(np.asarray(res.assignment))
    want = np.concatenate(assign)
    line, run = configs.run_config_4_fair_share(
        FS_PODS, FS_NODES, FS_CHUNK, device="cpu", count_turned_away=True)
    np.testing.assert_array_equal(run.assignment.numpy(), want)
    assert_bits_equal(tree(run.snapshot), ref_tree(snap))
    assert_bits_equal(run.quotas.runtime.numpy(), np.asarray(rt), "runtime")
    assert line["metric"] == configs.FAIR_SHARE_METRIC
    assert line["placed"] == int((want >= 0).sum()) > 0
    assert line["num_quotas"] == 500
    assert sum(line["below_demand_cpu"]) > 0
    assert line["turned_away"] > 0
    assert line["placed_at_max"] >= line["placed"] - line["turned_away"]
    assert core.quota_ok(run.snapshot) and core.overcommit_ok(run.snapshot)
