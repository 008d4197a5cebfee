"""K1's and K3's plain versions against the JAX programs they replace:
the batch's static gates in factored form (cascade.static_gates and the
deviceshare prefilter), the round's fit/score/jitter/mask/top-k
(core.py:565-742) and the `.at[].add(mode="drop")` commits.

Tolerances: none. Gate masks, top-k indices and commit sums are
compared exactly; top-k values and sums bit for bit."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.api.extension import PriorityClass as JPC
from koordinator_tpu.api.extension import ResourceKind as RK
from koordinator_tpu.scheduler import cascade as jcascade
from koordinator_tpu.scheduler.plugins import deviceshare as jds
from koordinator_tpu.scheduler.plugins import loadaware as jla
from koordinator_tpu.scheduler.plugins import numaaware as jnuma
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch.kernels.numa_terms import numa_pair_terms
from koordinator_tpu_torch.kernels.scatter import (
    ordered_scatter_add,
    ordered_scatter_add_plain,
)
from koordinator_tpu_torch.kernels.score_topk import score_topk
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.scheduler.cascade import (
    expand_gates,
    static_gate_terms,
)
from koordinator_tpu_torch.scheduler.plugins import (
    deviceshare,
    loadaware,
    numaaware,
)

from torch_port_ref import to_port
from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)

FIT_DIMS = (0, 1, 2, 3)
SCORE_DIMS = (0, 1)
GATE_VARIANTS = {
    "default": {},
    "prod_thresholds": dict(prod_usage_thresholds={RK.CPU: 40.0,
                                                   RK.MEMORY: 55.0}),
    "filter_agg": dict(filter_agg_type="p95",
                       agg_usage_thresholds={RK.CPU: 50.0, RK.MEMORY: 70.0},
                       prod_usage_thresholds={RK.CPU: 30.0}),
}


@functools.partial(jax.jit, static_argnames=("k", "tie_break"))
def reference_select(nodes, pods, cfg, static_ok, row_ok, *, k, tie_break):
    """The round prologue of koordinator_tpu/scheduler/core.py
    schedule_batch, restated for one call (no slot columns)."""
    fd = list(FIT_DIMS)
    fit = jnp.all(pods.requests[:, None, fd] + nodes.requested[None][..., fd]
                  <= nodes.allocatable[None][..., fd] + EPS, axis=-1)
    feasible = fit & static_ok & row_ok[:, None]
    scores = jla.score_matrix(nodes, pods, cfg, SCORE_DIMS)
    if tie_break:
        p, n = scores.shape
        pi = jnp.arange(p, dtype=jnp.uint32)[:, None]
        ni = jnp.arange(n, dtype=jnp.uint32)[None, :]
        h = (pi * jnp.uint32(2654435761) + ni * jnp.uint32(40503)) & 1023
        scores = scores + h.astype(jnp.float32) * (0.49 / 1024.0)
    masked = jnp.where(feasible, scores, -1.0)
    return jax.lax.top_k(masked, k)


@functools.partial(jax.jit, static_argnames=("k", "tie_break"))
def reference_select_numa(nodes, pods, cfg, static_ok, row_ok, numa_scores,
                          *, k, tie_break):
    """`reference_select` with the NUMA zone score added to the LoadAware
    score before the jitter, as core.py:693-696 adds it."""
    fd = list(FIT_DIMS)
    fit = jnp.all(pods.requests[:, None, fd] + nodes.requested[None][..., fd]
                  <= nodes.allocatable[None][..., fd] + EPS, axis=-1)
    feasible = fit & static_ok & row_ok[:, None]
    scores = jla.score_matrix(nodes, pods, cfg, SCORE_DIMS) + numa_scores
    if tie_break:
        p, n = scores.shape
        pi = jnp.arange(p, dtype=jnp.uint32)[:, None]
        ni = jnp.arange(n, dtype=jnp.uint32)[None, :]
        h = (pi * jnp.uint32(2654435761) + ni * jnp.uint32(40503)) & 1023
        scores = scores + h.astype(jnp.float32) * (0.49 / 1024.0)
    masked = jnp.where(feasible, scores, -1.0)
    return jax.lax.top_k(masked, k)


@jax.jit
def reference_gates(nodes, pods, devices, cfg):
    """The batch's static mask as the reference's schedule_batch forms
    it: cascade.static_gates, then the deviceshare prefilter."""
    return (jcascade.static_gates(nodes, pods, cfg)[0]
            & jds.prefilter(devices, pods))


def _case(seed, p, n, dup_nodes):
    """Nodes partly filled; with dup_nodes, groups of identical node
    columns so that many pairs tie exactly."""
    rng = np.random.default_rng(seed)
    snap = jsyn.synthetic_cluster(n, seed=seed)
    nodes = snap.nodes
    if dup_nodes:
        src = np.arange(n) // 4 * 4
        nodes = nodes.replace(**{
            f: np.asarray(getattr(nodes, f))[src]
            for f in ("allocatable", "usage", "prod_usage", "agg_usage")})
    alloc = np.asarray(nodes.allocatable)
    requested = (np.floor(rng.uniform(0, 0.97, alloc.shape) * alloc / 500)
                 * 500).astype(np.float32)
    nodes = nodes.replace(requested=requested)
    pods = jsyn.synthetic_pods(p, seed=seed + 7)
    static_ok = rng.uniform(size=(p, n)) < 0.85
    row_ok = rng.uniform(size=p) < 0.8
    return nodes, pods, snap.devices, static_ok, row_ok


def _gated_case(seed, p, n):
    """Every factored gate in play: selectors (-1, and one that matches
    4 label groups of 64, so some pods have fewer feasible nodes than
    k), DaemonSet pods, stale metrics, every priority class, usage near
    the thresholds, unschedulable nodes, and pods that ask for GPU or
    aux resources on a snapshot without instances (all of their pairs
    fail)."""
    rng = np.random.default_rng(seed)
    snap = jsyn.synthetic_cluster(n, seed=seed, usage_cpu_frac=(0.2, 0.95))
    nodes = snap.nodes
    usage = np.asarray(nodes.usage)
    alloc = np.asarray(nodes.allocatable)
    nodes = nodes.replace(
        requested=(np.floor(rng.uniform(0, 0.9, alloc.shape) * alloc / 500)
                   * 500).astype(np.float32),
        prod_usage=(usage * rng.uniform(0.2, 1.0, (n, 1))).astype(np.float32),
        metric_fresh=rng.uniform(size=n) < 0.75,
        has_agg=rng.uniform(size=n) < 0.7,
        schedulable=rng.uniform(size=n) < 0.85,
        label_group=rng.integers(0, 64, n).astype(np.int32))
    pods = jsyn.synthetic_pods(p, seed=seed + 3)
    req = np.array(pods.requests)
    for kind, value, frac in ((RK.GPU_CORE, 50.0, 0.08),
                              (RK.GPU_MEMORY, 4096.0, 0.06),
                              (RK.RDMA, 1.0, 0.06), (RK.FPGA, 1.0, 0.06)):
        req[rng.uniform(size=p) < frac, int(kind)] = value
    match = rng.uniform(size=(8, 64)) < 0.5
    match[7] = False
    match[7, 5:9] = True        # selector 7 matches 4 label groups of 64
    pods = pods.replace(
        requests=req,
        gpu_ratio=np.where(rng.uniform(size=p) < 0.06, 50.0,
                           0.0).astype(np.float32),
        selector_id=rng.integers(-1, 8, p).astype(np.int32),
        selector_match=match,
        daemonset=rng.uniform(size=p) < 0.15,
        priority_class=rng.choice(
            [int(c) for c in JPC], size=p).astype(np.int8))
    return nodes, pods, snap.devices


def _port_cfg(variant):
    return (jla.LoadAwareConfig.make(**GATE_VARIANTS[variant]),
            loadaware.LoadAwareConfig.make(**GATE_VARIANTS[variant],
                                           device="cpu"))


@pytest.mark.parametrize("variant", sorted(GATE_VARIANTS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gate_terms_expand_to_reference_mask(seed, variant):
    """expand_gates(static_gate_terms(...)) equals the reference's
    static_gates(...)[0] & prefilter(...), exactly."""
    nodes, pods, devices = _gated_case(seed, 64, 80)
    jcfg, cfg = _port_cfg(variant)
    want = np.asarray(reference_gates(nodes, pods, devices, jcfg))
    gates = static_gate_terms(to_port("NodeState", nodes),
                              to_port("PodBatch", pods), cfg,
                              to_port("DeviceState", devices))
    got = expand_gates(gates).numpy()
    np.testing.assert_array_equal(got, want)
    # each term shows: some pods fail the device term, some nodes are
    # unschedulable or stale, some pods match one label group
    dev_ok = gates.device_ok.numpy()
    assert (~dev_ok).any() and dev_ok.any()
    assert (~want[dev_ok]).any() and want.any()
    sel = gates.selector_id.numpy()
    assert (sel == -1).any() and (sel == 7).any()
    if variant != "default":
        assert gates.prod_gate.numpy().any()
        assert (gates.prod_node_ok.numpy() != gates.node_ok.numpy()).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_gate_terms_index_the_table_as_reference(seed):
    """Selector ids at or above the selector table's rows and label
    groups below 0 or at or above its columns index the table as the
    reference does (a negative index counts from the end, one out of
    range is clamped): expand_gates equals static_gates & prefilter,
    exactly."""
    nodes, pods, devices = _gated_case(seed, 64, 80)
    rng = np.random.default_rng(seed + 100)
    s, labels = np.asarray(pods.selector_match).shape
    nodes = nodes.replace(label_group=rng.integers(
        -labels - 8, labels + 8, 80).astype(np.int32))
    pods = pods.replace(selector_id=rng.integers(-3, s + 3, 64).astype(
        np.int32))
    jcfg, cfg = _port_cfg("default")
    want = np.asarray(reference_gates(nodes, pods, devices, jcfg))
    gates = static_gate_terms(to_port("NodeState", nodes),
                              to_port("PodBatch", pods), cfg,
                              to_port("DeviceState", devices))
    np.testing.assert_array_equal(expand_gates(gates).numpy(), want)
    lab = gates.label_group.numpy()
    sel = gates.selector_id.numpy()
    assert (lab < -labels).any() and ((lab < 0) & (lab >= -labels)).any()
    assert (lab >= labels).any() and (sel >= s).any()


def test_gate_terms_without_devices_and_with_taints():
    """devices=None leaves the device prefilter out; a batch with taints
    factors with its forbid table (the expanded mask equals the
    reference's static gates); on a snapshot with GPU instances and no
    aux pool the factored device term is the prefilter's aux part (a pod
    asking for RDMA or FPGA passes nowhere; K6 gives the GPU part pair by
    pair), with aux pools too it passes every pod (K6 gives both parts),
    and with aux pools alone it fails the GPU pods."""
    nodes, pods, devices = _gated_case(4, 32, 24)
    _, cfg = _port_cfg("default")
    tn, tp = to_port("NodeState", nodes), to_port("PodBatch", pods)
    gates = static_gate_terms(tn, tp, cfg, None)
    assert gates.device_ok.all()
    jcfg = jla.LoadAwareConfig.make()
    want = np.asarray(jax.jit(
        lambda n, p, c: jcascade.static_gates(n, p, c)[0])(nodes, pods, jcfg))
    np.testing.assert_array_equal(expand_gates(gates).numpy(), want)
    tainted = pods.replace(has_taints=True)
    want = np.asarray(jax.jit(lambda n, p, c: jcascade.static_gates(
        n, p, c)[0])(nodes, tainted, jcfg))
    np.testing.assert_array_equal(expand_gates(static_gate_terms(
        tn, tp.replace(has_taints=True), cfg, None)).numpy(), want)
    gpu = to_port("DeviceState", jsyn.synthetic_cluster(
        24, gpu_node_frac=1.0, gpus_per_node=2).devices)
    aux = np.asarray(pods.requests)[:, [int(RK.RDMA), int(RK.FPGA)]]
    np.testing.assert_array_equal(
        static_gate_terms(tn, tp, cfg, gpu).device_ok.numpy(),
        ~(aux > 0).any(axis=1))
    # with aux pools the prefilter's aux part is pairwise too (K6), so
    # every pod passes the per-pod term; without GPU instances a GPU pod
    # passes nowhere (ROADMAP B8, tests/test_torch_aux.py)
    with_aux = gpu.replace(aux_free=torch.ones((24, 2, 1)),
                           aux_valid=torch.ones((24, 2, 1), dtype=torch.bool))
    assert static_gate_terms(tn, tp, cfg, with_aux).device_ok.all()
    no_gpu = with_aux.replace(gpu_free=with_aux.gpu_free[:, :0],
                              gpu_valid=with_aux.gpu_valid[:, :0])
    gpu_pod = deviceshare.has_gpu_request(tp.requests, tp.gpu_ratio)
    assert torch.equal(static_gate_terms(tn, tp, cfg, no_gpu).device_ok,
                       ~gpu_pod)


def _port_select(tn, tp, cfg, gates, pair_ok, row_ok, k, tie_break,
                 pair_score=None, pair_score2=None):
    node_term, prod_term, alloc_s, weights = loadaware.score_terms(
        tn, cfg, SCORE_DIMS)
    return score_topk(
        gates, pair_ok, torch.from_numpy(row_ok),
        tp.requests[:, list(FIT_DIMS)].contiguous(),
        tn.requested[:, list(FIT_DIMS)].contiguous(),
        tn.allocatable[:, list(FIT_DIMS)].contiguous(),
        tp.estimated[:, list(SCORE_DIMS)].contiguous(),
        loadaware.prod_scored(tp, cfg), node_term, prod_term, alloc_s,
        weights, k, tie_break, EPS, fma_sum=True, pair_score=pair_score,
        pair_score2=pair_score2)


@pytest.mark.parametrize("strategy", ["most", "least"])
@pytest.mark.parametrize("tie_break", [True, False])
@pytest.mark.parametrize("k", [8, 32])
def test_score_topk_pair_score_equals_reference(k, tie_break, strategy):
    """K1's plain version with the NUMA zone score as its addend (and the
    NUMA gates as its pair mask) against the reference's
    top_k(where(feasible, la + numa + jitter, -1)): two-zone nodes,
    40 % of the pods NUMA-bound."""
    nodes, pods, devices, static_ok, row_ok = _case(5, 96, 64, False)
    nodes = jsyn.with_two_numa_zones(jsyn.synthetic_cluster(64, seed=5)
                                     ).nodes.replace(
        requested=nodes.requested)
    rng = np.random.default_rng(11)
    free = np.asarray(nodes.numa_cap) * rng.uniform(0.05, 1.0, (64, 2, 1))
    nodes = nodes.replace(numa_free=jnp.asarray(
        (np.floor(free / 500) * 500).astype(np.float32)))
    pods = pods.replace(numa_single=jnp.asarray(rng.uniform(size=96) < 0.4))
    numa_ok = np.asarray(jnuma.zone_prefilter(nodes, pods))
    numa_scores = jnuma.numa_score_matrix(nodes, pods, strategy)
    jcfg = jla.LoadAwareConfig.make()
    want_static = np.asarray(reference_gates(nodes, pods, devices, jcfg))
    want_val, want_idx = reference_select_numa(
        nodes, pods, jcfg, jnp.asarray(want_static & numa_ok),
        jnp.asarray(row_ok), numa_scores, k=k, tie_break=tie_break)
    want_val, want_idx = np.asarray(want_val), np.asarray(want_idx)

    cfg = loadaware.LoadAwareConfig.make(device="cpu")
    tn, tp = to_port("NodeState", nodes), to_port("PodBatch", pods)
    gates = static_gate_terms(tn, tp, cfg, to_port("DeviceState", devices))
    pair_ok, pair_score = numa_pair_terms(
        numaaware.zone_demand(tp), tp.numa_single, tn.numa_cap,
        tn.numa_free, tn.numa_valid, tn.numa_policy, strategy)
    val, idx = _port_select(tn, tp, cfg, gates, pair_ok, row_ok, k,
                            tie_break, pair_score)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert val.numpy().tobytes() == want_val.tobytes()
    # the addend moves values above the LoadAware range, and some bound
    # pods are gated off nodes whose zones they do not fit
    assert (want_val > 100.0).any() and not numa_ok.all()


@functools.partial(jax.jit, static_argnames=("k", "tie_break"))
def reference_select_two(nodes, pods, cfg, static_ok, row_ok, numa_scores,
                         dev_scores, *, k, tie_break):
    """`reference_select` with the NUMA zone score and then the
    DeviceShare pool score added to the LoadAware score, as
    core.py:693-699 adds them: (la + numa) + dev."""
    fd = list(FIT_DIMS)
    fit = jnp.all(pods.requests[:, None, fd] + nodes.requested[None][..., fd]
                  <= nodes.allocatable[None][..., fd] + EPS, axis=-1)
    feasible = fit & static_ok & row_ok[:, None]
    scores = jla.score_matrix(nodes, pods, cfg, SCORE_DIMS) + numa_scores
    scores = scores + dev_scores
    if tie_break:
        p, n = scores.shape
        pi = jnp.arange(p, dtype=jnp.uint32)[:, None]
        ni = jnp.arange(n, dtype=jnp.uint32)[None, :]
        h = (pi * jnp.uint32(2654435761) + ni * jnp.uint32(40503)) & 1023
        scores = scores + h.astype(jnp.float32) * (0.49 / 1024.0)
    masked = jnp.where(feasible, scores, -1.0)
    return jax.lax.top_k(masked, k)


@pytest.mark.parametrize("strategy", ["least", "most"])
@pytest.mark.parametrize("tie_break", [True, False])
@pytest.mark.parametrize("k", [8, 32])
def test_score_topk_two_addends_equal_reference(k, tie_break, strategy):
    """K1's plain version with two addends, K4's zone score then K6's
    pool score (and both gates in its pair mask), against the
    reference's top_k(where(feasible, (la + numa) + dev + jitter, -1)):
    two-zone nodes, half of them GPU nodes, 40 % of the pods
    NUMA-bound and 50 % asking for GPUs, so some pods carry both."""
    from koordinator_tpu_torch.kernels.device_terms import device_pair_terms

    nodes, pods, _, _, row_ok = _case(6, 96, 64, False)
    snap = jsyn.with_two_numa_zones(jsyn.synthetic_cluster(
        64, seed=6, gpu_node_frac=0.5, gpus_per_node=4))
    rng = np.random.default_rng(12)
    devices = snap.devices
    free = np.floor(np.asarray(devices.gpu_free)
                    * rng.uniform(0, 1, (64, 4, 1)))
    devices = devices.replace(gpu_free=jnp.asarray(free.astype(np.float32)))
    nodes = snap.nodes.replace(requested=nodes.requested)
    zfree = np.asarray(nodes.numa_cap) * rng.uniform(0.05, 1.0, (64, 2, 1))
    nodes = nodes.replace(numa_free=jnp.asarray(
        (np.floor(zfree / 500) * 500).astype(np.float32)))
    gpods = jsyn.synthetic_pods(96, seed=13, gpu_pod_frac=0.5)
    pods = pods.replace(requests=gpods.requests, gpu_ratio=gpods.gpu_ratio,
                        numa_single=jnp.asarray(rng.uniform(size=96) < 0.4))
    numa_ok = np.asarray(jnuma.zone_prefilter(nodes, pods))
    numa_scores = jnuma.numa_score_matrix(nodes, pods, "most")
    dev_scores = jds.score_matrix(devices, pods, strategy)
    jcfg = jla.LoadAwareConfig.make()
    want_static = np.asarray(reference_gates(nodes, pods, devices, jcfg))
    want_val, want_idx = reference_select_two(
        nodes, pods, jcfg, jnp.asarray(want_static & numa_ok),
        jnp.asarray(row_ok), numa_scores, dev_scores, k=k,
        tie_break=tie_break)
    want_val, want_idx = np.asarray(want_val), np.asarray(want_idx)

    cfg = loadaware.LoadAwareConfig.make(device="cpu")
    tn, tp = to_port("NodeState", nodes), to_port("PodBatch", pods)
    tdev = to_port("DeviceState", devices)
    gates = static_gate_terms(tn, tp, cfg, tdev)
    pair_ok, numa_score = numa_pair_terms(
        numaaware.zone_demand(tp), tp.numa_single, tn.numa_cap,
        tn.numa_free, tn.numa_valid, tn.numa_policy, "most")
    pair_ok, dev_score = device_pair_terms(
        deviceshare.gpu_request(tp.requests, tp.gpu_ratio), tdev, strategy,
        pair_ok)
    val, idx = _port_select(tn, tp, cfg, gates, pair_ok, row_ok, k,
                            tie_break, numa_score, dev_score)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert val.numpy().tobytes() == want_val.tobytes()
    both = (numa_score > 0) & (dev_score > 0) & pair_ok
    assert bool(both.any()) and (want_val > 100.0).any()


@pytest.mark.parametrize("tie_break", [True, False])
@pytest.mark.parametrize("k,dup", [(8, False), (8, True), (32, True)])
def test_score_topk_plain_equals_reference(tie_break, k, dup):
    """A random static mask, passed as K1's pair mask beside the
    (all-pass) factored gates of the synthetic batch."""
    nodes, pods, devices, static_ok, row_ok = _case(3, 96, 64, dup)
    jcfg = jla.LoadAwareConfig.make()
    want_static = np.asarray(reference_gates(nodes, pods, devices, jcfg))
    want_val, want_idx = reference_select(
        nodes, pods, jcfg, jnp.asarray(static_ok & want_static),
        jnp.asarray(row_ok), k=k, tie_break=tie_break)
    want_val, want_idx = np.asarray(want_val), np.asarray(want_idx)

    cfg = loadaware.LoadAwareConfig.make(device="cpu")
    tn, tp = to_port("NodeState", nodes), to_port("PodBatch", pods)
    gates = static_gate_terms(tn, tp, cfg, to_port("DeviceState", devices))
    val, idx = _port_select(tn, tp, cfg, gates, torch.from_numpy(static_ok),
                            row_ok, k, tie_break)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert val.numpy().tobytes() == want_val.tobytes()
    # the case has ties beyond the masked -1 entries, infeasible rows,
    # and rows with fewer than k feasible nodes
    assert (want_val == -1.0).all(axis=1).any()
    if not tie_break:
        top = want_val[:, :2]
        assert ((top[:, 0] == top[:, 1]) & (top[:, 0] >= 0)).any()


@pytest.mark.parametrize("pair", [False, True], ids=["terms", "terms+pair"])
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("shape", ["ragged", "ties"])
def test_score_topk_gate_terms_equal_reference(shape, k, pair):
    """K1 on the factored gates of `_gated_case`, with and without a
    random pair mask, against the reference on the expanded mask.
    "ragged": 300 nodes (no multiple of the kernel's tiles), jitter on;
    "ties": nodes in groups of 4 identical columns, jitter off, so equal
    values are ordered by index alone."""
    p, n = 80, 300
    nodes, pods, devices = _gated_case(10 + k, p, n)
    if shape == "ties":
        src = np.arange(n) // 4 * 4
        nodes = nodes.replace(**{
            f: np.asarray(getattr(nodes, f))[src]
            for f in ("allocatable", "requested", "usage", "prod_usage",
                      "agg_usage", "metric_fresh", "schedulable",
                      "has_agg")})
    tie_break = shape == "ragged"
    rng = np.random.default_rng(k)
    row_ok = rng.uniform(size=p) < 0.85
    pair_ok = rng.uniform(size=(p, n)) < 0.7 if pair else np.ones((p, n), bool)
    jcfg, cfg = _port_cfg("prod_thresholds")
    want_static = np.asarray(reference_gates(nodes, pods, devices, jcfg))
    want_val, want_idx = reference_select(
        nodes, pods, jcfg, jnp.asarray(want_static & pair_ok),
        jnp.asarray(row_ok), k=k, tie_break=tie_break)
    want_val, want_idx = np.asarray(want_val), np.asarray(want_idx)

    tn, tp = to_port("NodeState", nodes), to_port("PodBatch", pods)
    gates = static_gate_terms(tn, tp, cfg, to_port("DeviceState", devices))
    val, idx = _port_select(tn, tp, cfg, gates,
                            torch.from_numpy(pair_ok) if pair else None,
                            row_ok, k, tie_break)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert val.numpy().tobytes() == want_val.tobytes()
    # all-infeasible active rows (device requests), rows with fewer than
    # k feasible nodes, and (jitter off) ties among feasible values
    n_feasible = (want_val >= 0).sum(axis=1)
    assert ((n_feasible == 0) & row_ok).any()
    if k > 1:
        assert ((n_feasible > 0) & (n_feasible < k)).any()
    if not tie_break and k > 1:
        top = want_val[:, :2]
        assert ((top[:, 0] == top[:, 1]) & (top[:, 0] >= 0)).any()


def test_ordered_scatter_add_plain_is_bit_equal_to_reference():
    """Non-integer rows, repeated targets, dropped indices: the same
    sums, bit for bit, as the reference's CPU scatter."""
    rng = np.random.default_rng(11)
    s, c, p = 50, 11, 4000
    target = (rng.uniform(0, 1e4, (s, c)) + 0.1).astype(np.float32)
    rows = (rng.uniform(0, 300, (p, c)) * np.pi).astype(np.float32)
    idx = rng.integers(0, s + 30, p).astype(np.int32)   # >= s is dropped
    want = np.asarray(jnp.asarray(target).at[idx].add(rows, mode="drop"))
    got = ordered_scatter_add(torch.from_numpy(target), torch.from_numpy(idx),
                              torch.from_numpy(rows)).numpy()
    assert got.tobytes() == want.tobytes()
    # a sequential in-order float32 loop gives the same bits
    seq = target.copy()
    for j in range(p):
        if idx[j] < s:
            seq[idx[j]] = seq[idx[j]] + rows[j]
    assert seq.tobytes() == want.tobytes()
    # and the order matters: summing the rows first would not
    pre = target + np.stack([rows[idx == t].sum(0, dtype=np.float32)
                             for t in range(s)])
    assert pre.tobytes() != want.tobytes()


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_ordered_scatter_add_levels_equal_sequential_reference(levels):
    """idx [L, P]: bit-equal to L reference scatters in a row, with
    non-integer rows, one hot target row (every pod on it at level 0,
    as the quota root takes them), repeats, drops and negative indices
    (numpy's wrap)."""
    rng = np.random.default_rng(20 + levels)
    s, c, p = 40, 11, 3000
    target = (rng.uniform(0, 1e4, (s, c)) + 0.1).astype(np.float32)
    rows = (rng.uniform(0, 300, (p, c)) * np.e).astype(np.float32)
    idx = rng.integers(-3, s + 10, (levels, p)).astype(np.int32)
    idx[0] = np.where(rng.uniform(size=p) < 0.9, 0, idx[0])
    want = jnp.asarray(target)
    for level in idx:
        want = want.at[level].add(rows, mode="drop")
    want = np.asarray(want)
    got = ordered_scatter_add(torch.from_numpy(target),
                              torch.from_numpy(idx),
                              torch.from_numpy(rows)).numpy()
    assert got.tobytes() == want.tobytes()
    if levels > 1:   # the levels' order matters for these rows
        rev = ordered_scatter_add(torch.from_numpy(target),
                                  torch.from_numpy(idx[::-1].copy()),
                                  torch.from_numpy(rows)).numpy()
        assert rev.tobytes() != want.tobytes()


def test_ordered_scatter_add_wraps_negative_indices_as_reference():
    """[-S, 0) names row S + idx, as the reference's `.at[]` does;
    indices below -S and from S up are dropped."""
    rng = np.random.default_rng(30)
    s, c, p = 7, 3, 200
    target = (rng.uniform(0, 1e3, (s, c)) + 0.1).astype(np.float32)
    rows = (rng.uniform(0, 30, (p, c)) * np.pi).astype(np.float32)
    idx = rng.integers(-s - 3, s + 3, p).astype(np.int32)
    assert (idx < -s).any() and ((idx >= -s) & (idx < 0)).any()
    want = np.asarray(jnp.asarray(target).at[idx].add(rows, mode="drop"))
    got = ordered_scatter_add(torch.from_numpy(target), torch.from_numpy(idx),
                              torch.from_numpy(rows)).numpy()
    assert got.tobytes() == want.tobytes()


def test_wrappers_refuse_other_devices():
    t = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ordered_scatter_add(t, torch.zeros(3, dtype=torch.int32,
                                           device="meta"),
                            torch.zeros((3, 2), device="meta"))
    assert ordered_scatter_add_plain(
        torch.zeros((2, 1)), torch.tensor([1, 5, 1], dtype=torch.int32),
        torch.ones((3, 1))).flatten().tolist() == [0.0, 2.0]
