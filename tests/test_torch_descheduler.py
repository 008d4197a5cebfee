"""The port's LowNodeLoad plan (koordinator_tpu_torch/descheduler, kernels
K10-K13 through their plain versions) against the JAX package's
(koordinator_tpu/descheduler/lownodeload_device.py, its jitted programs
on XLA:CPU) on the same inputs, and against the port's host loop.
Results must be equal: `take` and `order` arrays, and the evicted pods'
names in order. Tolerances: none; XLA:CPU's orders of f32 additions
(the blocked cumsum, the tree column sum, the fused multiply-adds) are
held bit for bit."""

from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.api import types as japi
from koordinator_tpu.api.extension import ResourceKind as JRK
from koordinator_tpu import descheduler as jd
from koordinator_tpu.descheduler import lownodeload_device as jdev
from koordinator_tpu_torch import configs
from koordinator_tpu_torch import descheduler as td
from koordinator_tpu_torch.api.extension import ResourceKind as RK
from koordinator_tpu_torch.bridge import api_from_reference
from koordinator_tpu_torch.descheduler import lownodeload_device as tdev
from koordinator_tpu_torch.kernels import lownodeload as klnl
from koordinator_tpu_torch.testing import lnl_cases
from koordinator_tpu_torch.utils.synthetic import config_5_cluster

from test_descheduler_device import NOW, random_cluster

from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)

R = 11
DEVIATION_THRESHOLDS = dict(low_thresholds={JRK.CPU: 10.0, JRK.MEMORY: 10.0},
                            high_thresholds={JRK.CPU: 10.0,
                                             JRK.MEMORY: 10.0})


def _port_args(kw):
    """The port's LowNodeLoadArgs from the reference's keyword args."""
    out = dict(kw)
    for k in ("low_thresholds", "high_thresholds", "resource_weights"):
        if k in out:
            out[k] = {RK(int(d)): v for d, v in out[k].items()}
    return td.LowNodeLoadArgs(**out)


def names(pods):
    return [p.meta.namespaced_name for p in pods]


def reference_columns(nodes, metrics, by_node, kw):
    """The plan's inputs as the reference's balance_once builds them
    (node columns, anomaly gate, columnarize), as numpy."""
    plugin = jd.DeviceLowNodeLoad(jd.LowNodeLoadArgs(**kw))
    usage, capacity, fresh = plugin.node_columns(nodes, metrics, NOW)
    _, _, _, high_mask, _ = plugin.classify_columns(usage, capacity, fresh)
    source = plugin._gate_anomalies([n.meta.name for n in nodes], high_mask)
    cols = jdev.columnarize(nodes, metrics, by_node, plugin.args, usage,
                            capacity, fresh)
    cols.pop("pods")
    return dict(cols, source_mask=source)


# shape buckets of `both_plans(pad=True)`: the reference compiles once a
# shape, so padded inputs share its compiles across cases
NODE_BUCKET, POD_BUCKET = 256, 1024


def _pad_rows(x, rows, value):
    extra = -x.shape[0] % rows
    fill = np.full((extra,) + x.shape[1:], value, x.dtype)
    return np.concatenate([x, fill])


def pad_columns(cols, capped=None):
    """Inputs padded as the reference's shape contract pads them: nodes
    with no capacity, not fresh, not a source; pods on node -1, not
    eligible, of no usage (they rank last and are never taken)."""
    cols = dict(cols)
    for k, v in (("usage", 0.0), ("capacity", 0.0), ("fresh", False),
                 ("source_mask", False)):
        cols[k] = _pad_rows(cols[k], NODE_BUCKET, v)
    for k, v in (("pod_node", -1), ("pod_usage_r", 0.0), ("pod_req", 0.0),
                 ("pod_eligible", False)):
        cols[k] = _pad_rows(cols[k], POD_BUCKET, v)
    if capped is not None:
        capped = dict(capped,
                      pod_ns=_pad_rows(capped["pod_ns"], POD_BUCKET, 0),
                      per_node0=_pad_rows(capped["per_node0"], NODE_BUCKET,
                                          0))
    return cols, capped


def both_plans(cols, capped=None, use_deviation=False, node_fit=True,
               pad=False):
    """(take, order) of the reference's and the port's plan on `cols`:
    plan_kernel, or plan_kernel_capped with `capped` = dict(pod_ns,
    ns_counts0, per_node0, max_evictions, max_per_node, max_per_ns).
    `pad` runs both on the inputs padded to the shape buckets and cuts
    the results back to the real pods (the padding pods come last)."""
    p = cols["pod_node"].shape[0]
    if pad:
        cols, capped = pad_columns(cols, capped)
    ref, port = _both_plans(cols, capped, use_deviation, node_fit)
    if pad:
        for take, order in (ref, port):
            assert (order[p:] >= p).all()
        ref, port = ((t[:p], o[:p]) for t, o in (ref, port))
    return ref, port


def _both_plans(cols, capped, use_deviation, node_fit):
    cols = dict(cols)
    fit_dims = cols.pop("fit_dims")
    static = dict(use_deviation=use_deviation, node_fit=node_fit,
                  fit_dims=fit_dims)
    tcols = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in cols.items()}
    if capped is None:
        jt, jo = jdev.plan_kernel(**cols, max_evictions=np.int32(1 << 30),
                                  **static)
        tt, to = tdev.plan_kernel(**tcols, max_evictions=1 << 30, **static)
    else:
        arrays = {k: capped[k] for k in ("pod_ns", "ns_counts0",
                                         "per_node0")}
        caps = {k: capped[k] for k in ("max_evictions", "max_per_node",
                                       "max_per_ns")}
        jt, jo = jdev.plan_kernel_capped(
            **cols, **arrays, **{k: np.int32(v) for k, v in caps.items()},
            **static)
        tt, to = tdev.plan_kernel_capped(
            **tcols, **{k: torch.from_numpy(v) for k, v in arrays.items()},
            **caps, **static)
    return (np.asarray(jt), np.asarray(jo)), (tt.numpy(), to.numpy())


def assert_same_plan(ref, port):
    assert np.array_equal(ref[1], port[1]), "order differs"
    assert np.array_equal(ref[0], port[0]), "take differs"


# --- the plans against the reference's --------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("deviation,node_fit", [
    (False, True), (True, True), (False, False)])
def test_plan_kernel_equals_reference(seed, deviation, node_fit):
    nodes, metrics, by_node = random_cluster(seed, n_nodes=40 + 40 * seed)
    kw = dict(consecutive_abnormalities=1, node_fit=node_fit,
              use_deviation_thresholds=deviation)
    if deviation:
        kw.update(DEVIATION_THRESHOLDS)
    cols = reference_columns(nodes, metrics, by_node, kw)
    ref, port = both_plans(cols, use_deviation=deviation, node_fit=node_fit,
                           pad=True)
    assert_same_plan(ref, port)
    assert ref[0].any(), "a plan that takes nothing shows nothing"


@pytest.mark.parametrize("caps", [
    dict(max_per_node=1, max_per_ns=2, max_evictions=5),
    dict(max_per_node=2, max_per_ns=1, max_evictions=1 << 30),
    dict(max_per_node=1 << 30, max_per_ns=3, max_evictions=7),
    dict(max_per_node=1, max_per_ns=1 << 30, max_evictions=1 << 30),
], ids=["node1-ns2-cycle5", "node2-ns1", "ns3-cycle7", "node1"])
@pytest.mark.parametrize("seeded", [False, True], ids=["fresh", "seeded"])
def test_plan_kernel_capped_equals_reference(caps, seeded):
    """The capped walk, with the limiter's counts so far seeded into
    per_node0 and ns_counts0 (padded to a power of two)."""
    nodes, metrics, by_node = random_cluster(9, n_nodes=120)
    cols = reference_columns(nodes, metrics, by_node,
                             dict(consecutive_abnormalities=1))
    rng = np.random.default_rng(5)
    p, n = cols["pod_node"].shape[0], cols["usage"].shape[0]
    capped = dict(caps, pod_ns=rng.integers(0, 3, p).astype(np.int32),
                  ns_counts0=np.zeros(8, np.int32),
                  per_node0=np.zeros(n, np.int32))
    if seeded:
        capped["ns_counts0"][:3] = [1, 0, 2]
        capped["per_node0"] = rng.integers(0, 2, n).astype(np.int32)
    ref, port = both_plans(cols, capped=capped, pad=True)
    assert_same_plan(ref, port)
    assert ref[0].any()


# --- balance_once: the reference's, the port's device plan, the host loop ---

class PickyEvictor:
    """Refuses every pod whose name ends in p0 (outside the limiter
    model); records the rest."""

    def __init__(self, base):
        self.base = base
        self.limiter = base.limiter
        self.evictions = base.evictions

    def evict(self, pod, reason):
        if pod.meta.name.endswith("p0"):
            return False
        return self.base.evict(pod, reason)


def _expire_one_pod_metric(metrics, by_node):
    """Move one hot pod's usage report into an expired metric of another
    node (pod usage is read from every metric, expired or not)."""
    donor = next(n for n in metrics if by_node[n])
    pod = by_node[donor][0]
    holder = next(n for n in metrics if n != donor)
    m = metrics[holder]
    metrics[holder] = japi.NodeMetric(
        node_name=m.node_name, update_time=NOW - 10_000,
        node_usage=m.node_usage,
        pods_metric=[japi.PodMetricInfo(
            namespace=pod.meta.namespace, name=pod.meta.name,
            usage={JRK.CPU: 9999.0, JRK.MEMORY: 9999.0})])


SCENARIOS = {
    "dry_run": dict(args=dict(dry_run=True), caps=None),
    "per_cycle_cap": dict(args={}, caps=dict(max_per_cycle=3)),
    "dry_run_ignores_limiter": dict(args=dict(dry_run=True),
                                    caps=dict(max_per_cycle=1)),
    "node_and_ns_caps": dict(args={}, caps=dict(
        max_per_node=2, max_per_namespace=2, max_per_cycle=5)),
    "mid_cycle_reuse": dict(args={}, caps=dict(
        max_per_node=1, max_per_namespace=2, max_per_cycle=6), calls=2),
    "picky_evictor": dict(args={}, caps=None, picky=True),
    "expired_metrics": dict(args=dict(dry_run=True), caps=None,
                            expire=True),
    "deviation": dict(args=dict(dry_run=True, use_deviation_thresholds=True,
                                **DEVIATION_THRESHOLDS), caps=None),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_balance_once_equals_reference_and_host(scenario):
    """DeviceLowNodeLoad.balance_once in the port (on the host, through
    the plain versions) against the reference's and against the port's
    host LowNodeLoad: the evicted pods, in order."""
    sc = SCENARIOS[scenario]
    nodes, metrics, by_node = random_cluster(
        {"dry_run": 0, "deviation": 2}.get(scenario, 7), n_nodes=60)
    if sc.get("expire"):
        _expire_one_pod_metric(metrics, by_node)
    kw = dict(consecutive_abnormalities=1, **sc["args"])
    tn, tm, tb = (api_from_reference(x) for x in (nodes, metrics, by_node))
    plans = {}
    for side in ("reference", "port", "host"):
        mod, objs = (jd, (nodes, metrics, by_node)) if side == "reference" \
            else (td, (tn, tm, tb))
        limiter = mod.EvictionLimiter(**(sc["caps"] or {}))
        evictor = mod.RecordingEvictor(limiter)
        if sc.get("picky"):
            evictor = PickyEvictor(evictor)
        args = (jd.LowNodeLoadArgs(**kw) if side == "reference"
                else _port_args(kw))
        if side == "reference":
            plugin = jd.DeviceLowNodeLoad(args, evictor)
        elif side == "port":
            plugin = td.DeviceLowNodeLoad(args, evictor, device="cpu")
        else:
            plugin = td.LowNodeLoad(args, evictor)
        got = []
        for _ in range(sc.get("calls", 1)):
            got.append(names(plugin.balance_once(*objs, NOW)))
        plans[side] = (got, names(e.pod for e in evictor.evictions))
    assert plans["port"] == plans["reference"]
    assert plans["port"][0][0], "the scenario must plan something"
    if sc.get("picky"):
        # the device plans do not re-plan a refusal the limiter model did
        # not predict (the reference's narrowing): the host loop goes on
        # to later pods, so only the accepted pods are compared with it
        assert plans["port"][0][0] == plans["port"][1]
        assert set(plans["port"][1]) <= set(plans["host"][1])
    else:
        assert plans["port"] == plans["host"]


def test_cycle_runner_drives_the_device_plan():
    """CycleRunner.run_once resets the limiter and drives
    LowNodeLoad.balance through its providers, in both packages."""
    nodes, metrics, by_node = random_cluster(3, n_nodes=50)
    tn, tm, tb = (api_from_reference(x) for x in (nodes, metrics, by_node))
    out = []
    for mod, objs, extra in ((jd, (nodes, metrics, by_node), {}),
                             (td, (tn, tm, tb), dict(device="cpu"))):
        ev = mod.RecordingEvictor(mod.EvictionLimiter(max_per_node=1))
        plugin = mod.DeviceLowNodeLoad(
            mod.LowNodeLoadArgs(consecutive_abnormalities=2), ev,
            get_metrics=lambda o=objs: o[1],
            get_pods_by_node=lambda o=objs: o[2], now_fn=lambda: NOW,
            **extra)
        runner = mod.CycleRunner(balance_plugins=[plugin],
                                 limiters=[ev.limiter])
        for _ in range(2):   # the second detection makes the sources
            runner.run_once(objs[0])
        out.append(names(e.pod for e in ev.evictions))
    assert out[0] == out[1] and out[0]


# --- XLA:CPU's orders of additions ------------------------------------------

@pytest.mark.parametrize("p", [1, 15, 16, 17, 255, 256, 257, 12_000,
                               20_000, 70_000])
def test_xla_cumsum_equals_jnp_cumsum(p):
    rng = np.random.default_rng(p)
    x = rng.uniform(0, 5000, (p, 2)).astype(np.float32)
    x[rng.uniform(size=p) < 0.3] = 0.0
    want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, 0))(x))
    got = klnl.xla_cumsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    if p >= 255:   # a sequential sum is not the reference's
        assert not np.array_equal(np.cumsum(x, 0, dtype=np.float32), want)


@pytest.mark.parametrize("n", [1, 32, 33, 100, 1025, 10_000, 20_000])
def test_xla_column_sum_equals_reference(n):
    rng = np.random.default_rng(n)
    x = rng.uniform(-100, 5000, (n, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: v.sum(0))(x))
    assert np.array_equal(klnl.xla_column_sum(torch.from_numpy(x)).numpy(),
                          want)


def test_fma_f32_rounds_once():
    """fma_f32 against exact rational arithmetic, near-cancelling sums
    included."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-1e4, 1e4, 4000).astype(np.float32)
    b = rng.uniform(0.001, 3, 4000).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * rng.choice([1.0, 1 + 1e-7], 4000)
         ).astype(np.float32)
    got = klnl.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    want = np.array([np.float32(float(Fraction(float(x)) * Fraction(float(y))
                                      + Fraction(float(z))))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got, want)


# --- the sort's edges --------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("use_deviation", "node_fit",
                                             "fit_dims"))
def _reference_prelude(*args, use_deviation, node_fit, fit_dims):
    _, active, order, budget0, high_abs = jdev._plan_prelude(
        *args, use_deviation, node_fit, fit_dims)
    return active, order, budget0, high_abs


@pytest.mark.parametrize("n", [64, 1000, 10_000])
@pytest.mark.parametrize("deviation", [False, True])
def test_prelude_equals_reference(n, deviation):
    """K11's and K10's plain versions against the reference's
    `_plan_prelude` on random columns: the budget (XLA's tree sum of
    fused terms) and high_abs bit for bit, the order and the active
    pods (with node_fit) equal."""
    rng = np.random.default_rng(n)
    cols = _raw_cols(n, 3 * n // 2, n, weights=(0.7, 1.3))
    cols["capacity"][:, 0] = rng.choice([64000.0, 96000.0, 12345.0], n)
    cols["usage"][:, :2] = (cols["capacity"][:, :2] * rng.uniform(
        0.05, 0.95, (n, 2))).astype(np.float32)
    cols["fresh"] = rng.uniform(size=n) < 0.9
    cols["pod_usage_r"][:, 0] += rng.uniform(0, 1, len(cols["pod_node"]))
    cols["pod_req"][:, :2] = cols["pod_usage_r"]
    if deviation:
        cols["low"] = np.array([10, 10], np.float32)
        cols["high"] = np.array([10, 5], np.float32)
    fit_dims = cols.pop("fit_dims")
    args = [cols[k] for k in (
        "usage", "capacity", "fresh", "source_mask", "pod_node",
        "pod_usage_r", "pod_req", "pod_eligible", "low", "high", "weights",
        "rdims_onehot")]
    active, order, budget0, high_abs = (np.asarray(x) for x in
                                        _reference_prelude(
        *args, use_deviation=deviation, node_fit=True, fit_dims=fit_dims))
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in cols.items()}
    eo = klnl.lnl_eviction_order_plain(
        t["usage"], t["capacity"], t["fresh"], t["source_mask"],
        t["pod_node"], t["pod_usage_r"], t["pod_eligible"], t["low"],
        t["high"], t["weights"], torch.tensor([0, 1], dtype=torch.int32),
        deviation)
    fits = klnl.lnl_node_fit_plain(t["pod_req"], t["pod_node"],
                                   t["capacity"], eo.low_mask, fit_dims)
    assert np.array_equal(eo.budget0.numpy(), budget0)
    assert np.array_equal(eo.high_abs.numpy(), high_abs)
    assert np.array_equal(eo.order.numpy(), order)
    assert np.array_equal((eo.active & fits).numpy(), active)
    assert active.any() and not active.all()


def test_sort_treats_signed_zeros_as_equal():
    keys = np.array([0.0, -0.0, 1.0, 0.0, -0.0], np.float32)
    want = np.asarray(jnp.argsort(jnp.asarray(keys), stable=True))
    got = torch.argsort(torch.from_numpy(keys), stable=True).numpy()
    assert np.array_equal(got, want)
    assert list(want) == [0, 1, 3, 4, 2]


def _assert_case_equals_reference(c):
    """K11's plain version (through its wrapper, on the host) against
    the reference's `_plan_prelude` on an `lnl_cases` case: the order,
    the active pods, the budget and high_abs equal bit for bit."""
    args = [c[k] for k in (
        "usage", "capacity", "fresh", "source_mask", "pod_node",
        "pod_usage_r", "pod_req", "pod_eligible", "low", "high", "weights",
        "rdims_onehot")]
    active, order, budget0, high_abs = (np.asarray(x) for x in
                                        _reference_prelude(
        *args, use_deviation=c["deviation"], node_fit=False,
        fit_dims=c["fit_dims"]))
    arrays, deviation = lnl_cases.k11_args(c)
    eo = klnl.lnl_eviction_order(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
        deviation)
    assert np.array_equal(eo.order.numpy(), order)
    assert np.array_equal(eo.active.numpy(), active)
    assert np.array_equal(eo.budget0.numpy(), budget0)
    assert np.array_equal(eo.high_abs.numpy(), high_abs)


@pytest.mark.parametrize("case", sorted(lnl_cases.CASES))
def test_lnl_cases_equal_reference(case):
    """Each of `testing/lnl_cases`'s edge cases at their small size."""
    _assert_case_equals_reference(lnl_cases.CASES[case](*lnl_cases.SMALL, 3))


@pytest.mark.parametrize("shape", lnl_cases.BLOCK_EDGES,
                         ids=lambda s: f"N={s[0]}-P={s[1]}")
def test_lnl_pending_at_block_edges_equal_reference(shape):
    """Pending (nodeless) pods where the N + 1 buckets fill whole blocks
    of the kernel's 1024 threads: the nodeless pods come last, as the
    reference orders them."""
    c = lnl_cases.pending(*shape, 3)
    assert (c["pod_node"] < 0).any()
    _assert_case_equals_reference(c)


def test_eviction_order_takes_shapes_past_the_old_key_field():
    """The wrapper's checks take N = 10 000 with P = 300 000 (rank and
    index fields of 14 + 19 bits: the old kernel refused them) and run
    the plain path there: the order is a permutation with the nodeless
    pods last and each source's pods in one run; the limits that stay
    (N >= 1, Rd <= 11) still raise."""
    c = lnl_cases.big()
    arrays, deviation = lnl_cases.k11_args(c)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    klnl.check_eviction_order_shape(*lnl_cases.BIG, 2)
    eo = klnl.lnl_eviction_order(*t, deviation)
    order = eo.order.numpy()
    assert np.array_equal(np.sort(order), np.arange(lnl_cases.BIG[1]))
    node_of = c["pod_node"][order]
    nodeless = int((c["pod_node"] < 0).sum())
    assert nodeless and (node_of[-nodeless:] < 0).all()
    runs = node_of[:-nodeless]
    starts = np.flatnonzero(np.r_[True, runs[1:] != runs[:-1]])
    assert len(starts) == len(np.unique(runs))
    for bad in ((0, 10, 2), (10, 10, 0), (10, 10, 12)):
        with pytest.raises(ValueError):
            klnl.check_eviction_order_shape(*bad)


def _raw_cols(n, p, seed, weights=(1.0, 1.0)):
    """Raw plan inputs: tied nodes, zero-usage pods, nodeless pods."""
    rng = np.random.default_rng(seed)
    cap = np.full((n, R), 64000.0, np.float32)
    cap[:, 1] = 262144.0
    frac = rng.uniform(0.05, 0.95, (n, R)).astype(np.float32)
    frac[rng.uniform(size=n) < 0.4] = frac[0]           # tied node_w
    frac[0, :2] = 0.9
    usage = (cap * frac).astype(np.float32)
    pod_node = np.sort(rng.integers(-1, n, p)).astype(np.int32)
    pod_node[:5] = -1                                   # nodeless pods
    pur = (rng.integers(0, 8, (p, 2)) * 500.0).astype(np.float32)
    pur[rng.uniform(size=p) < 0.2] = 0.0                # -pod_w = -0.0
    req = np.zeros((p, R), np.float32)
    req[:, :2] = pur
    oh = np.zeros((2, R), np.float32)
    oh[0, 0] = oh[1, 1] = 1.0
    return dict(usage=usage, capacity=cap, fresh=np.ones(n, bool),
                source_mask=np.ones(n, bool), pod_node=pod_node,
                pod_usage_r=pur, pod_req=req,
                pod_eligible=rng.uniform(size=p) < 0.9,
                low=np.array([45, 60], np.float32),
                high=np.array([65, 80], np.float32),
                weights=np.array(weights, np.float32), rdims_onehot=oh,
                fit_dims=(0, 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_order_edges_equal_reference(seed):
    """Sources tied on node_w (stable by index), zero-usage pods, pods of
    node -1 (last, never taken, never charging a node)."""
    cols = _raw_cols(70, 400, seed)
    ref, port = both_plans(cols, pad=True)
    assert_same_plan(ref, port)
    nodeless = np.flatnonzero(cols["pod_node"] < 0)
    assert set(ref[1][-len(nodeless):]) == set(nodeless)
    assert not ref[0][nodeless].any()


def test_orphan_pods_are_skipped_like_reference():
    """Pods listed under a node name the cluster does not have."""
    nodes, metrics, by_node = random_cluster(4, n_nodes=50)
    by_node["ghost"] = [japi.Pod(meta=japi.ObjectMeta(name="ghost-p0"),
                                 requests={JRK.CPU: 500.0},
                                 node_name="ghost")]
    kw = dict(consecutive_abnormalities=1, dry_run=True)
    want = names(jd.DeviceLowNodeLoad(jd.LowNodeLoadArgs(**kw))
                 .balance_once(nodes, metrics, by_node, NOW))
    objs = [api_from_reference(x) for x in (nodes, metrics, by_node)]
    got = names(td.DeviceLowNodeLoad(_port_args(kw), device="cpu")
                .balance_once(*objs, NOW))
    assert got == want and "default/ghost-p0" not in got


def test_non_unit_weights_round_as_the_reference():
    """XLA contracts the weighted sums into fused multiply-adds: two
    pods whose fused sums tie and whose plain sums do not keep index
    order in the reference; the port keeps it too."""
    w = np.array([0.3, 1.7], np.float32)
    grid = np.stack(np.meshgrid(np.arange(1, 120), np.arange(1, 120)),
                    -1).reshape(-1, 2).astype(np.float32)
    fused = klnl.weighted_sum(torch.from_numpy(grid),
                              torch.from_numpy(w)).numpy()
    plain = (grid[:, 0] * w[0]).astype(np.float32) + \
        (grid[:, 1] * w[1]).astype(np.float32)
    pair = None
    order = np.argsort(fused, kind="stable")
    for i, j in zip(order[:-1], order[1:]):
        if fused[i] == fused[j] and plain[j] > plain[i] and i < j:
            pair = (i, j)
            break
    assert pair is not None
    cols = _raw_cols(40, 2, 0, weights=tuple(w))
    cols["pod_node"] = np.zeros(2, np.int32)
    cols["pod_eligible"] = np.ones(2, bool)
    cols["pod_usage_r"] = grid[list(pair)]
    cols["pod_req"][:, :2] = grid[list(pair)]
    ref, port = both_plans(cols)
    assert_same_plan(ref, port)
    assert list(ref[1]) == [0, 1]   # tied: index order; plain sums: [1, 0]
    cols = _raw_cols(90, 500, 3, weights=tuple(w))
    assert_same_plan(*both_plans(cols, pad=True))
    assert_same_plan(*both_plans(cols, use_deviation=True, pad=True))


# --- thresholds that bind exactly ------------------------------------------

def test_budget_binding_at_zero_equals_reference():
    """The budget is the destinations' headroom summed in XLA's tree
    order (each term a fused multiply-add); two source pods of exactly
    that usage: the first takes the budget to zero and the second is
    refused. A sequential sum of the terms differs from the tree's here,
    which would take the second."""
    n_dst = 100
    rng = np.random.default_rng(11)
    for _ in range(200):
        frac = rng.uniform(0.1, 0.4, n_dst).astype(np.float32)
        dst_cpu = (np.float32(64000.0) * frac).astype(np.float32)
        scaled = torch.full((n_dst,), 64000.0 * 65.0)
        # the two source nodes' rows add zeros at the end
        terms = torch.cat([klnl.fma_f32(scaled, torch.tensor(0.01),
                                        -torch.from_numpy(dst_cpu)),
                           torch.zeros(2)])
        tree = klnl.xla_column_sum(terms[:, None])[0]
        seq = np.float32(0.0)
        for t in terms.numpy():
            seq = np.float32(seq + t)
        unfused = klnl.xla_column_sum(torch.cat([
            scaled * torch.tensor(0.01) - torch.from_numpy(dst_cpu),
            torch.zeros(2)])[:, None])
        if seq > tree and unfused[0] > tree:
            break
    # a sequential sum, or terms not fused, would leave budget for both
    assert seq > tree and unfused[0] > tree
    b = float(tree)
    cols = _raw_cols(n_dst + 2, 2, 0)
    cols["usage"][:n_dst, 0] = dst_cpu
    cols["usage"][:n_dst, 1] = 262144.0 * 0.2
    cols["usage"][n_dst:, 0] = 64000.0 * 0.99
    cols["pod_node"] = np.array([n_dst, n_dst + 1], np.int32)
    cols["pod_eligible"] = np.ones(2, bool)
    cols["pod_usage_r"] = np.array([[b, 1.0], [b, 1.0]], np.float32)
    cols["pod_req"][:] = 0.0
    for capped in (None, dict(pod_ns=np.zeros(2, np.int32),
                              ns_counts0=np.zeros(8, np.int32),
                              per_node0=np.zeros(n_dst + 2, np.int32),
                              max_evictions=10, max_per_node=10,
                              max_per_ns=10)):
        ref, port = both_plans(cols, capped=capped, node_fit=False)
        assert_same_plan(ref, port)
        assert ref[0].tolist() == [True, False]


def test_segment_prefix_rounds_as_the_reference():
    """A node's exclusive prefix is the global `jnp.cumsum` less the pod,
    less its value at the node's first pod; behind 1000 pods of
    fractional usage the global sums round at 1.0, and the node's usage
    is set between the verdict of XLA's blocked scan and those of a
    sequential one and of an f64-accumulated one: the port must take
    what the reference takes."""
    for seed in range(40):
        found = _segment_case(seed)
        if found is not None:
            break
    assert found is not None
    cols, order, k, seg_b, seg_s = found
    high_abs = np.float32(np.float32(64000.0 * 65.0) * np.float32(0.01))
    # the last node's usage: over after its first pod by one scan's
    # prefix and not by the other's
    u = np.float32(high_abs + (seg_b + seg_s) / 2)
    lo_seg, hi_seg = min(seg_b, seg_s), max(seg_b, seg_s)
    while not (np.float32(u - lo_seg) > high_abs
               >= np.float32(u - hi_seg)):
        u = np.nextafter(u, np.float32(np.inf) if np.float32(u - lo_seg)
                         <= high_abs else np.float32(0))
    cols["usage"][cols["pod_node"][-1], 0] = u
    ref, port = both_plans(cols, node_fit=False)
    assert_same_plan(ref, port)
    assert np.array_equal(ref[1], order)
    taken_second = bool(ref[0][order[k[1]]])
    assert taken_second == bool(np.float32(u - seg_b) > high_abs)
    assert taken_second != bool(np.float32(u - seg_s) > high_abs)


def _segment_case(seed):
    """Plan inputs for test_segment_prefix_rounds_as_the_reference, with
    the order and the last node's first two prefixes under XLA's scan
    and a sequential one; None when the two agree."""
    n_hot, n_dst, per = 50, 9, 20
    n = n_hot + 1 + n_dst
    last = n_hot
    rng = np.random.default_rng(seed)
    cols = _raw_cols(n, 1, 0)
    cap, usage = cols["capacity"], cols["usage"]
    cap[n_hot + 1:, 0] = 1e9                  # a budget that never binds
    usage[:, 1] = 262144.0 * 0.5
    usage[:n_hot, 0] = 64000.0 * 0.99
    usage[:n_hot, 1] = 262144.0 * 0.9
    usage[n_hot + 1:, 0] = 1e8
    usage[n_hot + 1:, 1] = 262144.0 * 0.1
    pod_node = np.concatenate([np.repeat(np.arange(n_hot), per),
                               [last] * 3]).astype(np.int32)
    p = pod_node.shape[0]
    pur = np.ones((p, 2), np.float32)
    pur[:, 0] = rng.uniform(12000, 13000, p).astype(np.float32)
    pur[-3:, 0] = rng.uniform(900, 1100, 3).astype(np.float32)
    cols.update(pod_node=pod_node, pod_usage_r=pur,
                pod_req=np.zeros((p, R), np.float32),
                pod_eligible=np.ones(p, bool))
    usage[last, 0] = 64000.0 * 0.8
    _, (_, order) = both_plans(cols, node_fit=False)
    x = torch.from_numpy(pur[order])
    blocked = (klnl.xla_cumsum(x) - x)[:, 0].numpy()
    seq = (torch.from_numpy(np.cumsum(pur[order], 0, dtype=np.float32))
           - x)[:, 0].numpy()
    k = np.flatnonzero(pod_node[order] == last)
    assert list(k) == [p - 3, p - 2, p - 1]
    # torch's CPU cumsum accumulates in f64: a third order
    wide = (torch.cumsum(x, 0) - x)[:, 0].numpy()
    seg_b = np.float32(blocked[k[1]] - blocked[k[0]])
    seg_s = np.float32(seq[k[1]] - seq[k[0]])
    seg_w = np.float32(wide[k[1]] - wide[k[0]])
    if seg_s == seg_b or (seg_s > seg_b) != (seg_w > seg_b) or \
            seg_w == seg_b:
        return None
    # the other order nearer seg_b flips both verdicts
    near = min((seg_s, seg_w), key=lambda v: abs(v - seg_b))
    return cols, order, k, seg_b, near


def test_budget_prefix_rounds_as_the_reference():
    """The budget's prefix is the taken pods' `jnp.cumsum` less the pod:
    300 one-pod sources of fractional usage, and one destination whose
    usage sets the budget between what XLA's blocked scan and the other
    orders (sequential f32, f64-accumulated) have spent before one pod:
    the port must stop where the reference stops."""
    n_src = 300
    rng = np.random.default_rng(2)
    for _ in range(20):
        u = rng.uniform(900, 1100, n_src).astype(np.float32)
        x = torch.from_numpy(u)
        blocked = (klnl.xla_cumsum(x) - x).numpy()
        seq = np.cumsum(u, dtype=np.float32) - u
        wide = (torch.cumsum(x, 0) - x).numpy()
        hits = [i for i in range(16, n_src)
                if blocked[i] < min(seq[i], wide[i])]
        if hits:
            break
    assert hits
    i = hits[0]
    n = n_src + 1
    cols = _raw_cols(n, 1, 0)
    cap, usage = cols["capacity"], cols["usage"]
    usage[:n_src, 0] = 64000.0 * 0.99
    usage[:n_src, 1] = 262144.0 * 0.9
    # the destination: capacity * 65 % about twice the target, so that
    # its usage (about the target, 32 % of capacity: a low node) steps
    # the budget by the target's own ulp
    want_lo, want_hi = blocked[i], min(seq[i], wide[i])
    c = np.float32(np.round(2.0 * want_hi / 0.65))
    cap[n_src, :2] = c
    usage[n_src, 1] = c * np.float32(0.1)
    cols.update(pod_node=np.arange(n_src, dtype=np.int32),
                pod_usage_r=np.stack([u, np.ones_like(u)], 1),
                pod_req=np.zeros((n_src, R), np.float32),
                pod_eligible=np.ones(n_src, bool))
    # its usage: budget0 = fma(c * 65, 0.01, -usage) in (blocked[i], the
    # other orders' prefix at i]
    scaled = torch.tensor([c * np.float32(65.0)])
    d = np.float32(scaled.item() * np.float32(0.01) - want_hi)
    step = np.float32(np.inf)
    for _ in range(10_000):
        b = klnl.fma_f32(scaled, torch.tensor(0.01),
                         -torch.tensor([d]))[0].item()
        if want_lo < b <= want_hi:
            break
        d = np.nextafter(d, step if b > want_hi else np.float32(0))
    assert want_lo < b <= want_hi
    usage[n_src, 0] = d
    ref, port = both_plans(cols, node_fit=False)
    assert_same_plan(ref, port)
    assert list(ref[1]) == list(range(n_src))
    assert ref[0].sum() == i + 1     # the other orders stop before pod i


def test_pod_landing_a_node_on_high_abs_stops_it():
    """A node at 49 600 mC of 64 000 (high 65 %: high_abs 41 600 exactly)
    with three 4000 mC pods: after two it sits on high_abs and is no
    longer over, so the third stays; the reference, the port's plan and
    the host loop agree."""
    nodes, metrics, by_node = [], {}, {}
    for name, cpu in (("dst", 64000.0 * 0.2), ("hot", 49600.0)):
        nodes.append(japi.Node(meta=japi.ObjectMeta(name=name),
                               allocatable={JRK.CPU: 64000.0,
                                            JRK.MEMORY: 65536.0}))
        metrics[name] = japi.NodeMetric(
            node_name=name, update_time=NOW,
            node_usage={JRK.CPU: cpu, JRK.MEMORY: 65536.0 * 0.3})
        by_node[name] = []
    by_node["hot"] = [japi.Pod(meta=japi.ObjectMeta(name=f"hot-p{j}"),
                               requests={JRK.CPU: 4000.0, JRK.MEMORY: 64.0},
                               node_name="hot") for j in range(3)]
    kw = dict(consecutive_abnormalities=1, dry_run=True)
    want = names(jd.DeviceLowNodeLoad(jd.LowNodeLoadArgs(**kw))
                 .balance_once(nodes, metrics, by_node, NOW))
    objs = [api_from_reference(x) for x in (nodes, metrics, by_node)]
    got = names(td.DeviceLowNodeLoad(_port_args(kw), device="cpu")
                .balance_once(*objs, NOW))
    host = names(td.LowNodeLoad(_port_args(kw)).balance_once(*objs, NOW))
    assert got == want == host == ["default/hot-p0", "default/hot-p1"]


# --- BASELINE config 5 -------------------------------------------------------

def reference_config_5(n):
    """bench_configs.config_5_descheduler's cluster (:159-183) at n
    nodes, with the reference's types."""
    rng = np.random.default_rng(3)
    nodes, metrics, pods_by_node = [], {}, {}
    usage_frac = rng.uniform(0.1, 0.95, size=n)
    for i in range(n):
        name = f"n{i}"
        nodes.append(japi.Node(meta=japi.ObjectMeta(name=name),
                               allocatable={JRK.CPU: 64000.0,
                                            JRK.MEMORY: 262144.0}))
        metrics[name] = japi.NodeMetric(
            node_name=name, update_time=NOW,
            node_usage={JRK.CPU: 64000.0 * usage_frac[i],
                        JRK.MEMORY: 262144.0 * usage_frac[i]})
        if usage_frac[i] > 0.7:
            pods_by_node[name] = [
                japi.Pod(meta=japi.ObjectMeta(name=f"{name}-p{j}",
                                              uid=f"{name}-p{j}"),
                         priority=5500, qos_label="BE", node_name=name,
                         requests={JRK.CPU: 4000.0, JRK.MEMORY: 8192.0})
                for j in range(4)]
    return nodes, metrics, pods_by_node


def _fields(obj):
    return {f.name: _fields(getattr(obj, f.name))
            if dataclasses.is_dataclass(getattr(obj, f.name))
            else getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_config_5_builder_equals_bench_draws():
    ref = api_from_reference(reference_config_5(1000))
    port = config_5_cluster(1000)
    assert [_fields(x) for x in port[0]] == [_fields(x) for x in ref[0]]
    assert {k: _fields(v) for k, v in port[1].items()} == \
        {k: _fields(v) for k, v in ref[1].items()}
    assert {k: [_fields(p) for p in v] for k, v in port[2].items()} == \
        {k: [_fields(p) for p in v] for k, v in ref[2].items()}


@pytest.mark.parametrize("capped", [False, True], ids=["plain", "capped"])
def test_config_5_equals_reference(capped):
    """Config 5 at 1000 nodes through run_config_5_descheduler (warm
    plan, limiter reset, timed plan) against the reference's
    DeviceLowNodeLoad measured the same way."""
    cluster = reference_config_5(1000)
    evictor = jd.RecordingEvictor(
        jd.EvictionLimiter(**configs.CONFIG_5_CAPS) if capped else None)
    plugin = jd.DeviceLowNodeLoad(
        jd.LowNodeLoadArgs(consecutive_abnormalities=1), evictor)
    plugin.balance_once(*cluster, NOW)
    evictor.limiter.reset()
    evictor.evictions.clear()
    plugin.balance_once(*cluster, NOW)
    want = names(e.pod for e in evictor.evictions)
    line, run = configs.run_config_5_descheduler(capped, n_nodes=1000,
                                                 device="cpu")
    assert names(e.pod for e in run.evictor.evictions) == want
    assert line["evictions_planned"] == len(want) > 0
    assert line["nodes"] == 1000


# --- the port's own surfaces -------------------------------------------------

def test_recording_evictor_stats_are_not_ported():
    with pytest.raises(NotImplementedError):
        td.RecordingEvictor(stats=object())


@pytest.mark.parametrize("row", [(0.0, 0.0), (0.5, 0.5), (1.0, 1.0)],
                         ids=["zeros", "weighted", "two_ones"])
def test_plans_reject_rdims_not_one_hot(row):
    """The reference's dot with rdims_onehot would weigh or drop dims;
    the port's gather takes one dim a row, so anything else raises."""
    cols = _raw_cols(10, 20, 0)
    fit_dims = cols.pop("fit_dims")
    cols["rdims_onehot"][1, :2] = row
    t = [torch.from_numpy(np.ascontiguousarray(cols[k])) for k in (
        "usage", "capacity", "fresh", "source_mask", "pod_node",
        "pod_usage_r", "pod_req", "pod_eligible", "low", "high", "weights",
        "rdims_onehot")]
    with pytest.raises(ValueError, match="rdims_onehot"):
        tdev.plan_kernel(*t, 100, fit_dims=fit_dims)


def test_wrappers_check_their_inputs():
    cols = _raw_cols(10, 20, 0)
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in cols.items() if k != "fit_dims"}
    with pytest.raises(TypeError):
        klnl.lnl_node_fit(t["pod_req"].double(), t["pod_node"],
                          t["capacity"], torch.ones(10, dtype=torch.bool))
    with pytest.raises(ValueError):
        klnl.lnl_node_fit(t["pod_req"], t["pod_node"], t["capacity"],
                          torch.ones(10, dtype=torch.bool), fit_dims=(11,))
    with pytest.raises(ValueError):
        klnl.lnl_eviction_order(
            t["usage"], t["capacity"], t["fresh"], t["source_mask"],
            t["pod_node"][:3], t["pod_usage_r"], t["pod_eligible"],
            t["low"], t["high"], t["weights"],
            torch.tensor([0, 1], dtype=torch.int32), False)
