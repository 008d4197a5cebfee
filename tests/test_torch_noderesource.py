"""koord-manager's batch and mid overcommit (ROADMAP B18) in the port
against the JAX package: tests/test_noderesource.py's cases on the port
(its assertions, and every output equal to the reference's on the same
objects), K19's plain version against the reference's jitted
`_batch_allocatable` and `_mid_allocatable` on random columns with NaN,
infinite and negative values under every policy, the colocation
config's merge, annotations and validation, and `node_resource_cluster`
at 2000 nodes through the port's and the reference's
NodeResourceController over two reconciles: batch, mid, degraded,
sync_mask and the gauges equal. The typed objects are the port's,
carried to the reference by attribute.

Tolerances: none; f32 outputs compared bit for bit."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from koordinator_tpu.api import extension as jext
from koordinator_tpu.api import types as jtypes
from koordinator_tpu.metrics import Registry as JRegistry
from koordinator_tpu.slo_controller import config as jconfig
from koordinator_tpu.slo_controller import noderesource as jnr
from koordinator_tpu.slo_controller.metrics_defs import (
    SloControllerMetrics as JMetrics,
)
from koordinator_tpu_torch import configs
from koordinator_tpu_torch.api import extension as text
from koordinator_tpu_torch.api import types as ttypes
from koordinator_tpu_torch.kernels.node_overcommit import (
    node_overcommit,
    node_overcommit_plain,
)
from koordinator_tpu_torch.metrics import Registry
from koordinator_tpu_torch.slo_controller import config as tconfig
from koordinator_tpu_torch.slo_controller import noderesource as tnr
from koordinator_tpu_torch.slo_controller.metrics_defs import (
    SloControllerMetrics,
)
from koordinator_tpu_torch.utils.synthetic import node_resource_cluster

from torch_port_ref import (  # noqa: F401 (one_torch_thread: a fixture)
    api_to_reference,
    assert_bits_equal,
    one_torch_thread,
)

REF = types.SimpleNamespace(t=jtypes, x=jext, c=jconfig, nr=jnr,
                            metrics=lambda: JMetrics(JRegistry()))
PORT = types.SimpleNamespace(t=ttypes, x=text, c=tconfig, nr=tnr,
                             metrics=lambda: SloControllerMetrics(Registry()))
CPU, MEM = tnr.CPU, tnr.MEM


def mk_node(m, name="n0", cpu=100000.0, mem=400000.0):
    rk = m.x.ResourceKind
    return m.t.Node(meta=m.t.ObjectMeta(name=name),
                    allocatable={rk.CPU: cpu, rk.MEMORY: mem})


def mk_prod_pod(m, name, cpu, mem, node="n0"):
    rk = m.x.ResourceKind
    return m.t.Pod(meta=m.t.ObjectMeta(name=name), priority=9500,
                   requests={rk.CPU: cpu, rk.MEMORY: mem},
                   node_name=node, phase="Running")


def pod_metric(m, name, cpu, mem):
    rk = m.x.ResourceKind
    return m.t.PodMetricInfo(namespace="default", name=name,
                             priority_class=m.x.PriorityClass.PROD,
                             usage={rk.CPU: cpu, rk.MEMORY: mem})


def compute(m, inputs, strategy, **kw):
    if m is PORT:
        kw["device"] = "cpu"
    return m.nr.compute_node_resources(inputs, strategy, **kw)


# each case builds its objects in one package and returns (outputs,
# checks): the reference test's assertions on the outputs


def case_batch_by_usage(m):
    rk = m.x.ResourceKind
    metric = m.t.NodeMetric(
        node_name="n0", update_time=1000.0,
        system_usage={rk.CPU: 7000.0, rk.MEMORY: 5000.0},
        pods_metric=[pod_metric(m, "p0", 20000.0, 30000.0)])
    inputs = m.nr.build_inputs([mk_node(m, cpu=1e5, mem=1e5)],
                               {"n0": metric},
                               {"n0": [mk_prod_pod(m, "p0", 3e4, 4e4)]},
                               now=1030.0)
    out = compute(m, inputs, m.c.ColocationStrategy(
        enable=True, cpu_reclaim_threshold_percent=60.0,
        memory_reclaim_threshold_percent=65.0))
    return out, lambda o: (o["batch"][0, CPU] == 33000.0
                           and o["batch"][0, MEM] == 30000.0
                           and not o["degraded"][0])


def case_pod_without_metric(m):
    rk = m.x.ResourceKind
    metric = m.t.NodeMetric(node_name="n0", update_time=1000.0,
                            system_usage={rk.CPU: 0.0, rk.MEMORY: 0.0})
    inputs = m.nr.build_inputs([mk_node(m, cpu=1e5, mem=1e5)],
                               {"n0": metric},
                               {"n0": [mk_prod_pod(m, "p0", 3e4, 4e4)]},
                               now=1000.0)
    out = compute(m, inputs, m.c.ColocationStrategy(
        cpu_reclaim_threshold_percent=100.0,
        memory_reclaim_threshold_percent=100.0))
    return out, lambda o: (o["batch"][0, CPU] == 70000.0
                           and o["batch"][0, MEM] == 60000.0)


def case_dangling_metric(m):
    metric = m.t.NodeMetric(
        node_name="n0", update_time=0.0,
        pods_metric=[pod_metric(m, "ghost", 10000.0, 15000.0)])
    inputs = m.nr.build_inputs([mk_node(m, cpu=1e5, mem=1e5)],
                               {"n0": metric}, {"n0": []}, now=0.0)
    out = compute(m, inputs, m.c.ColocationStrategy(
        cpu_reclaim_threshold_percent=100.0,
        memory_reclaim_threshold_percent=100.0, degrade_time_minutes=1e9))
    return out, lambda o: (o["batch"][0, CPU] == 90000.0
                           and o["batch"][0, MEM] == 85000.0)


def case_memory_by_request(m):
    rk = m.x.ResourceKind
    metric = m.t.NodeMetric(
        node_name="n0", update_time=1000.0,
        system_usage={rk.CPU: 0.0, rk.MEMORY: 9000.0},
        pods_metric=[pod_metric(m, "p0", 1000.0, 20000.0)])
    inputs = m.nr.build_inputs([mk_node(m, cpu=1e5, mem=1e5)],
                               {"n0": metric},
                               {"n0": [mk_prod_pod(m, "p0", 3e4, 5e4)]},
                               now=1000.0)
    out = compute(m, inputs, m.c.ColocationStrategy(
        cpu_reclaim_threshold_percent=100.0,
        memory_reclaim_threshold_percent=100.0,
        memory_calculate_policy=m.c.CalculatePolicy.REQUEST))
    return out, lambda o: (o["batch"][0, MEM] == 50000.0
                           and o["batch"][0, CPU] == 99000.0)


def case_degrade(m):
    metric = m.t.NodeMetric(node_name="n0", update_time=0.0)
    inputs = m.nr.build_inputs([mk_node(m)], {"n0": metric}, {"n0": []},
                               now=16.0 * 60.0)
    out = compute(m, inputs, m.c.ColocationStrategy(degrade_time_minutes=15.0))
    return out, lambda o: (o["degraded"][0] and (o["batch"][0] == -1).all()
                           and (o["mid"][0] == -1).all())


def case_mid_capped(m):
    rk = m.x.ResourceKind
    metric = m.t.NodeMetric(node_name="n0", update_time=1000.0,
                            prod_reclaimable={rk.CPU: 50000.0,
                                              rk.MEMORY: 2000.0})
    inputs = m.nr.build_inputs([mk_node(m, cpu=1e5, mem=1e5)],
                               {"n0": metric}, {"n0": []}, now=1000.0)
    out = compute(m, inputs, m.c.ColocationStrategy(
        mid_cpu_threshold_percent=10.0, mid_memory_threshold_percent=10.0))
    return out, lambda o: (o["mid"][0, CPU] == 10000.0
                           and o["mid"][0, MEM] == 2000.0)


def case_per_node_strategies(m):
    nodes = [mk_node(m, "n0"), mk_node(m, "n1")]
    mets = {n.meta.name: m.t.NodeMetric(node_name=n.meta.name,
                                        update_time=0.0) for n in nodes}
    inputs = m.nr.build_inputs(nodes, mets, {}, now=0.0)
    base = m.c.ColocationStrategy(cpu_reclaim_threshold_percent=60.0,
                                  memory_reclaim_threshold_percent=100.0)
    hot = m.c.ColocationStrategy(cpu_reclaim_threshold_percent=80.0,
                                 memory_reclaim_threshold_percent=100.0)
    out = compute(m, inputs, base, strategies=[base, hot])
    return out, lambda o: (o["batch"][0, CPU] == 60000.0
                           and o["batch"][1, CPU] == 80000.0)


CASES = {f.__name__[5:]: f for f in (
    case_batch_by_usage, case_pod_without_metric, case_dangling_metric,
    case_memory_by_request, case_degrade, case_mid_capped,
    case_per_node_strategies)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_cases_equal_reference(name):
    """tests/test_noderesource.py's calculator cases: the port meets the
    reference test's assertions, and batch, mid and degraded equal the
    reference's bit for bit."""
    got, check = CASES[name](PORT)
    want, _ = CASES[name](REF)
    assert check(got)
    for k in ("batch", "mid", "degraded"):
        assert_bits_equal(got[k], np.asarray(want[k]), k)


def test_need_sync_diff_gate():
    old = np.array([[10000.0, 10000.0], [10000.0, 10000.0]], np.float32)
    new = np.array([[10500.0, 10000.0], [12000.0, 10000.0]], np.float32)
    mask = tnr.need_sync(old, new, 0.1)
    assert not mask[0] and mask[1]
    np.testing.assert_array_equal(mask, jnr.need_sync(old, new, 0.1))


def test_controller_sync_mask_and_state():
    nodes = [mk_node(PORT, f"n{i}") for i in range(3)]
    metrics = {f"n{i}": ttypes.NodeMetric(node_name=f"n{i}",
                                          update_time=100.0)
               for i in range(3)}
    ctl = tnr.NodeResourceController(stats=PORT.metrics(), device="cpu")
    inputs = tnr.build_inputs(nodes, metrics, {}, now=100.0)
    assert ctl.reconcile(inputs)["sync_mask"].all()
    assert not ctl.reconcile(inputs)["sync_mask"].any()


def test_sync_gate_latches_applied_value():
    """Sub-threshold drift accumulates against the last applied value
    and syncs once it crosses the threshold."""
    node = mk_node(PORT, cpu=1e5, mem=1e5)
    ctl = tnr.NodeResourceController(strategy=tconfig.ColocationStrategy(
        cpu_reclaim_threshold_percent=100.0,
        memory_reclaim_threshold_percent=100.0,
        resource_diff_threshold=0.1), stats=PORT.metrics(), device="cpu")

    def usage(v):
        m = ttypes.NodeMetric(node_name="n0", update_time=0.0,
                              system_usage={text.ResourceKind.CPU: v,
                                            text.ResourceKind.MEMORY: 0.0})
        return tnr.build_inputs([node], {"n0": m}, {"n0": []}, now=0.0)

    ctl.reconcile(usage(0.0))
    assert not ctl.reconcile(usage(5000.0))["sync_mask"][0]
    assert not ctl.reconcile(usage(9000.0))["sync_mask"][0]
    assert ctl.reconcile(usage(12000.0))["sync_mask"][0]


def test_colocation_config_equals_reference():
    """Merge by node selector, node annotation JSON (typed coercion,
    illegal values dropped), reclaim-ratio labels, and the webhook's
    validation: every strategy field equal to the reference's."""
    ann = text.ANNOTATION_NODE_COLOCATION_STRATEGY
    cases = [
        ({"pool": "batch"}, {}),
        ({"pool": "other"}, {}),
        ({"pool": "batch", text.LABEL_CPU_RECLAIM_RATIO: "0.7"}, {}),
        ({text.LABEL_MEMORY_RECLAIM_RATIO: "1.5"}, {}),
        ({}, {ann: json.dumps({"memoryCalculatePolicy": "request",
                               "midCPUThresholdPercent": 30,
                               "enable": "yes"})}),
        ({}, {ann: "{not json"}),
    ]
    cfg = tconfig.ColocationConfig(
        cluster_strategy=tconfig.ColocationStrategy(
            cpu_reclaim_threshold_percent=60.0),
        node_overrides=[tconfig.ColocationStrategyOverride(
            node_selector={"pool": "batch"},
            fields={"cpu_reclaim_threshold_percent": 80.0})])
    ref = api_to_reference(cfg)
    for labels, anns in cases:
        got = cfg.strategy_for(labels, anns)
        want = ref.strategy_for(labels, anns)
        for f in ("cpu_reclaim_threshold_percent",
                  "memory_reclaim_threshold_percent",
                  "mid_cpu_threshold_percent", "memory_calculate_policy",
                  "enable"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g.value if hasattr(g, "value") else g) == \
                (w.value if hasattr(w, "value") else w), (labels, anns, f)
    assert cfg.strategy_for({"pool": "batch"}) \
        .cpu_reclaim_threshold_percent == 80.0
    assert tconfig.validate_colocation_config(cfg) == []
    bad = tconfig.ColocationConfig(cluster_strategy=tconfig.ColocationStrategy(
        cpu_reclaim_threshold_percent=150.0, degrade_time_minutes=0.0),
        node_overrides=[tconfig.ColocationStrategyOverride(
            fields={"nope": 1.0})])
    assert tconfig.validate_colocation_config(bad) == \
        jconfig.validate_colocation_config(api_to_reference(bad))
    assert len(tconfig.validate_colocation_config(bad)) == 4


# --- K19's plain version against the reference's formulas ------------------


def _k19_columns(rng, n):
    """Random columns with NaN, +-inf and negative entries, every policy."""
    f32 = np.float32

    def col(scale):
        x = rng.uniform(-0.1, 1.0, (n, 2)) * scale
        special = rng.uniform(size=(n, 2))
        x = np.where(special < 0.01, np.nan, x)
        x = np.where((special >= 0.01) & (special < 0.02), np.inf, x)
        x = np.where((special >= 0.02) & (special < 0.03), -np.inf, x)
        x = np.where((special >= 0.03) & (special < 0.04), -0.0, x)
        return x.astype(f32)

    cols = {k: col(s) for k, s in (
        ("capacity", 1e5), ("node_reserved", 3e4), ("system_reserved", 5e3),
        ("system_used", 8e3), ("hp_req", 4e4), ("hp_used", 3e4),
        ("hp_max", 4e4))}
    cols["cpu_by_max"] = rng.uniform(size=n) < 0.5
    cols["mem_policy"] = rng.integers(0, 3, n).astype(np.int32)
    mid = {"allocatable": col(1e5), "prod_reclaimable": col(3e4),
           "threshold_ratio": col(1.0)}
    return cols, mid


@pytest.mark.parametrize("seed", range(3))
def test_node_overcommit_plain_equals_reference(seed):
    """K19's plain version (batch and mid) equals the reference's jitted
    formulas bit for bit on 4096 nodes, NaN and infinities included; the
    wrapper on CPU tensors returns the plain version."""
    cols, mid = _k19_columns(np.random.default_rng(seed), 4096)
    want_b = np.asarray(jnr._batch_allocatable(*cols.values()))
    want_m = np.asarray(jnr._mid_allocatable(*mid.values()))
    t = {k: torch.from_numpy(v) for k, v in {**cols, **mid}.items()}
    args = [t[k] for k in (*cols, *mid)]
    got_b, got_m = node_overcommit_plain(*args)
    assert_bits_equal(got_b.numpy(), want_b, "batch")
    assert_bits_equal(got_m.numpy(), want_m, "mid")
    wb, wm = node_overcommit(*args)
    assert torch.equal(wb.view(torch.int32), got_b.view(torch.int32))
    assert torch.equal(wm.view(torch.int32), got_m.view(torch.int32))
    assert np.isnan(want_b).any() and np.isinf(want_b).any()
    with pytest.raises(TypeError):
        node_overcommit(*args[:8], args[8].long(), *args[9:])


# --- node_resource_cluster through both controllers ------------------------


def _gauge_bits(stats):
    """The extended-allocatable gauge's samples with each value as its
    float64 bits (a NaN gauge compares equal to a NaN gauge)."""
    samples = stats if isinstance(stats, list) else \
        stats.node_extended_resource_allocatable.samples()
    return [(name, labels, np.float64(v).view(np.uint64))
            for name, labels, v in samples]


def test_node_resource_cluster_equals_reference_controller():
    """node_resource_cluster at 2000 nodes, two reconciles (the second on
    the drifted metrics): batch, mid, degraded and sync_mask equal to
    the reference's NodeResourceController (NaN rows included), the
    gauges' samples equal, and the diff gate both syncs and holds rows
    on the second reconcile; `run_node_resource` gives the same."""
    c = node_resource_cluster(2000)
    nodes = c["nodes"]
    strategies = [c["config"].strategy_for(n.meta.labels, n.meta.annotations)
                  for n in nodes]
    ctl = tnr.NodeResourceController(strategy=c["config"].cluster_strategy,
                                     stats=PORT.metrics(), device="cpu")
    ref = jnr.NodeResourceController(
        strategy=api_to_reference(c["config"].cluster_strategy),
        stats=REF.metrics())
    ref_nodes = api_to_reference(nodes)
    ref_pods = api_to_reference(c["pods_by_node"])
    ref_res = api_to_reference(c["node_reservations"])
    ref_strat = api_to_reference(strategies)
    line, run = configs.run_node_resource(2000, device="cpu")
    for k, (metrics, now) in enumerate(((c["metrics"], c["now"]),
                                        (c["drifted"], c["drift_now"]))):
        got = ctl.reconcile(tnr.build_inputs(
            nodes, metrics, c["pods_by_node"], now, c["node_reservations"]),
            strategies)
        want = ref.reconcile(jnr.build_inputs(
            ref_nodes, api_to_reference(metrics), ref_pods, now, ref_res),
            ref_strat)
        for f in ("batch", "mid", "degraded", "sync_mask"):
            assert_bits_equal(got[f], np.asarray(want[f]), f"{k}.{f}")
            assert_bits_equal(run.outputs[k][f], got[f], f"run {k}.{f}")
        assert _gauge_bits(ctl.stats) == _gauge_bits(ref.stats)
        assert np.isnan(got["batch"]).any() and got["degraded"].any()
    assert 0 < got["sync_mask"].sum() < len(nodes) - got["degraded"].sum()
    assert line["reconciles"][1]["synced"] == int(got["sync_mask"].sum())
    assert _gauge_bits(run.gauges[1]) == _gauge_bits(ctl.stats)
