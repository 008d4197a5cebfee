"""Taints and tolerations in the port against the JAX package: the
static gates in factored form with the forbid and penalty tables
(`cascade.static_gate_terms`, `expand_gates`, `taint_penalty`) against
the reference's `cascade.static_gates`, K1's plain version with the
taint term against the reference's masked lax.top_k, and
schedule_batch on the taint scenarios of tests/test_scheduler_core.py
and on the full-gate workload without slots.

Tolerances: none. Masks, indices and ints are compared exactly, floats
bit for bit."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.api.extension import ResourceKind as RK
from koordinator_tpu.scheduler import cascade as jcascade
from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch import configs
from koordinator_tpu_torch.kernels.score_topk import score_topk
from koordinator_tpu_torch.scheduler import cascade, core
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig

from test_torch_reservation import (
    assert_results_equal,
    k1_slot_inputs,
    reference_select_slots,
)
from torch_port_ref import to_port
from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)


def _taint_case(variant, seed=0):
    """A full-gate cluster and its pods (no slots) with the taint
    tables edited by `variant`: as drawn; toleration ids and taint
    groups negative and past the tables' ends; a PreferNoSchedule table
    of zeros; one of counts (normalised by the largest); and one of all
    ones (a penalty of MaxNodeScore on every pair, above most scores)."""
    rng = np.random.default_rng(seed)
    snap = jsyn.full_gate_cluster(150, seed=seed, num_reservations=0)
    pods = jsyn.full_gate_pods(600, 150, seed=seed + 1)
    t, g = np.asarray(pods.tol_forbid).shape
    if variant == "wild_indices":
        pods = pods.replace(toleration_id=jnp.asarray(
            rng.integers(-3, t + 3, 600).astype(np.int32)))
        snap = snap.replace(nodes=snap.nodes.replace(
            taint_group=jnp.asarray(
                rng.integers(-g - 3, g + 3, 150).astype(np.int32))))
    elif variant == "prefer_zero":
        pods = pods.replace(tol_prefer=jnp.zeros((t, g), jnp.float32))
    elif variant == "prefer_counts":
        pods = pods.replace(tol_prefer=jnp.asarray(
            rng.integers(0, 4, (t, g)).astype(np.float32)))
    elif variant == "prefer_all":
        pods = pods.replace(tol_prefer=jnp.ones((t, g), jnp.float32))
    return snap, pods


VARIANTS = ["as_drawn", "wild_indices", "prefer_zero", "prefer_counts",
            "prefer_all"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_static_gates_with_taints_equal_reference(variant):
    """The factored gates with the taint tables, expanded, equal the
    reference's static mask; the penalty equals its taint penalty bit
    for bit; the port's plain static_gates equals both."""
    snap, pods = _taint_case(variant)
    want_ok, want_pen = jax.jit(jcascade.static_gates)(
        snap.nodes, pods, JCfg.make())
    tn, tp = to_port("NodeState", snap.nodes), to_port("PodBatch", pods)
    cfg = LoadAwareConfig.make(device="cpu")
    gates = cascade.static_gate_terms(tn, tp, cfg, None)
    np.testing.assert_array_equal(cascade.expand_gates(gates).numpy(),
                                  np.asarray(want_ok))
    pen = cascade.taint_penalty(gates)
    assert pen.numpy().tobytes() == np.asarray(want_pen).tobytes()
    plain_ok, plain_pen = cascade.static_gates(tn, tp, cfg)
    np.testing.assert_array_equal(plain_ok.numpy(), np.asarray(want_ok))
    assert plain_pen.numpy().tobytes() == np.asarray(want_pen).tobytes()
    assert not np.asarray(want_ok).all()
    if variant == "prefer_zero":
        assert not pen.any()
    else:
        assert (pen > 0).any()


def test_gate_terms_without_taints_carry_no_tables():
    """A batch without tolerations: no taint tables, no penalty, and the
    same mask as the reference's (whose taint gate compiles out)."""
    snap, pods = _taint_case("as_drawn")
    pods = pods.replace(has_taints=False)
    tn, tp = to_port("NodeState", snap.nodes), to_port("PodBatch", pods)
    gates = cascade.static_gate_terms(tn, tp,
                                      LoadAwareConfig.make(device="cpu"),
                                      None)
    assert gates.tol_forbid is None and cascade.taint_penalty(gates) is None
    want_ok, want_pen = jax.jit(jcascade.static_gates)(
        snap.nodes, pods, JCfg.make())
    assert want_pen is None
    np.testing.assert_array_equal(cascade.expand_gates(gates).numpy(),
                                  np.asarray(want_ok))


def _no_slots(ref, port, n):
    """The K1 inputs of `k1_slot_inputs` without their slot columns."""
    ref = dict(ref, ext_static=ref["ext_static"][:, :n],
               requested=ref["requested"][:n], ext_alloc=ref["ext_alloc"][:n],
               blocked=ref["blocked"][:0])
    port = dict(port, requested_fit=port["requested_fit"][:n].contiguous(),
                alloc_fit=port["alloc_fit"][:n].contiguous(),
                slot_ok=None, slot_block=None)
    return ref, port


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("addend", [True, False], ids=["addend", "no_addend"])
@pytest.mark.parametrize("k,tie_break", [(8, True), (32, False)])
def test_k1_taint_term_equal_reference(seed, addend, k, tie_break):
    """K1's plain version with the taint term (the forbid gate and the
    penalty, floored at 0, with and without a pair addend) against the
    reference's masked lax.top_k: indices exactly, values bit for
    bit."""
    ref, port = _no_slots(*k1_slot_inputs(seed), n=120)
    if not addend:
        ref["addend"] = jnp.zeros_like(ref["addend"])
        port["pair_score"] = None
    want = reference_select_slots(**ref, k=k, tie_break=tie_break)
    got = score_topk(**port, k=k, tie_break=tie_break)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()


def test_k1_penalty_above_the_score_keeps_pairs_feasible():
    """A penalty of MaxNodeScore on every pair floors each feasible
    pair's value at 0: it stays feasible (0 plus its jitter, above the
    -1 of an infeasible pair), so each row keeps as many feasible
    entries as without the penalty; equal to the reference."""
    ref, port = _no_slots(*k1_slot_inputs(4), n=120)
    gates = port["gates"]
    full = gates.replace(tol_penalty=torch.full_like(gates.tol_penalty,
                                                     100.0))
    none = gates.replace(tol_penalty=torch.zeros_like(gates.tol_penalty))
    ref = dict(ref, taint_penalty=jnp.full_like(ref["taint_penalty"], 100.0))
    want = reference_select_slots(**ref, k=8, tie_break=True)
    got = score_topk(**dict(port, gates=full), k=8, tie_break=True)
    base = score_topk(**dict(port, gates=none), k=8, tie_break=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    val = got[0]
    assert bool(((val >= 0) & (val < 0.5)).any())
    np.testing.assert_array_equal((val >= 0).sum(dim=1).numpy(),
                                  (base[0] >= 0).sum(dim=1).numpy())


# --- schedule_batch -----------------------------------------------------


def _builder_case(nodes, pods):
    """(snapshot, batch) from the reference's SnapshotBuilder: each node
    with a fresh metric (its usage or none), the pods."""
    from koordinator_tpu.api.types import NodeMetric
    from koordinator_tpu.snapshot.builder import SnapshotBuilder
    from test_scheduler_core import NOW
    b = SnapshotBuilder(max_nodes=len(nodes))
    for node, usage in nodes:
        b.add_node(node)
        b.set_node_metric(NodeMetric(node_name=node.meta.name,
                                     update_time=NOW, node_usage=usage))
    snap, ctx = b.build(now=NOW)
    return snap, b.build_pod_batch(pods, ctx)


def _taint_scenarios():
    """tests/test_scheduler_core.py:246-339: NoSchedule rejects, a
    toleration admits, PreferNoSchedule only demotes (three nodes, and
    the tainted node alone), a busy soft-tainted node still chosen when
    it is the only one, and the blanket (empty-key) toleration passing
    every taint."""
    from koordinator_tpu.api.types import Node, ObjectMeta, Pod, Taint, \
        Toleration

    def node(name, *taints):
        return Node(meta=ObjectMeta(name=name),
                    allocatable={RK.CPU: 8000, RK.MEMORY: 16384},
                    taints=list(taints))

    hard = Taint(key="gpu", value="true", effect="NoSchedule")
    soft = Taint(key="maint", value="", effect="PreferNoSchedule")

    def pod(name, *tolerations):
        return Pod(meta=ObjectMeta(name=name), priority=9000,
                   requests={RK.CPU: 100.0}, tolerations=list(tolerations))

    return {
        "filter_and_prefer": (
            [(node("tainted", hard), {}), (node("soft", soft), {}),
             (node("clean"), {})],
            [pod("plain"), pod("tolerant", Toleration(
                key="gpu", value="true", effect="NoSchedule"))]),
        "tainted_only": (
            [(node("tainted", hard), {})],
            [pod("plain"), pod("tolerant", Toleration(key="gpu"))]),
        "prefer_demotes_never_filters": (
            [(node("soft", Taint(key="maint", effect="PreferNoSchedule")),
              {RK.CPU: 5000.0, RK.MEMORY: 10000.0})],
            [pod("p")]),
        "blanket_toleration": (
            [(node("a", Taint(key="any", value="x", effect="NoSchedule")),
              {}), (node("b", hard, soft), {})],
            [pod("critical", Toleration()), pod("plain")]),
    }


# what the reference's own tests assert: pod row -> node (-1 rejected)
TAINT_PLACEMENTS = {
    "filter_and_prefer": {0: 2},
    "tainted_only": {0: -1, 1: 0},
    "prefer_demotes_never_filters": {0: 0},
    "blanket_toleration": {1: -1},
}


@pytest.mark.parametrize("name", sorted(TAINT_PLACEMENTS))
def test_taint_scenarios_equal_reference(name):
    """Each scenario through both packages with the reference's defaults:
    every result field and the post-batch snapshot equal, and the
    placements the reference's own tests assert."""
    snap, batch = _builder_case(*_taint_scenarios()[name])
    assert batch.has_taints
    want = jcore.schedule_batch(snap, batch, JCfg.make())
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", batch),
                              LoadAwareConfig.make(device="cpu"))
    assert_results_equal(want, got)
    for row, node in TAINT_PLACEMENTS[name].items():
        assert int(got.assignment[row]) == node, (name, row)
    if name == "blanket_toleration":
        assert int(got.assignment[0]) >= 0


@pytest.mark.parametrize("kw", ["gpu_share", "slim"])
def test_full_gate_taints_without_slots_equal_reference(kw):
    """One batch of the full-gate workload without slots (taints, NUMA,
    GPU instances, pod topology groups) under gpu_share's sweep
    arguments and under the
    slim flagship's: every field equal (the tail's arguments run in
    tests/test_torch_configs.py's sweep and tail)."""
    kwargs = {"gpu_share": configs.GPU_SHARE_KW,
              "slim": dict(configs.GPU_SHARE_KW, enable_numa=False,
                           enable_devices=False)}[kw]
    snap = jsyn.full_gate_cluster(200, seed=2, num_reservations=0)
    pods = jsyn.full_gate_pods(800, 200, seed=3)
    pods = pods.replace(reservation_owner=jnp.full((800,), -1, jnp.int32))
    want = jcore.schedule_batch(snap, pods, JCfg.make(), **kwargs)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", pods),
                              LoadAwareConfig.make(device="cpu"), **kwargs)
    assert_results_equal(want, got)
    placed = np.asarray(want.assignment) >= 0
    taint = np.asarray(snap.nodes.taint_group)[
        np.asarray(want.assignment)[placed]]
    assert placed.any() and (taint > 0).any()
