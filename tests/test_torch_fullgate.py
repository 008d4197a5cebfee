"""The port's full-gate flagship (`configs.run_full_gate`,
`score_bind_100k_pods_10k_nodes_full_gate`) against the JAX package: the
numpy packers (`utils.synthetic.pack_gate_prefixes`,
`topo_constrained_mask`, `dom_classes`) against the reference's, the
set-up's checks, the addend row counts of K1, K4 and K6 (their plain
versions) against the full-row forms, and the packed sweep and budgeted
tail at a cut size against the reference's bench composition
(bench.py:226-253, :398-416, :483-496: schedule_batch over the chunks
with the cascade and the three prefixes, then the straggler tail with
the topology budget), its jitted steps driven here from the host
(`torch_port_ref.reference_sweep_and_tail`) rather than through
bench.py's scan.

Tolerances: none."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch import configs, flagship
from koordinator_tpu_torch.bridge import to_numpy
from koordinator_tpu_torch.kernels.device_terms import device_pair_terms
from koordinator_tpu_torch.kernels.numa_terms import numa_pair_terms
from koordinator_tpu_torch.kernels.score_topk import score_topk
from koordinator_tpu_torch.scheduler import cascade
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.scheduler.core import overcommit_ok, quota_ok
from koordinator_tpu_torch.scheduler.domains import COUNT_FIELDS
from koordinator_tpu_torch.scheduler.plugins import deviceshare, loadaware
from koordinator_tpu_torch.scheduler.plugins import numaaware
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.snapshot.schema import PER_POD_FIELDS
from koordinator_tpu_torch.utils import synthetic

from torch_port_ref import (
    assert_trees_equal,
    numpy_tree,
    reference_sweep_and_tail,
)
from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)

# --- the packers ----------------------------------------------------------


@pytest.mark.parametrize("pods,nodes,chunk", [(4000, 200, 2000),
                                              (1200, 300, 600)])
def test_packers_equal_reference(pods, nodes, chunk):
    """pack_gate_prefixes (the packed pods, prefixes and masks, the
    permutation included), pack_topo_prefix, topo_constrained_mask and
    dom_classes array-equal to the reference's on the full-gate pods."""
    jpods = jsyn.full_gate_pods(pods, nodes, seed=1)
    tpods = synthetic.full_gate_pods(pods, nodes, seed=1, device="cpu")
    np.testing.assert_array_equal(synthetic.topo_constrained_mask(tpods),
                                  jsyn.topo_constrained_mask(jpods))
    w_packed, w_pref, w_masks = jsyn.pack_gate_prefixes(jpods, chunk)
    g_packed, g_pref, g_masks = synthetic.pack_gate_prefixes(tpods, chunk)
    assert g_pref == w_pref
    assert set(g_masks) == set(w_masks)
    for k in w_masks:
        np.testing.assert_array_equal(g_masks[k], w_masks[k], err_msg=k)
    assert_trees_equal(to_numpy(g_packed), numpy_tree(w_packed))
    assert synthetic.dom_classes(g_packed) == jsyn.dom_classes(w_packed)
    packed, topo, mask = synthetic.pack_topo_prefix(tpods, chunk)
    w_topo = jsyn.pack_topo_prefix(jpods, chunk)
    assert topo == w_topo[1]
    np.testing.assert_array_equal(mask, w_topo[2])
    assert 0 < g_pref["topo"] <= g_pref["numa"] <= g_pref["gpu"] <= chunk


def test_prefix_escape_raises():
    """A class pod beyond its prefix in some chunk raises."""
    tpods = synthetic.full_gate_pods(1200, 300, seed=1, device="cpu")
    _, prefixes, masks = synthetic.pack_gate_prefixes(tpods, 600)
    synthetic.check_gate_prefixes(masks, prefixes, 600)
    for key in ("topo", "numa", "gpu"):
        worst = max(int(masks[key][s:s + 600].sum())
                    for s in range(0, 1200, 600))
        short = dict(prefixes, **{key: worst - 1})
        with pytest.raises(ValueError, match=f"{key} pod escaped"):
            synthetic.check_gate_prefixes(masks, short, 600)
    with pytest.raises(ValueError, match="divisible"):
        synthetic.pack_gate_prefixes(tpods, 700)


def test_full_gate_setup_refuses_policy_nodes():
    """The numa prefix needs a snapshot without topology-manager
    policies (bench.py:346-355): pack_full_gate raises on one policy
    node and otherwise adds the prefixes to the kwargs."""
    snap, pods = synthetic.gpu_share_inputs(1200, 300, device="cpu")
    packed, prefixes, masks, step_kw, tail_kw = configs.pack_full_gate(
        snap, pods, 600)
    assert step_kw["cascade"] and tail_kw["cascade"]
    assert (step_kw["topo_prefix"], step_kw["numa_prefix"],
            step_kw["gpu_prefix"]) == (prefixes["topo"], prefixes["numa"],
                                       prefixes["gpu"])
    assert tail_kw["topo_prefix"] == prefixes["topo"]
    assert tail_kw["numa_prefix"] is None and tail_kw["gpu_prefix"] is None
    assert tail_kw["dom_classes"] == step_kw["dom_classes"]
    assert (tail_kw["num_rounds"], tail_kw["k_choices"]) == (4, 32)
    policy = snap.nodes.numa_policy.clone()
    policy[7] = 1
    bad = snap.replace(nodes=snap.nodes.replace(numa_policy=policy))
    with pytest.raises(ValueError, match="policy-free"):
        configs.pack_full_gate(bad, pods, 600)


# --- K1, K4 and K6 with addend row counts ---------------------------------


@functools.lru_cache(maxsize=None)
def _gpu_chunk():
    snap, pods = synthetic.gpu_share_inputs(800, 120, device="cpu")
    return snap, synthetic.slice_batch(pods, 0, 400)


@pytest.mark.parametrize("rows", [0, 96, 250, 400])
def test_k4_k6_rows_equal_full_rows(rows):
    """K4 and K6 (plain versions) on the first `rows` pods with a given
    pair mask: the mask's first rows ANDed with the full-row terms, the
    rows beyond untouched; the addends the full-row addends' first
    rows."""
    snap, pods = _gpu_chunk()
    nodes, devices = snap.nodes, snap.devices
    demand = numaaware.zone_demand(pods)
    numa_args = (nodes.numa_cap, nodes.numa_free, nodes.numa_valid,
                 nodes.numa_policy, "most")
    gpu_req = deviceshare.gpu_request(pods.requests,
                                      pods.gpu_ratio).contiguous()
    gen = torch.Generator().manual_seed(rows)
    mask = torch.rand((pods.num_pods, nodes.num_nodes), generator=gen) < 0.8
    full_ok, full_score = numa_pair_terms(demand, pods.numa_single,
                                          *numa_args)
    ok, score = numa_pair_terms(demand[:rows], pods.numa_single[:rows],
                                *numa_args, mask.clone())
    assert torch.equal(ok[:rows], mask[:rows] & full_ok[:rows])
    assert torch.equal(ok[rows:], mask[rows:])
    assert torch.equal(score, full_score[:rows])
    full_ok, full_score = device_pair_terms(gpu_req, devices, "least")
    ok, score = device_pair_terms(gpu_req[:rows], devices, "least",
                                  mask.clone())
    assert torch.equal(ok[:rows], mask[:rows] & full_ok[:rows])
    assert torch.equal(ok[rows:], mask[rows:])
    assert torch.equal(score, full_score[:rows])


@pytest.mark.parametrize("rows1,rows2", [(0, 0), (96, 250), (250, 96),
                                         (400, 0), (0, 400), (400, 400)])
def test_k1_addend_rows_equal_zero_padded(rows1, rows2):
    """K1's plain selection with addends of fewer rows than the batch
    equals the selection with the addends padded with zero rows (the
    reference's concatenation), values and indices."""
    snap, pods = _gpu_chunk()
    nodes = snap.nodes
    cfg = LoadAwareConfig.make(device="cpu")
    gates = cascade.static_gate_terms(nodes, pods, cfg, snap.devices)
    p, n = pods.num_pods, nodes.num_nodes
    gen = torch.Generator().manual_seed(rows1 * 7 + rows2)
    a1 = torch.floor(torch.rand((rows1, n), generator=gen) * 100.0)
    a2 = torch.floor(torch.rand((rows2, n), generator=gen) * 100.0)
    fd = [0, 1, 2, 3]
    node_term, prod_term, alloc_score, weights = loadaware.score_terms(
        nodes, cfg, (0, 1))
    args = (gates, None, pods.valid, pods.requests[:, fd].contiguous(),
            nodes.requested[:, fd].contiguous(),
            nodes.allocatable[:, fd].contiguous(),
            pods.estimated[:, [0, 1]].contiguous(),
            loadaware.prod_scored(pods, cfg), node_term, prod_term,
            alloc_score, weights, 8, True, EPS, True)

    def pad(a):
        return torch.cat([a, torch.zeros((p - a.shape[0], n))])

    got = score_topk(*args, pair_score=a1, pair_score2=a2)
    want = score_topk(*args, pair_score=pad(a1), pair_score2=pad(a2))
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    with pytest.raises(ValueError, match="rows"):
        score_topk(*args, pair_score=torch.zeros((p + 1, n)))


# --- the full-gate sweep and tail at a cut size ---------------------------

PODS, NODES, CHUNK = 1200, 120, 400


@functools.lru_cache(maxsize=None)
def _reference_full_gate():
    """bench.py run_northstar(full_gate=True)'s sweep and device tail at
    PODS x NODES, chunks of CHUNK: the pods packed, schedule_batch with
    the cascade, the three prefixes and the domain classes over the
    chunks with bench.py's count threading, then the tail with the
    tail's knobs (no numa/gpu prefix) and the topology budget; the
    reference's jitted steps driven from the host
    (`torch_port_ref.reference_sweep_and_tail`)."""
    snap = jsyn.full_gate_cluster(NODES, seed=0)
    pods = jsyn.full_gate_pods(PODS, NODES, seed=1)
    assert not np.asarray(snap.nodes.numa_policy).any()
    pods, prefixes, masks = jsyn.pack_gate_prefixes(pods, CHUNK)
    contracts = dict(topo_prefix=prefixes["topo"],
                     dom_classes=jsyn.dom_classes(pods))
    step = functools.partial(jcore.schedule_batch, **configs.FULL_GATE_KW,
                             numa_prefix=prefixes["numa"],
                             gpu_prefix=prefixes["gpu"], **contracts)
    tail_step = functools.partial(jcore.schedule_batch,
                                  **configs.FULL_GATE_TAIL_KW, **contracts)
    w_snap, w_counts, w_assign, w_stats, _ = reference_sweep_and_tail(
        step, tail_step, snap, pods, JCfg.make(), CHUNK,
        tail_chunk=min(CHUNK, 512), min_passes=flagship.MIN_TAIL_PASSES,
        max_passes=configs.FULL_GATE_MAX_TAIL_PASSES,
        topo_prefix=prefixes["topo"], topo_mask=jnp.asarray(masks["topo"]))
    return w_snap, w_counts, w_assign, w_stats, prefixes


@functools.lru_cache(maxsize=None)
def _port_full_gate():
    return configs.run_full_gate(PODS, NODES, CHUNK, device="cpu")


def test_full_gate_sweep_and_tail_equal_reference():
    """configs.run_full_gate on the host: prefixes, assignment, tail
    stats, the final snapshot and the carried counts equal to the
    reference's composition; the tail ran its budget on constrained
    stragglers."""
    w_snap, w_counts, w_assign, w_stats, w_pref = _reference_full_gate()
    line, run, setup = _port_full_gate()
    assert setup["prefixes"] == w_pref
    assert setup["prefixes"]["numa"] < CHUNK
    np.testing.assert_array_equal(run.assignment.numpy(), w_assign)
    np.testing.assert_array_equal(run.stats.numpy(), w_stats)
    assert_trees_equal(to_numpy(run.snapshot), numpy_tree(w_snap))
    for f, got, want in zip(COUNT_FIELDS, run.counts, w_counts):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    assert w_stats[0] > 0 and w_stats[2] == 0
    mask = setup["masks"]["topo"]
    assert (mask & (w_assign < 0)).sum() < (mask & (w_assign >= 0)).sum()


def test_full_gate_line_and_invariants():
    """The line's fields and the run's invariants: no overcommit, quota
    within runtime, the placed counts of each class, the prefixes."""
    line, run, setup = _port_full_gate()
    pods = setup["pods"]
    assert line["metric"] == configs.FULL_GATE_METRIC
    assert line["platform"] == "cpu" and line["cascade"]
    assert [line[f"{k}_prefix"] for k in ("topo", "numa", "gpu")] == [
        setup["prefixes"][k] for k in ("topo", "numa", "gpu")]
    assert overcommit_ok(run.snapshot) and quota_ok(run.snapshot)
    placed = run.assignment >= 0
    assert line["placed"] == int(placed.sum()) > 0
    assert 0 < line["gpu_pods_placed"] and 0 < line["numa_bound_placed"]
    assert line["slot_consumers"] == int((run.res_slot >= 0).sum())
    for fam in ("spread", "anti", "aff"):
        assert line[f"{fam}_placed"] == int(
            (placed & getattr(pods, f"{fam}_carrier").any(dim=1)).sum())
    # the packed pods are the workload's, reordered within each chunk
    _, raw = synthetic.gpu_share_inputs(PODS, NODES, device="cpu")
    perm = torch.from_numpy(setup["masks"]["perm"])
    for f in PER_POD_FIELDS:
        assert torch.equal(getattr(pods, f), getattr(raw, f)[perm]), f
