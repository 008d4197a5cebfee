"""The port's BASELINE config 2 (configs.run_config_2_numa, the NUMA
path) against the JAX composition bench_configs.config_2_numa runs:
core.schedule_batch(enable_numa=True) in lax.scan over the pod chunks,
with the bench's arguments, at a cut size; and gpu_share_100kx10k
(configs.run_gpu_share, the DeviceShare path with taints, slots and the
pod topology families) against the reference's sweep and straggler tail
with the full-gate knobs and bench.py's count threading, at a cut size
and two seeds (the reference's jitted steps driven from the host:
`torch_port_ref.reference_sweep_and_tail`). Tolerances: none."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch import configs, flagship
from koordinator_tpu_torch.scheduler.core import overcommit_ok, quota_ok
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig

from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)
from torch_port_ref import reference_sweep_and_tail, to_port

PODS, NODES, CHUNK = 1200, 80, 400


def reference_config_2():
    """bench_configs.config_2_numa's inputs and sweep at PODS x NODES."""
    snap = jsyn.with_two_numa_zones(
        jsyn.synthetic_cluster(NODES, num_quotas=32, seed=0))
    pods = jsyn.synthetic_pods(PODS, seed=1, prod_frac=0.6, num_quotas=32)
    pods = pods.replace(numa_single=jnp.asarray(
        np.asarray(pods.priority_class) == 4))
    step = functools.partial(jcore.schedule_batch, **configs.CONFIG_2_KW)

    @jax.jit
    def sweep(snap, stacked, pods, cfg):
        def body(s, cols):
            res = step(s, pods.replace(**cols), cfg)
            return res.snapshot, (res.assignment, res.numa_zone,
                                  res.numa_take)
        return jax.lax.scan(body, snap, stacked)

    snap, (assign, zone, take) = sweep(
        snap, jsyn.stack_pod_chunks(pods, CHUNK), pods, JCfg.make())
    return (snap, np.asarray(assign).reshape(-1),
            np.asarray(zone).reshape(-1),
            np.asarray(take).reshape(PODS, *np.asarray(take).shape[2:]))


@functools.lru_cache(maxsize=None)
def _both():
    want = reference_config_2()
    line, run = configs.run_config_2_numa(PODS, NODES, CHUNK, device="cpu")
    return want, line, run


@pytest.mark.parametrize("field", ["assignment", "numa_zone", "numa_take"])
def test_sweep_results_equal(field):
    (_, *want), _, run = _both()
    w = dict(zip(("assignment", "numa_zone", "numa_take"), want))[field]
    g = getattr(run, field).numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("part,field", [
    ("nodes", "requested"), ("nodes", "numa_free"), ("quotas", "used"),
    ("nodes", "assigned_estimated")])
def test_final_snapshot_equal(part, field):
    (want_snap, *_), _, run = _both()
    w = np.asarray(getattr(getattr(want_snap, part), field))
    g = getattr(getattr(run.snapshot, part), field).numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()


def test_final_snapshot_sound():
    _, line, run = _both()
    snap = run.snapshot
    assert overcommit_ok(snap) and quota_ok(snap)
    used = (snap.nodes.numa_cap - snap.nodes.numa_free).numpy()
    assert (used >= 0).all()
    assert line["metric"] == configs.CONFIG_2_METRIC
    assert line["platform"] == "cpu" and line["num_pods"] == PODS
    assert line["placed"] == int((run.assignment >= 0).sum()) > 0
    assert 0 < line["numa_bound_placed"] <= line["placed"]


# --- gpu_share_100kx10k (configs.run_gpu_share, the DeviceShare path) ----

GPU_PODS, GPU_NODES, GPU_CHUNK = 1200, 300, 600


def gpu_share_reference_inputs(snap_seed, pod_seed):
    """The gpu_share cluster and pods at GPU_PODS x GPU_NODES from the
    reference's generators (utils.synthetic.gpu_share_inputs' calls:
    full_gate_cluster and full_gate_pods)."""
    return (jsyn.full_gate_cluster(GPU_NODES, seed=snap_seed),
            jsyn.full_gate_pods(GPU_PODS, GPU_NODES, seed=pod_seed))


@functools.lru_cache(maxsize=None)
def _gpu_share_both(snap_seed, pod_seed):
    """(reference (snap, assign, stats, the sweep's res_slot, the final
    counts), port run, port line or None): the config's own seeds (0, 1)
    through run_gpu_share, others through flagship.sweep_and_tail with
    the config's kwargs."""
    snap, pods = gpu_share_reference_inputs(snap_seed, pod_seed)
    want_snap, counts, assign, stats, sweep_slot = reference_sweep_and_tail(
        functools.partial(jcore.schedule_batch, **configs.GPU_SHARE_KW),
        functools.partial(jcore.schedule_batch, **configs.GPU_SHARE_TAIL_KW),
        snap, pods, JCfg.make(), GPU_CHUNK, tail_chunk=min(GPU_CHUNK, 512),
        min_passes=flagship.MIN_TAIL_PASSES,
        max_passes=configs.FULL_GATE_MAX_TAIL_PASSES)
    want = (want_snap, assign, stats, sweep_slot, counts)
    if (snap_seed, pod_seed) == (0, 1):
        line, run = configs.run_gpu_share(GPU_PODS, GPU_NODES, GPU_CHUNK,
                                          device="cpu")
        return want, run, line
    run = flagship.sweep_and_tail(
        to_port("ClusterSnapshot", snap), to_port("PodBatch", pods),
        LoadAwareConfig.make(device="cpu"), GPU_CHUNK,
        step_kw=configs.GPU_SHARE_KW, tail_kw=configs.GPU_SHARE_TAIL_KW,
        max_passes=configs.FULL_GATE_MAX_TAIL_PASSES)
    return want, run, None


GPU_SEEDS = [(0, 1), (3, 4)]


@pytest.mark.parametrize("seeds", GPU_SEEDS, ids=str)
def test_gpu_share_sweep_and_tail_equal_reference(seeds):
    """The assignment and the tail's stats equal the reference's
    sweep-and-tail at a cut size (full width, no packing prefixes)."""
    (_, want_assign, want_stats, *_), run, _ = _gpu_share_both(*seeds)
    np.testing.assert_array_equal(run.assignment.numpy(), want_assign)
    np.testing.assert_array_equal(run.stats.numpy(), want_stats)
    assert want_stats[0] > 0 and want_stats[2] == 0


@pytest.mark.parametrize("part,field", [
    ("nodes", "requested"), ("nodes", "numa_free"), ("devices", "gpu_free"),
    ("quotas", "used"), ("gangs", "assumed"),
    ("nodes", "assigned_estimated"), ("nodes", "prod_assigned_estimated"),
    ("reservations", "free"), ("reservations", "valid"),
    ("reservations", "gpu_free"), ("reservations", "numa_free")])
@pytest.mark.parametrize("seeds", GPU_SEEDS, ids=str)
def test_gpu_share_final_snapshot_equal(seeds, part, field):
    (want_snap, *_), run, _ = _gpu_share_both(*seeds)
    w = np.asarray(getattr(getattr(want_snap, part), field))
    g = getattr(getattr(run.snapshot, part), field).numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("seeds", GPU_SEEDS, ids=str)
def test_gpu_share_instances_conserved(seeds):
    """Each placed GPU pod holds `count` instances of its node; the
    takes times each pod's per-instance request at its node equal the
    instance total minus the final free on every valid instance, and
    no free is negative; the run's line counts what it placed."""
    from koordinator_tpu_torch.scheduler.plugins import deviceshare
    snap0, pods = gpu_share_reference_inputs(*seeds)
    _, run, line = _gpu_share_both(*seeds)
    dev0 = to_port("DeviceState", snap0.devices)
    tpods = to_port("PodBatch", pods)
    assign, take = run.assignment, run.gpu_take
    count, per = deviceshare.per_instance_at(
        dev0, deviceshare.gpu_request(tpods.requests, tpods.gpu_ratio),
        assign)
    placed = assign >= 0
    assert torch.equal(take.sum(dim=1), torch.where(placed, count, 0))
    n, i, _ = dev0.gpu_free.shape
    used = torch.zeros((n + 1, i, 3)).index_add_(
        0, torch.where(placed, assign, n).long(),
        take[:, :, None] * per[:, None, :])[:n]
    free = run.snapshot.devices.gpu_free
    valid = dev0.gpu_valid[:, :, None]
    assert torch.equal((dev0.gpu_free - free) * valid, used * valid)
    assert bool((free >= 0).all()) and int(take.sum()) > 0
    assert overcommit_ok(run.snapshot) and quota_ok(run.snapshot)
    if line is not None:
        gpu = deviceshare.has_gpu_request(tpods.requests, tpods.gpu_ratio)
        assert line["metric"] == configs.GPU_SHARE_METRIC
        assert line["placed"] == int(placed.sum()) > 0
        assert line["gpu_pods_placed"] == int((placed & gpu).sum()) > 0
        assert 0 < line["numa_bound_placed"] <= line["placed"]
        assert line["tail_passes"] >= flagship.MIN_TAIL_PASSES


@pytest.mark.parametrize("seeds", GPU_SEEDS, ids=str)
def test_gpu_share_slot_consumers(seeds):
    """The port's carried res_slot agrees with the reference's sweep
    where the tail did not place the pod, and the tail places some
    consumers; every consumer sits on its
    slot's node and owns it; each slot's final free (the reference's)
    is its initial free less its consumers' requests; an AllocateOnce
    slot has at most one consumer; the line counts them."""
    (want_snap, assign, _, sweep_slot, _), run, line = \
        _gpu_share_both(*seeds)
    snap, pods = gpu_share_reference_inputs(*seeds)
    res_slot = run.res_slot.numpy()
    consumer = res_slot >= 0
    swept = sweep_slot >= 0
    np.testing.assert_array_equal(res_slot[swept], sweep_slot[swept])
    resv0 = snap.reservations
    assert consumer.any() and (assign[consumer] >= 0).all()
    assert (consumer & ~swept).any()
    np.testing.assert_array_equal(
        np.asarray(pods.reservation_owner)[consumer],
        np.asarray(resv0.owner_group)[res_slot[consumer]])
    np.testing.assert_array_equal(
        assign[consumer], np.asarray(resv0.node)[res_slot[consumer]])
    consumed = np.zeros_like(np.asarray(resv0.free))
    np.add.at(consumed, res_slot[consumer],
              np.asarray(pods.requests)[consumer])
    np.testing.assert_array_equal(np.asarray(want_snap.reservations.free),
                                  np.asarray(resv0.free) - consumed)
    once = np.asarray(resv0.allocate_once)
    per_slot = np.bincount(res_slot[consumer], minlength=once.size)
    assert per_slot[once].max() <= 1
    if line is not None:
        assert line["cuts"] == list(configs.GPU_SHARE_CUTS)
        assert line["slot_consumers"] == int(consumer.sum())
        assert line["once_slots_taken"] == int((once & (per_slot > 0)).sum())


@pytest.mark.parametrize("seeds", GPU_SEEDS, ids=str)
def test_gpu_share_taints_hold(seeds):
    """No pod sits on a node whose taints its toleration set forbids,
    and some sit on tainted nodes their sets tolerate."""
    (_, assign, *_), _, _ = _gpu_share_both(*seeds)
    snap, pods = gpu_share_reference_inputs(*seeds)
    placed = assign >= 0
    tol = np.asarray(pods.toleration_id)[placed]
    taint = np.asarray(snap.nodes.taint_group)[assign[placed]]
    assert not np.asarray(pods.tol_forbid)[tol, taint].any()
    assert (taint > 0).any()


@pytest.mark.parametrize("seeds", GPU_SEEDS, ids=str)
def test_gpu_share_topology_counts_equal(seeds):
    """The (group x domain) counts the port threads through the chunks
    and the tail passes equal the reference's bit for bit, and equal
    the counts recounted from the final assignment (the workload's
    count0 are zero)."""
    from koordinator_tpu_torch.scheduler.domains import (
        COUNT_FIELDS,
        charge_all_counts,
    )
    (*_, want_counts), run, _ = _gpu_share_both(*seeds)
    _, pods = gpu_share_reference_inputs(*seeds)
    tpods = to_port("PodBatch", pods)
    recount = charge_all_counts(
        tuple(torch.zeros_like(getattr(tpods, f)) for f in COUNT_FIELDS),
        tpods, run.assignment)
    for got, want, again in zip(run.counts, want_counts, recount):
        assert got.numpy().tobytes() == want.tobytes()
        assert torch.equal(got, again)
    assert all(float(c.sum()) > 0 for c in run.counts)


@pytest.mark.parametrize("seeds", GPU_SEEDS, ids=str)
def test_gpu_share_topology_holds(seeds):
    """On the final placement: no node holds two carriers of one
    anti-affinity group; each hard spread group's skew over its zones
    is within its bound; each affinity group sits in one zone, and each
    dual pair in the same one; the line counts the placed pods of each
    family."""
    (_, assign, *_), _, line = _gpu_share_both(*seeds)
    _, pods = gpu_share_reference_inputs(*seeds)
    placed = assign >= 0
    carrier = np.asarray(pods.anti_carrier) & placed[:, None]
    for g in range(carrier.shape[1]):
        nodes = assign[carrier[:, g]]
        assert len(nodes) == len(set(nodes.tolist()))
    dom = np.asarray(pods.spread_domain)
    member = np.asarray(pods.spread_member) & placed[:, None]
    skew = np.asarray(pods.spread_max_skew)
    dvalid = np.asarray(pods.spread_dvalid)
    for g in range(member.shape[1]):
        cnt = np.bincount(dom[g, assign[member[:, g]]],
                          minlength=dvalid.shape[1])[dvalid[g]]
        assert cnt.max() - cnt.min() <= skew[g] + 0.5
    aff = np.asarray(pods.aff_member) & placed[:, None]
    zone = np.asarray(pods.aff_domain)
    zones = [set(zone[g, assign[aff[:, g]]].tolist())
             for g in range(aff.shape[1])]
    assert all(len(z) <= 1 for z in zones) and any(zones)
    for g in range(1, len(zones), 2):
        assert not zones[g] or zones[g] == zones[g - 1]
    if line is not None:
        for fam in ("spread", "anti", "aff"):
            want = int((placed & np.asarray(
                getattr(pods, f"{fam}_carrier")).any(axis=1)).sum())
            assert line[f"{fam}_placed"] == want > 0
