"""The aux (RDMA/FPGA) instance pools (ROADMAP B8's rest) and
`approx_topk` (B22) in the port against the JAX package:

- tests/test_deviceshare.py's VF fragmentation cluster (one node, two
  RDMA VFs, no GPU), through the reference's SnapshotBuilder;
- `choose_aux_instance` and kernel K17's wrapper (its plain version on
  the host) on ties, empty and invalid pools, under both strategies;
- K6's aux part (`device_pair_terms` with `aux_req`) against the
  reference's `prefilter`;
- a full-gate batch with `utils.synthetic.aux_pools` applied to both
  packages' inputs as the same numpy arrays (J = 8; the cascade on and
  off, "least" and "most"), forget of its result, a topology delta at
  J = 8, and `approx_topk=True`;
- `configs.run_full_gate(aux=True)` at a cut size, held by the aux
  invariants.

Tolerances: none. Every field is compared bit for bit."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.api.extension import ResourceKind as JRK
from koordinator_tpu.api.types import ObjectMeta, Pod
from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler.plugins import deviceshare as jdeviceshare
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.snapshot import delta as jdelta
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch import configs
from koordinator_tpu_torch.kernels.aux_instances import aux_instance_pick
from koordinator_tpu_torch.kernels.device_terms import device_pair_terms
from koordinator_tpu_torch.scheduler import core
from koordinator_tpu_torch.scheduler.plugins import deviceshare
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.snapshot import delta
from koordinator_tpu_torch.utils import synthetic

from test_deviceshare import CPU, MEM, RD, make_builder
from test_torch_delta import port_ref

from torch_port_ref import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_bits_equal,
    one_torch_thread,
    ref_tree,
    to_port,
    tree,
)

AUX_COLS = [int(JRK.RDMA), int(JRK.FPGA)]
NODES, PODS, CHUNK = 128, 1024, 512


def _both(snap, pods, **kw):
    """(reference result, port result) of one batch with `kw`."""
    want = jcore.schedule_batch(snap, pods, JCfg.make(), **kw)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", pods),
                              LoadAwareConfig.make(device="cpu"), **kw)
    return want, got


def test_rdma_vf_fragmentation_equals_reference():
    """tests/test_deviceshare.py:257's cluster (one node, two RDMA VFs of
    100, no GPU instance) and its three 60-percent pods: every result
    field and the snapshot equal the reference's; the first two pods
    take one VF each and the third finds no room."""
    b = make_builder(num_nodes=1, gpus=0, aux=2)
    pods = [Pod(meta=ObjectMeta(name=f"p{i}"),
                requests={CPU: 1000.0, MEM: 1000.0, RD: 60.0},
                priority=9000 - i) for i in range(3)]
    snap, ctx = b.build(now=1e9)
    want, got = _both(snap, b.build_pod_batch(pods, ctx), num_rounds=3,
                      k_choices=4)
    assert_bits_equal(tree(got), ref_tree(want))
    assert (got.assignment >= 0).tolist() == [True, True, False]
    assert sorted(got.aux_inst[:2, 0].tolist()) == [0, 1]


def _pick_case(strategy_seed, j=5):
    """Live free with ties (equal free on several instances), invalid
    instances, a node with no valid instance, zero and oversize
    requests, choices out of range (clamped); j instances a pool."""
    rng = np.random.default_rng(strategy_seed)
    n, p = 6, 64
    free = rng.choice(np.asarray([0.0, 25.0, 50.0, 100.0], np.float32),
                      size=(n, 2, j))
    valid = rng.uniform(size=(n, 2, j)) < 0.8
    valid[2] = False                                    # an empty node
    free[3, 0] = 50.0                                   # every VF ties
    choice = rng.integers(-2, n + 2, p).astype(np.int32)
    req = rng.choice(np.asarray([0.0, 25.0, 50.0, 60.0, 100.0, 150.0],
                                np.float32), size=(p, 2))
    return free, valid, choice, req


@pytest.mark.parametrize("strategy", ["least", "most"])
@pytest.mark.parametrize("seed", [0, 1])
def test_aux_instance_pick_equals_reference(strategy, seed):
    """K17's wrapper on the host (its plain version) and
    `choose_aux_instance` against the reference's chooser, pool by pool:
    instances and ok equal on ties (the first index), empty pools,
    invalid instances, zero and oversize requests."""
    _pick_equals_reference(strategy, seed, 5)


@pytest.mark.parametrize("strategy", ["least", "most"])
def test_aux_instance_pick_at_64_vfs_equals_reference(strategy):
    """The same at 64 VFs a pool (a node with several SR-IOV NICs; fault
    C8's width)."""
    _pick_equals_reference(strategy, 0, 64)


def _pick_equals_reference(strategy, seed, j):
    free, valid, choice, req = _pick_case(seed, j)
    jdev = jsyn.synthetic_cluster(free.shape[0]).devices.replace(
        aux_free=jnp.asarray(free), aux_valid=jnp.asarray(valid))
    tdev = to_port("DeviceState", jdev)
    inst, ok = aux_instance_pick(torch.from_numpy(choice),
                                 torch.from_numpy(req), tdev.aux_free, tdev,
                                 strategy)
    for t in range(2):
        w_inst, w_ok = jdeviceshare.choose_aux_instance(
            jnp.asarray(free), jdev, jnp.asarray(choice), t,
            jnp.asarray(req[:, t]), strategy)
        g_inst, g_ok = deviceshare.choose_aux_instance(
            tdev.aux_free, tdev, torch.from_numpy(choice), t,
            torch.from_numpy(req[:, t]), strategy)
        for g, w in ((inst[:, t], w_inst), (ok[:, t], w_ok),
                     (g_inst, w_inst), (g_ok, w_ok)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (~ok).any() and ok.any()
    node = np.clip(choice, 0, free.shape[0] - 1)
    tie = (node == 3) & (req[:, 0] > 0) & (req[:, 0] <= 50.0)
    assert tie.any() and (inst[torch.from_numpy(tie), 0] == 0).all()


def test_aux_instance_pick_checks_its_inputs():
    free, valid, choice, req = _pick_case(0)
    tdev = to_port("DeviceState", jsyn.synthetic_cluster(
        free.shape[0]).devices.replace(aux_free=jnp.asarray(free),
                                       aux_valid=jnp.asarray(valid)))
    args = (torch.from_numpy(choice), torch.from_numpy(req), tdev.aux_free,
            tdev)
    with pytest.raises(ValueError, match="strategy"):
        aux_instance_pick(*args, "spread")
    with pytest.raises(TypeError, match="req"):
        aux_instance_pick(args[0], args[1].double(), *args[2:], "least")
    with pytest.raises(ValueError, match="no instance"):
        empty = tdev.replace(aux_free=torch.zeros((6, 2, 0)),
                             aux_valid=torch.zeros((6, 2, 0), dtype=bool))
        aux_instance_pick(args[0], args[1], empty.aux_free, empty, "least")


@functools.lru_cache(maxsize=None)
def _aux_inputs(gpu_frac=0.25, j=synthetic.AUX_INSTANCES):
    """The full gate's cluster and pods at NODES x PODS with
    `synthetic.aux_pools` (j VFs a GPU node) applied to the reference's
    inputs (the same numpy arrays the port's `with_aux_pools` draws)."""
    jsnap = jsyn.full_gate_cluster(NODES, seed=0, gpu_node_frac=gpu_frac)
    jpods = jsyn.full_gate_pods(PODS, NODES, seed=1)
    free, valid, req, alloc, used = synthetic.aux_pools(
        np.asarray(jsnap.devices.gpu_valid).any(axis=1),
        np.asarray(jdeviceshare.has_gpu_request(jpods)), seed=11, j=j)
    requests = np.array(jpods.requests)
    requests[:, AUX_COLS] = req
    allocatable = np.array(jsnap.nodes.allocatable)
    allocatable[:, AUX_COLS] = alloc
    requested = np.array(jsnap.nodes.requested)
    requested[:, AUX_COLS] = used
    return (jsnap.replace(
                nodes=jsnap.nodes.replace(
                    allocatable=jnp.asarray(allocatable),
                    requested=jnp.asarray(requested)),
                devices=jsnap.devices.replace(
                    aux_free=jnp.asarray(free), aux_valid=jnp.asarray(valid))),
            jpods.replace(requests=jnp.asarray(requests)))


def test_aux_prefilter_equals_reference():
    """K6 with its aux part (the plain version) against the reference's
    whole `prefilter` on the aux full gate's cluster and pods, and on
    the same cluster without GPU instances (the aux part alone)."""
    _prefilter_equals_reference(synthetic.AUX_INSTANCES)


def test_aux_prefilter_at_64_vfs_equals_reference():
    """The same with 64 VFs a GPU node (fault C8's width)."""
    _prefilter_equals_reference(64)


def _prefilter_equals_reference(j):
    jsnap, jpods = _aux_inputs(j=j)
    want = np.asarray(jdeviceshare.prefilter(jsnap.devices, jpods))
    tdev = to_port("DeviceState", jsnap.devices)
    pods = to_port("PodBatch", jpods)
    ok, score = device_pair_terms(
        deviceshare.gpu_request(pods.requests, pods.gpu_ratio), tdev,
        "least", aux_req=deviceshare.aux_request(pods.requests))
    np.testing.assert_array_equal(ok.numpy(), want)
    assert score is not None and (~want).any()
    jdev0 = jsnap.devices.replace(
        gpu_total=jsnap.devices.gpu_total,
        gpu_free=jsnap.devices.gpu_free[:, :0],
        gpu_valid=jsnap.devices.gpu_valid[:, :0],
        gpu_numa=jsnap.devices.gpu_numa[:, :0],
        gpu_pcie=jsnap.devices.gpu_pcie[:, :0])
    want0 = np.asarray(jdeviceshare.prefilter(jdev0, jpods))
    ok0, score0 = device_pair_terms(
        deviceshare.gpu_request(pods.requests, pods.gpu_ratio),
        to_port("DeviceState", jdev0), "least",
        aux_req=deviceshare.aux_request(pods.requests))
    gpu = deviceshare.has_gpu_request(pods.requests, pods.gpu_ratio).numpy()
    # without GPU instances the GPU pods fail in the per-pod term
    np.testing.assert_array_equal(ok0.numpy() & ~gpu[:, None], want0)
    assert score0 is None


@functools.lru_cache(maxsize=None)
def _aux_chunk():
    """The first packed chunk of the aux full gate and the step's knobs
    (FULL_GATE_KW, the three prefixes, the domain classes)."""
    jsnap, jpods = _aux_inputs()
    packed, prefixes, _ = jsyn.pack_gate_prefixes(jpods, CHUNK)
    kw = dict(configs.FULL_GATE_KW, topo_prefix=prefixes["topo"],
              numa_prefix=prefixes["numa"], gpu_prefix=prefixes["gpu"],
              dom_classes=jsyn.dom_classes(packed))
    chunk = packed.replace(**{k: v[0] for k, v in
                              jsyn.stack_pod_chunks(packed, CHUNK).items()})
    return jsnap, chunk, kw


@functools.lru_cache(maxsize=None)
def _aux_both(cascade, strategy):
    jsnap, jpods, kw = _aux_chunk()
    return _both(jsnap, jpods, **dict(kw, cascade=cascade,
                                      device_strategy=strategy))


@pytest.mark.parametrize("cascade", [True, False], ids=["cascade", "flat"])
@pytest.mark.parametrize("strategy", ["least", "most"])
def test_aux_full_gate_batch_equals_reference(cascade, strategy):
    """A full-gate batch with aux pools: every result field (aux_inst
    included) and the snapshot (aux_free bit for bit) equal the
    reference's; aux pods place on VFs, some pods ask for more than any
    VF holds and stay out."""
    _, jpods, _ = _aux_chunk()
    want, got = _aux_both(cascade, strategy)
    assert_bits_equal(tree(got), ref_tree(want))
    asks = (np.asarray(jpods.requests)[:, AUX_COLS] > 0)
    placed = got.assignment.numpy() >= 0
    inst = got.aux_inst.numpy()
    assert (placed[:, None] & asks & (inst >= 0)).any()
    assert ((inst >= 0) <= (placed[:, None] & asks)).all()
    assert (asks.any(axis=1) & ~placed).any()


def test_aux_gate_counts_its_rejections():
    """`aux_stats` counts the pods the aux gates turned away (no fitting
    instance on the chosen node, or K2's levels) without changing the
    result."""
    jsnap, jpods, kw = _aux_chunk()
    _, got = _aux_both(True, "least")
    stats = {}
    again = core.schedule_batch(to_port("ClusterSnapshot", jsnap),
                                to_port("PodBatch", jpods),
                                LoadAwareConfig.make(device="cpu"),
                                **dict(kw, device_strategy="least",
                                       aux_stats=stats))
    assert_bits_equal(tree(again), tree(got))
    assert set(stats) == {"no_instance", "gate_rejected"}
    assert int(stats["no_instance"]) > 0


@pytest.mark.parametrize("share", [0.5, 1.0])
def test_aux_forget_equals_reference(share):
    """forget_pods of the aux batch's result (a share of its pods): every
    snapshot field equals the reference's, aux_free included, and a
    whole forget gives the VFs back."""
    jsnap, jpods, _ = _aux_chunk()
    want, got = _aux_both(True, "least")
    mask = np.random.default_rng(7).uniform(size=CHUNK) < share
    want_back = jdelta.forget_pods(want.snapshot, jpods, want,
                                   jnp.asarray(mask))
    got_back = delta.forget_pods(got.snapshot, to_port("PodBatch", jpods),
                                 got, torch.from_numpy(mask))
    assert_bits_equal(tree(got_back), ref_tree(want_back))
    if share == 1.0:
        np.testing.assert_array_equal(got_back.devices.aux_free.numpy(),
                                      np.asarray(jsnap.devices.aux_free))


def test_topology_delta_at_eight_aux_instances():
    """A topology delta on a snapshot with aux pools (J = 8 RDMA VFs on
    every node): removed nodes zero their VFs, the rest keep them; equal
    to the reference's."""
    snap = synthetic.full_gate_cluster(32, seed=3, device="cpu")
    free, valid = synthetic.aux_pools(np.ones(32, bool), np.zeros(1, bool))[:2]
    snap = snap.replace(devices=snap.devices.replace(
        aux_free=torch.from_numpy(free), aux_valid=torch.from_numpy(valid)))
    assert snap.devices.aux_free.shape[2] == 8
    snap, jsnap = port_ref("ClusterSnapshot", snap)
    d = synthetic.topology_delta_rows(snap, 10, seed=6, version=2)
    d, jd = port_ref("NodeTopologyDelta", d)
    got = delta.apply_topology_delta(snap, d)
    want = jdelta.apply_topology_delta(jsnap, jd)
    assert_bits_equal(tree(got), ref_tree(want))
    assert got.devices.aux_valid.any()
    assert not torch.equal(got.devices.aux_valid, snap.devices.aux_valid)


def test_approx_topk_equals_reference():
    """approx_topk=True on a full-gate batch with aux pools: the
    reference's approx_max_k lowers to the exact top-k on the CPU and
    the port runs K1's exact select; every field equal, and equal to the
    port's batch without the flag."""
    jsnap, jpods, kw = _aux_chunk()
    want, got = _both(jsnap, jpods, **dict(kw, approx_topk=True))
    assert_bits_equal(tree(got), ref_tree(want))
    _, exact = _aux_both(True, "least")
    assert_bits_equal(tree(got), tree(exact))


def test_aux_full_gate_run_on_the_host():
    """configs.run_full_gate(aux=True) at a cut size: its line, and the
    aux invariants on the whole run: the batch-start free less every
    placed pod's request at its (node, pool, instance) equals the final
    free, no VF goes below 0, every placed aux pod's VF is valid on its
    node, and aux pods both place and are turned away."""
    line, run, setup = configs.run_full_gate(800, 96, 400, device="cpu",
                                             aux=True)
    assert line["metric"] == configs.FULL_GATE_AUX_METRIC and line["aux"]
    assert line["aux_pods"] > line["aux_placed"] > 0
    assert sum(line["aux_no_fit"].values()) > 0
    snap0, pods = setup["snap"], setup["pods"]
    req = deviceshare.aux_request(pods.requests)
    want = snap0.devices.aux_free.clone()
    for i in torch.nonzero(run.aux_inst >= 0).tolist():
        pod, t = i
        node, inst = int(run.assignment[pod]), int(run.aux_inst[pod, t])
        assert bool(snap0.devices.aux_valid[node, t, inst])
        want[node, t, inst] -= req[pod, t]
    assert torch.equal(run.snapshot.devices.aux_free, want)
    assert bool((run.snapshot.devices.aux_free >= 0).all())
    assert core.overcommit_ok(run.snapshot) and core.quota_ok(run.snapshot)
