"""The port's struct twins, bridge and synthetic inputs against the JAX
package's."""

from __future__ import annotations

import numpy as np
import pytest

from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.snapshot import schema as jschema
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch.bridge import from_reference, to_numpy
from koordinator_tpu_torch.snapshot import schema
from koordinator_tpu_torch.utils import synthetic

from torch_port_ref import assert_trees_equal, numpy_tree

STRUCTS = ("NodeState", "PodBatch", "QuotaState", "GangState",
           "DeviceState", "ReservationState", "ClusterSnapshot",
           "ScheduleResult")


@pytest.mark.parametrize("name", STRUCTS)
def test_struct_specs_match_reference(name):
    """Same field names, dtypes, dims and pad fills as STRUCT_SPECS
    (bare-symbol properties such as num_nodes excepted)."""
    want = {f: s for f, s in jschema.STRUCT_SPECS[name].items()
            if "[" in s or s in jschema.STRUCT_SPECS}
    assert schema.STRUCT_SPECS[name] == want


def _reference_structs():
    """One JAX instance of every struct, with non-empty device pools and
    reservation slots so that every leaf carries data."""
    snap = jsyn.synthetic_cluster(16, seed=3, num_quotas=4, num_gangs=2,
                                  gpu_node_frac=0.5, gpus_per_node=2,
                                  num_reservations=2)
    pods = jsyn.synthetic_pods(12, seed=3, num_quotas=4, num_gangs=1,
                               gang_min_member=4, gpu_pod_frac=0.3)
    rng = np.random.default_rng(0)
    result = jcore.ScheduleResult(
        assignment=rng.integers(-1, 16, 12).astype(np.int32),
        chosen_score=rng.uniform(-1, 100, 12).astype(np.float32),
        numa_zone=np.full((12,), -1, np.int32),
        numa_take=rng.uniform(0, 5, (12, 4, 2)).astype(np.float32),
        gpu_take=rng.uniform(size=(12, 2)) < 0.5,
        aux_inst=np.full((12, 2), -1, np.int32),
        res_slot=rng.integers(-1, 2, 12).astype(np.int32),
        gang_failed=np.array([True, False]),
        snapshot=snap)
    return {"NodeState": snap.nodes, "PodBatch": pods,
            "QuotaState": snap.quotas, "GangState": snap.gangs,
            "DeviceState": snap.devices,
            "ReservationState": snap.reservations,
            "ClusterSnapshot": snap, "ScheduleResult": result}


@pytest.mark.parametrize("name", STRUCTS)
def test_bridge_round_trips_every_leaf(name):
    want = numpy_tree(_reference_structs()[name])
    if name == "ScheduleResult":
        want.pop("amplified")
    port = from_reference(name, want, device="cpu")
    assert_trees_equal({k: v for k, v in to_numpy(port).items()
                        if k in want}, want)


def test_bridge_refuses_a_widened_column():
    tree = numpy_tree(jsyn.synthetic_cluster(4).gangs)
    tree["assumed"] = tree["assumed"].astype(np.int64)
    with pytest.raises(TypeError, match="assumed"):
        from_reference("GangState", tree, device="cpu")


def test_struct_to_and_replace():
    snap = synthetic.synthetic_cluster(8, device="cpu")
    moved = snap.to("cpu")
    assert moved.nodes.allocatable.device.type == "cpu"
    bumped = snap.replace(version=snap.version + 1)
    assert int(bumped.version) == 1 and int(snap.version) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_inputs_equal_reference(seed):
    jsnap = jsyn.synthetic_cluster(64, seed=seed, num_quotas=8, num_gangs=3)
    tsnap = synthetic.synthetic_cluster(64, seed=seed, num_quotas=8,
                                        num_gangs=3, device="cpu")
    assert_trees_equal(to_numpy(tsnap), numpy_tree(jsnap))
    jpods = jsyn.synthetic_pods(300, seed=seed, num_quotas=8, num_gangs=3)
    tpods = synthetic.synthetic_pods(300, seed=seed, num_quotas=8,
                                     num_gangs=3, device="cpu")
    assert_trees_equal(to_numpy(tpods), numpy_tree(jpods))


def test_stack_pod_chunks_equal_reference():
    jpods = jsyn.synthetic_pods(120, seed=4, num_quotas=8)
    tpods = synthetic.synthetic_pods(120, seed=4, num_quotas=8, device="cpu")
    want = jsyn.stack_pod_chunks(jpods, 40)
    got = synthetic.stack_pod_chunks(tpods, 40)
    assert set(got) == set(want)
    for f, w in want.items():
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        synthetic.stack_pod_chunks(tpods, 7)


def test_estimate_vectorized_equal_reference():
    rng = np.random.default_rng(5)
    req = (rng.integers(0, 9, (50, 11)) * 250).astype(np.float32)
    lim = np.where(rng.uniform(size=(50, 11)) < 0.5, 0,
                   req * 1.5 + 10).astype(np.float32)
    pc = rng.integers(0, 5, 50).astype(np.int8)
    np.testing.assert_array_equal(synthetic.estimate_vectorized(req, lim, pc),
                                  jsyn.estimate_vectorized(req, lim, pc))


@pytest.mark.parametrize("seed", [0, 1])
def test_with_two_numa_zones_equal_reference(seed):
    jsnap = jsyn.with_two_numa_zones(
        jsyn.synthetic_cluster(48, seed=seed, num_quotas=8))
    tsnap = synthetic.with_two_numa_zones(
        synthetic.synthetic_cluster(48, seed=seed, num_quotas=8,
                                    device="cpu"))
    assert_trees_equal(to_numpy(tsnap), numpy_tree(jsnap))
    resv = jsyn.synthetic_cluster(8, num_reservations=2)
    bad = resv.replace(reservations=resv.reservations.replace(
        numa_valid=np.ones_like(np.asarray(resv.reservations.numa_valid))))
    for make in (lambda: jsyn.with_two_numa_zones(bad),
                 lambda: synthetic.with_two_numa_zones(
                     from_reference("ClusterSnapshot", numpy_tree(bad),
                                    device="cpu"))):
        with pytest.raises(ValueError, match="zones >= 2"):
            make()


def test_config_2_inputs_equal_reference():
    """The port's BASELINE config 2 builder against
    bench_configs.config_2_numa's inputs, cut to 2000 pods x 100 nodes
    (the same generator calls; only the counts differ)."""
    jsnap = jsyn.with_two_numa_zones(
        jsyn.synthetic_cluster(100, num_quotas=32, seed=0))
    jpods = jsyn.synthetic_pods(2000, seed=1, prod_frac=0.6, num_quotas=32)
    jpods = jpods.replace(numa_single=np.asarray(jpods.priority_class) == 4)
    tsnap, tpods = synthetic.config_2_inputs(2000, 100, device="cpu")
    assert_trees_equal(to_numpy(tsnap), numpy_tree(jsnap))
    assert_trees_equal(to_numpy(tpods), numpy_tree(jpods))
    assert 0 < int(tpods.numa_single.sum()) < 2000


@pytest.mark.parametrize("zones", [2, 4])
def test_zone_fields_cross_the_bridge(zones):
    """NodeState's zone columns, the reservations' and
    ScheduleResult.numa_take at Z = 2 and Z = 4, both ways."""
    snap = jsyn.synthetic_cluster(6, seed=2, num_reservations=2)
    if zones == 2:
        snap = jsyn.with_two_numa_zones(snap)
    rng = np.random.default_rng(zones)
    result = numpy_tree(_reference_structs()["ScheduleResult"])
    result.pop("amplified")
    result["numa_take"] = rng.uniform(0, 5, (12, zones, 2)).astype(np.float32)
    result["snapshot"] = numpy_tree(snap)
    port = from_reference("ScheduleResult", result, device="cpu")
    assert port.numa_take.shape == (12, zones, 2)
    assert port.snapshot.nodes.numa_cap.shape == (6, zones, 2)
    assert port.snapshot.reservations.numa_free.shape[1] == zones
    assert_trees_equal({k: v for k, v in to_numpy(port).items()
                        if k in result}, result)


@pytest.mark.parametrize("frac", [0.25, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_gpu_draws_equal_reference(seed, frac):
    """GPU nodes (drawn after the quotas) and GPU pods (drawn before the
    gangs and quotas, so quota_id moves with them) as the reference
    draws them, with gangs and quotas in play."""
    jsnap = jsyn.synthetic_cluster(64, seed=seed, num_quotas=8, num_gangs=3,
                                   gpu_node_frac=frac, gpus_per_node=4,
                                   gpu_memory_mib=40960.0)
    tsnap = synthetic.synthetic_cluster(64, seed=seed, num_quotas=8,
                                        num_gangs=3, gpu_node_frac=frac,
                                        gpus_per_node=4,
                                        gpu_memory_mib=40960.0, device="cpu")
    assert_trees_equal(to_numpy(tsnap), numpy_tree(jsnap))
    jpods = jsyn.synthetic_pods(300, seed=seed, num_quotas=8, num_gangs=3,
                                gpu_pod_frac=frac)
    tpods = synthetic.synthetic_pods(300, seed=seed, num_quotas=8,
                                     num_gangs=3, gpu_pod_frac=frac,
                                     device="cpu")
    assert_trees_equal(to_numpy(tpods), numpy_tree(jpods))
    assert tsnap.devices.gpu_free.shape == (64, 4, 3)
    assert bool((tpods.gpu_ratio > 0).any())


def test_gpu_share_inputs_equal_reference():
    """The port's gpu_share inputs against the reference's full-gate
    cluster (taint classes and 64 live slots included) leaf for leaf,
    and its full-gate pods: the same requests, priorities, gangs,
    quotas, GPU requests, NUMA binding, tolerations, reservation owners
    and spread, anti-affinity and affinity groups."""
    tsnap, tpods = synthetic.gpu_share_inputs(2000, 300, device="cpu")
    jsnap = jsyn.full_gate_cluster(300, num_quotas=32)
    jpods = jsyn.full_gate_pods(2000, 300, seed=1, num_quotas=32)
    assert_trees_equal(to_numpy(tsnap), numpy_tree(jsnap))
    got = to_numpy(tpods)
    for field in ("requests", "estimated", "priority", "priority_class",
                  "gang_id", "quota_id", "gpu_ratio", "numa_single", "qos",
                  "toleration_id", "tol_forbid", "tol_prefer",
                  "reservation_owner", "spread_carrier", "spread_member",
                  "spread_domain", "spread_max_skew", "anti_member",
                  "anti_carrier", "anti_domain", "aff_member",
                  "aff_carrier", "aff_domain", "aff_count0"):
        np.testing.assert_array_equal(got[field], np.asarray(
            getattr(jpods, field)), err_msg=field)
    assert tpods.has_taints and (tpods.has_spread and tpods.has_anti
                                 and tpods.has_aff)
    assert 0 < int((tpods.numa_single & (tpods.gpu_ratio > 0)).sum())
    assert int((tpods.reservation_owner >= 0).sum()) == 128


def test_device_fields_cross_the_bridge():
    """DeviceState with instances and ScheduleResult.gpu_take, both
    ways."""
    snap = jsyn.with_two_numa_zones(jsyn.synthetic_cluster(
        6, seed=2, gpu_node_frac=0.5, gpus_per_node=8))
    rng = np.random.default_rng(3)
    result = numpy_tree(_reference_structs()["ScheduleResult"])
    result.pop("amplified")
    result["gpu_take"] = rng.uniform(size=(12, 8)) < 0.3
    result["snapshot"] = numpy_tree(snap)
    port = from_reference("ScheduleResult", result, device="cpu")
    assert port.gpu_take.shape == (12, 8)
    assert port.snapshot.devices.gpu_free.shape == (6, 8, 3)
    assert port.snapshot.reservations.gpu_free.shape == (0, 8, 3)
    assert_trees_equal({k: v for k, v in to_numpy(port).items()
                        if k in result}, result)
