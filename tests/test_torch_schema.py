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
