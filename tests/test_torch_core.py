"""The port's slim schedule_batch against the JAX package's under the
bench's exact arguments (bench.py:400-405)."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from koordinator_tpu.api.extension import ResourceKind as RK
from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch.scheduler import cascade, core
from koordinator_tpu_torch.scheduler.plugins import deviceshare, loadaware
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.utils import synthetic

from torch_port_ref import to_port

BENCH_KW = dict(num_rounds=2, k_choices=8, score_dims=(0, 1),
                tie_break=True, quota_depth=2, fit_dims=(0, 1, 2, 3),
                cascade=False, enable_numa=False)

# (pods, nodes, seed): roomy, contended (pods >> capacity: rejections
# and fall-through), and contended with strict gangs that end below
# quorum (the rollback fires). Two shapes, so JAX compiles twice.
CASES = {"roomy": (256, 64, 0), "contended": (512, 16, 1),
         "gangs_below_quorum": (512, 16, 2)}


@functools.lru_cache(maxsize=None)
def _run(case):
    p, n, seed = CASES[case]
    snap = jsyn.synthetic_cluster(n, seed=seed, num_quotas=8, num_gangs=6,
                                  gang_min_member=8)
    pods = jsyn.synthetic_pods(p, seed=seed + 10, num_quotas=8, num_gangs=6,
                               gang_min_member=8)
    want = jcore.schedule_batch(snap, pods, JCfg.make(), **BENCH_KW)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", pods),
                              LoadAwareConfig.make(device="cpu"), **BENCH_KW)
    return want, got


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("field", ["assignment", "chosen_score",
                                   "gang_failed", "res_slot", "numa_zone",
                                   "aux_inst"])
def test_result_fields_equal(case, field):
    want, got = _run(case)
    w, g = _np(getattr(want, field)), _np(getattr(got, field))
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("path", ["nodes.requested", "quotas.used",
                                  "nodes.assigned_estimated",
                                  "nodes.prod_assigned_estimated",
                                  "gangs.assumed", "version"])
def test_snapshot_state_bit_equal(case, path):
    want, got = _run(case)
    w, g = want.snapshot, got.snapshot
    for part in path.split("."):
        w, g = getattr(w, part), getattr(g, part)
    assert _np(g).tobytes() == _np(w).tobytes()


def test_cases_exercise_rejection_and_rollback():
    for case in CASES:
        want, _ = _run(case)
        placed = int((np.asarray(want.assignment) >= 0).sum())
        assert 0 < placed
        if case != "roomy":
            assert placed < CASES[case][0]
    assert np.asarray(_run("gangs_below_quorum")[0].gang_failed).any()
    _, got = _run("contended")
    assert core.overcommit_ok(got.snapshot) and core.quota_ok(got.snapshot)


def test_slim_path_builds_no_pair_gate(monkeypatch):
    """The slim schedule_batch forms no [P, N] gate mask: K1 takes the
    gates in factored form. The functions that build the mask (static_gates, the
    LoadAware filter_mask, the [P, N, 3] device prefilter) raise while
    it runs, and the result still equals the reference's."""
    def built(*args, **kwargs):
        raise AssertionError("the slim path built a [P, N] gate mask")

    for mod, name in ((cascade, "static_gates"), (deviceshare, "prefilter"),
                      (loadaware, "filter_mask")):
        monkeypatch.setattr(mod, name, built)
        if hasattr(core, name):   # a name imported into core itself
            monkeypatch.setattr(core, name, built)
    want, _ = _run("contended")
    p, n, seed = CASES["contended"]
    snap = jsyn.synthetic_cluster(n, seed=seed, num_quotas=8, num_gangs=6,
                                  gang_min_member=8)
    pods = jsyn.synthetic_pods(p, seed=seed + 10, num_quotas=8, num_gangs=6,
                               gang_min_member=8)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", pods),
                              LoadAwareConfig.make(device="cpu"), **BENCH_KW)
    for field in ("assignment", "chosen_score"):
        assert (_np(getattr(got, field)).tobytes()
                == _np(getattr(want, field)).tobytes())


def _slim_inputs():
    snap = synthetic.synthetic_cluster(8, num_quotas=4, device="cpu")
    pods = synthetic.synthetic_pods(16, num_quotas=4, device="cpu")
    return snap, pods, LoadAwareConfig.make(device="cpu")


@pytest.mark.parametrize("kw", [
    dict(enable_numa=True), dict(cascade=True), dict(approx_topk=True),
    dict(enable_amplification=True)], ids=str)
def test_unported_options_raise(kw):
    snap, pods, cfg = _slim_inputs()
    with pytest.raises(NotImplementedError):
        core.schedule_batch(snap, pods, cfg, **dict(BENCH_KW, **kw))


def test_unported_inputs_raise():
    snap, pods, cfg = _slim_inputs()
    gpu = jsyn.synthetic_cluster(8, gpu_node_frac=1.0, gpus_per_node=2)
    resv = jsyn.synthetic_cluster(8, num_reservations=2)
    for bad_snap, bad_pods in (
            (to_port("ClusterSnapshot", gpu), pods),
            (to_port("ClusterSnapshot", resv), pods),
            (snap, pods.replace(has_spread=True)),
            (snap, pods.replace(has_taints=True))):
        with pytest.raises(NotImplementedError):
            core.schedule_batch(bad_snap, bad_pods, cfg, **BENCH_KW)


@pytest.mark.parametrize("weights", [None, "fractional"])
def test_all_dims_equal_reference(weights):
    """fit_dims=None and score_dims=None (the reference's defaults: all
    11 resource dims gated and scored), contended, with the default
    weights and with fractional ones whose weighted sum rounds."""
    snap = jsyn.synthetic_cluster(24, seed=4, num_quotas=8)
    pods = jsyn.synthetic_pods(384, seed=14, num_quotas=8)
    cfg_kw = {} if weights is None else dict(resource_weights={
        RK(i): w for i, w in enumerate((3.0, 0.7, 1.3, 0.1, 2.9, 0.3, 1.7,
                                        0.9, 0.6, 1.1, 2.2))})
    kw = dict(BENCH_KW, fit_dims=None, score_dims=None)
    want = jcore.schedule_batch(snap, pods, JCfg.make(**cfg_kw), **kw)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", pods),
                              LoadAwareConfig.make(**cfg_kw, device="cpu"),
                              **kw)
    placed = int((np.asarray(want.assignment) >= 0).sum())
    assert 0 < placed < 384
    for w, g in ((want.assignment, got.assignment),
                 (want.chosen_score, got.chosen_score),
                 (want.snapshot.nodes.requested, got.snapshot.nodes.requested),
                 (want.snapshot.quotas.used, got.snapshot.quotas.used),
                 (want.snapshot.nodes.assigned_estimated,
                  got.snapshot.nodes.assigned_estimated)):
        assert _np(g).tobytes() == _np(w).tobytes()
