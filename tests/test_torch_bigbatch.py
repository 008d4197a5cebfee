"""Batches above one block of the step's kernels (faults C5 and C6,
ROADMAP) in the port against the JAX package, through the plain
versions the kernels are held to on the card:

- BASELINE config 4 (`configs.run_config_4_quota`, chunks of 2500 under
  500 quotas) at a cut node count against the reference's chunked
  `schedule_batch` with `bench_configs._run_scheduler_config`'s knobs;
- one full-gate batch of 2500 pods (NUMA, GPU instances, taints, slots,
  the three topology families, the cascade and the prefixes);
- K2's segment prefix on fractional requests (check C-a): the plain
  version against the reference's `segment_prefix_ok` near gate
  boundaries, at P <= 2048 and at P = 2500, and on them, where a
  last-bit difference of the two packages' sums flips a gate (fault
  C7, bounded here);
- the LowNodeLoad plan (K11, K12, K13's plain versions) at about 20 000
  pods, plain and capped, against the reference's `plan_kernel` and
  `plan_kernel_capped`, and the every-node config 5 against the host
  loop.

Tolerances: none; every field is compared bit for bit, except on
fault C7's boundary pods, as its test states."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.scheduler import batching as jbatching
from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch import configs
from koordinator_tpu_torch import descheduler as td
from koordinator_tpu_torch.kernels.segment_prefix import (
    segment_prefix_chain,
    segment_prefix_ok_plain,
)
from koordinator_tpu_torch.scheduler import core
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.utils.synthetic import CONFIG_5_NOW

from test_torch_descheduler import _raw_cols, assert_same_plan, both_plans

from torch_port_ref import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_bits_equal,
    one_torch_thread,
    ref_tree,
    to_port,
    tree,
)

# --- BASELINE config 4 at a cut node count ---------------------------------

CFG4_PODS, CFG4_NODES, CFG4_CHUNK = 5000, 200, 2500


@functools.lru_cache(maxsize=None)
def _config_4_both():
    """(reference final snapshot, assignment), (port line, run)."""
    snap = jsyn.synthetic_cluster(CFG4_NODES, num_quotas=500, max_quotas=512,
                                  seed=0)
    pods = jsyn.synthetic_pods(CFG4_PODS, seed=1, num_quotas=500)
    kw = dict(configs.CONFIG_4_KW)
    assign = []
    for cols in (dict(zip(c.keys(), v)) for c in [jsyn.stack_pod_chunks(
            pods, CFG4_CHUNK)] for v in zip(*c.values())):
        res = jcore.schedule_batch(snap, pods.replace(**cols), JCfg.make(),
                                   **kw)
        snap = res.snapshot
        assign.append(np.asarray(res.assignment))
    line, run = configs.run_config_4_quota(CFG4_PODS, CFG4_NODES, CFG4_CHUNK,
                                           device="cpu")
    return (snap, np.concatenate(assign)), (line, run)


def test_config_4_equals_reference():
    """The chunked sweep's assignment and final snapshot equal the
    reference's; the line counts what it placed; both chunks are above
    2048 pods and a quota level gates some pods."""
    (want_snap, want_assign), (line, run) = _config_4_both()
    np.testing.assert_array_equal(run.assignment.numpy(), want_assign)
    assert_bits_equal(tree(run.snapshot), ref_tree(want_snap))
    assert line["metric"] == configs.CONFIG_4_METRIC
    assert line["placed"] == int((want_assign >= 0).sum()) > 0
    assert line["chunk"] == CFG4_CHUNK > 2048
    assert core.quota_ok(run.snapshot) and core.overcommit_ok(run.snapshot)


# --- one full-gate batch of 2500 pods --------------------------------------

GATE_NODES, GATE_PODS = 120, 2500


def test_full_gate_batch_of_2500_equals_reference():
    """The first packed chunk of the full gate at 2500 pods (the cascade,
    the prefixes, the domain classes; NUMA, GPU instances, taints, slots
    and the topology families on) through both packages: every result
    field and the snapshot equal."""
    jsnap = jsyn.full_gate_cluster(GATE_NODES, seed=0)
    jpods = jsyn.full_gate_pods(GATE_PODS, GATE_NODES, seed=1)
    packed, prefixes, _ = jsyn.pack_gate_prefixes(jpods, GATE_PODS)
    kw = dict(configs.FULL_GATE_KW, topo_prefix=prefixes["topo"],
              numa_prefix=prefixes["numa"], gpu_prefix=prefixes["gpu"],
              dom_classes=jsyn.dom_classes(packed))
    want = jcore.schedule_batch(jsnap, packed, JCfg.make(), **kw)
    got = core.schedule_batch(to_port("ClusterSnapshot", jsnap),
                              to_port("PodBatch", packed),
                              LoadAwareConfig.make(device="cpu"), **kw)
    assert_bits_equal(tree(got), ref_tree(want))
    assign = got.assignment.numpy()
    assert (assign >= 0).sum() > 0 and (got.gpu_take.numpy().any(1)).any()
    assert prefixes["topo"] > 0 and (got.numa_zone.numpy() >= 0).any()


# --- check C-a: K2 on fractional requests ------------------------------------


def fractional_case(p, seed, offset, segments=40, r=4):
    """Requests in fractional MiB and mC (multiples of 1/8 and 1/3 and
    random fractions), bases of earlier use, and each segment's memory
    limit set by one pod of it (the middle one in rank order): the
    limit plus EPS is that pod's left side summed in rank order in f32,
    plus `offset`. At offset 0 the last bit of the sum decides the
    pod's gate. Returns (seg, rank, req, base, limit, boundary pods)."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, segments, p).astype(np.int32)
    rank = rng.permutation(p).astype(np.int32)
    req = np.zeros((p, r), np.float32)
    req[:, 0] = rng.integers(1, 4000, p) / np.float32(3.0)   # mC / 3
    req[:, 1] = rng.uniform(0.1, 2048.0, p)                  # MiB
    req[:, 2] = rng.integers(1, 64, p) / np.float32(8.0)
    req[:, 3] = rng.uniform(0.0, 1.0, p)
    base = rng.uniform(0.0, 5000.0, (segments, r)).astype(np.float32)
    limit = np.full((segments, r), np.float32(3.0e7))
    order = np.argsort(rank)
    boundary = []
    for s in range(segments):
        pods = order[seg[order] == s]
        if not len(pods):
            continue
        at = pods[len(pods) // 2]
        cum = np.float32(0.0)
        for q in pods[:len(pods) // 2]:
            cum = np.float32(cum + req[q, 1])
        lhs = np.float32(np.float32(base[s, 1] + cum) + req[at, 1])
        limit[s, 1] = np.float32(lhs - np.float32(EPS) + np.float32(offset))
        boundary.append(at)
    return seg, rank, req, base, limit, np.asarray(boundary)


def _k2_both(seg, rank, req, base, limit):
    """(reference verdicts, reference's f32 prefix sums, the port's
    plain verdicts, its prefix sums, the chain's verdicts through the
    wrapper as the CPU runs it)."""
    s = base.shape[0]
    earlier = jnp.asarray(rank)[None, :] < jnp.asarray(rank)[:, None]
    want = np.asarray(jax.jit(jbatching.segment_prefix_ok, static_argnums=5)(
        jnp.asarray(seg), earlier, jnp.asarray(req), jnp.asarray(base),
        jnp.asarray(limit), s))
    same = (seg[:, None] == seg[None, :]) & np.asarray(earlier)
    want_cum = np.asarray(jax.jit(lambda m, r: m @ r)(
        jnp.asarray(same.astype(np.float32)), jnp.asarray(req)))
    t = [torch.from_numpy(x) for x in (seg, rank, req, base, limit)]
    got = segment_prefix_ok_plain(t[0], t[1], t[2], t[3], t[4], s, EPS)
    got_cum = (torch.from_numpy(same.astype(np.float32)) @ t[2]).numpy()
    chain = segment_prefix_chain(t[0][None], t[1], t[2],
                                 torch.ones(len(seg), dtype=torch.bool),
                                 [(t[3], t[4], s)], EPS)
    return want, want_cum, got.numpy(), got_cum, chain.numpy()


@pytest.mark.parametrize("p", [300, 2048, 2500])
def test_segment_prefix_on_fractional_requests(p):
    """ROADMAP check C-a: the plain K2 (`segment_prefix_ok_plain`, and
    the chain through the wrapper) against the reference's
    `segment_prefix_ok` on fractional requests whose limits sit 4 MiB
    off a pod's boundary: the verdicts equal, and the limits bite."""
    seg, rank, req, base, limit, _ = fractional_case(p, p, offset=4.0)
    want, _, got, _, chain = _k2_both(seg, rank, req, base, limit)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(chain, want)
    assert 0 < want.sum() < p


@pytest.mark.parametrize("p", [300, 2048, 2500])
def test_fractional_gate_boundary_within_2_ulp(p):
    """ROADMAP fault C7, found by check C-a: with the limit on a pod's
    boundary, the reference (XLA:CPU's dot) and the port (torch's CPU
    matmul on the host, the kernel's rank-ordered sums on the card) add
    the same fractional requests in different orders, and a last-bit
    difference may flip a boundary pod's gate. The test bounds the
    fault: verdicts differ only at boundary pods, each where its two
    prefix sums differ, by at most 2 ulp."""
    seg, rank, req, base, limit, boundary = fractional_case(p, p, offset=0.0)
    want, want_cum, got, got_cum, chain = _k2_both(seg, rank, req, base,
                                                   limit)
    np.testing.assert_array_equal(chain, got)
    differ = np.flatnonzero(got != want)
    assert set(differ.tolist()) <= set(boundary.tolist())
    ulp = np.spacing(np.abs(want_cum[differ, 1]))
    assert (np.abs(got_cum[differ, 1] - want_cum[differ, 1])
            <= 2 * ulp).all()
    assert (got_cum[differ, 1] != want_cum[differ, 1]).all()


# --- the LowNodeLoad plan above 16 384 pods ---------------------------------


@pytest.mark.parametrize("capped", [False, True], ids=["plain", "capped"])
def test_plan_above_16384_pods_equals_reference(capped):
    """plan_kernel (K11, K10, K12) and plan_kernel_capped (K13) at 20 000
    pods over 300 nodes, against the reference's: order and takes
    equal, and the plans take pods."""
    cols = _raw_cols(300, 20_000, seed=11)
    caps = None
    if capped:
        p = cols["pod_node"].shape[0]
        caps = dict(pod_ns=(np.arange(p) % 7).astype(np.int32),
                    ns_counts0=np.zeros(7, np.int32),
                    per_node0=np.zeros(300, np.int32),
                    max_evictions=4000, max_per_node=3, max_per_ns=500)
    ref, port = both_plans(cols, caps)
    assert_same_plan(ref, port)
    assert ref[0].any()


def test_every_node_config_5_equals_host_loop():
    """Config 5 with pods on every node (`run_config_5_descheduler(
    every_node=True)`) at 5000 nodes, 20 000 pods: the device plan's
    evictions, through the plain versions, equal the host loop's name
    for name, plain and capped."""
    for capped in (False, True):
        line, run = configs.run_config_5_descheduler(
            capped, n_nodes=5000, device="cpu", every_node=True)
        assert line["pods"] == 20_000 and line["metric"].endswith(
            "_every_node")
        host = td.RecordingEvictor(td.EvictionLimiter(
            **configs.CONFIG_5_CAPS) if capped else None)
        td.LowNodeLoad(td.LowNodeLoadArgs(consecutive_abnormalities=1),
                       host).balance_once(run.nodes, run.metrics,
                                          run.pods_by_node, CONFIG_5_NOW)
        got = [e.pod.meta.namespaced_name for e in run.evictor.evictions]
        want = [e.pod.meta.namespaced_name for e in host.evictions]
        assert got == want and line["evictions_planned"] == len(got) > 0
