"""Batches above one block of the step's kernels (faults C5 and C6,
ROADMAP) in the port against the JAX package, through the plain
versions the kernels are held to on the card:

- BASELINE config 4 (`configs.run_config_4_quota`, chunks of 2500 under
  500 quotas) at a cut node count against the reference's chunked
  `schedule_batch` with `bench_configs._run_scheduler_config`'s knobs,
  and configs 1 (full size) and 3 (cut to 100 gangs) the same way;
- one full-gate batch of 2500 pods (NUMA, GPU instances, taints, slots,
  the three topology families, the cascade and the prefixes);
- K2's segment prefix on fractional requests (check C-a): the plain
  version against the reference's `segment_prefix_ok` near gate
  boundaries, at P <= 2048 and at P = 2500, and on them, where the
  last bit of the sum decides a gate (fault C7: the plain version adds
  in the reference's order, so verdicts and sums are equal);
- the LowNodeLoad plan (K11, K12, K13's plain versions) at about 20 000
  pods, plain and capped, against the reference's `plan_kernel` and
  `plan_kernel_capped`, and the every-node config 5 against the host
  loop.

Tolerances: none; every field is compared bit for bit."""

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
from koordinator_tpu_torch.api.extension import ResourceKind
from koordinator_tpu_torch.kernels._xla import xla_mask_dot
from koordinator_tpu_torch.kernels.segment_prefix import (
    exact_in_any_order,
    exact_in_any_order_plain,
    segment_prefix_chain,
    segment_prefix_ok_plain,
)
from koordinator_tpu_torch.scheduler import core
from koordinator_tpu_torch.scheduler.batching import EPS, rank_by_priority
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

CPU, MEM = int(ResourceKind.CPU), int(ResourceKind.MEMORY)

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


# --- BASELINE configs 1 and 3 ----------------------------------------------


def _reference_chunked(snap, pods, chunk, kw):
    """bench_configs._run_scheduler_config's sweep on the reference, a
    Python loop over its chunks: (final snapshot, assignment)."""
    assign = []
    for cols in (dict(zip(c.keys(), v)) for c in [jsyn.stack_pod_chunks(
            pods, chunk)] for v in zip(*c.values())):
        res = jcore.schedule_batch(snap, pods.replace(**cols), JCfg.make(),
                                   **kw)
        snap = res.snapshot
        assign.append(np.asarray(res.assignment))
    return snap, np.concatenate(assign)


def test_config_1_equals_reference():
    """BASELINE config 1 at full size (32 BE pods, 10 nodes, one chunk of
    32): assignment and final snapshot equal the reference's."""
    snap = jsyn.synthetic_cluster(10, num_quotas=2, seed=0)
    pods = jsyn.synthetic_pods(32, seed=1, prod_frac=0.0, num_quotas=2)
    want_snap, want = _reference_chunked(snap, pods, configs.CONFIG_1_CHUNK,
                                         configs.CONFIG_1_KW)
    line, run = configs.run_config_1_spark(device="cpu")
    np.testing.assert_array_equal(run.assignment.numpy(), want)
    assert_bits_equal(tree(run.snapshot), ref_tree(want_snap))
    assert line["metric"] == configs.CONFIG_1_METRIC
    assert line["placed"] == int((want >= 0).sum()) > 0


CFG3_GANGS, CFG3_NODES, CFG3_CHUNK = 100, 500, 400


def test_config_3_equals_reference():
    """BASELINE config 3 cut to 100 strict gangs of 8 on 500 nodes, in
    chunks of 400: assignment and final snapshot (gang counts included)
    equal the reference's; every gang is all or nothing."""
    snap = jsyn.synthetic_cluster(CFG3_NODES, num_quotas=32, seed=0,
                                  num_gangs=CFG3_GANGS, max_gangs=1024,
                                  gang_min_member=8)
    pods = jsyn.synthetic_pods(8 * CFG3_GANGS, seed=1, num_quotas=32,
                               num_gangs=CFG3_GANGS, gang_min_member=8)
    want_snap, want = _reference_chunked(snap, pods, CFG3_CHUNK,
                                         configs.CONFIG_3_KW)
    line, run = configs.run_config_3_gangs(CFG3_GANGS, CFG3_NODES,
                                           CFG3_CHUNK, device="cpu")
    np.testing.assert_array_equal(run.assignment.numpy(), want)
    assert_bits_equal(tree(run.snapshot), ref_tree(want_snap))
    assert line["metric"] == configs.CONFIG_3_METRIC
    assert line["gangs_placed"] > 0 and line["gangs_partial"] == 0
    assert line["placed"] == 8 * line["gangs_placed"]


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
    pod's gate. r = 1 keeps the memory column alone; r > 4 adds random
    fractional columns whose limits do not bite. Returns (seg, rank,
    req, base, limit, boundary pods)."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, segments, p).astype(np.int32)
    rank = rng.permutation(p).astype(np.int32)
    req = np.zeros((p, max(r, 4)), np.float32)
    req[:, 0] = rng.integers(1, 4000, p) / np.float32(3.0)   # mC / 3
    req[:, 1] = rng.uniform(0.1, 2048.0, p)                  # MiB
    req[:, 2] = rng.integers(1, 64, p) / np.float32(8.0)
    req[:, 3] = rng.uniform(0.0, 1.0, p)
    base = rng.uniform(0.0, 5000.0, (segments, max(r, 4))).astype(np.float32)
    if r > 4:
        req[:, 4:] = rng.uniform(0.0, 3000.0, (p, r - 4))
    limit = np.full((segments, max(r, 4)), np.float32(3.0e7))
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
    if r == 1:
        req, base, limit = (np.ascontiguousarray(x[:, 1:2])
                            for x in (req, base, limit))
    return seg, rank, req, base, limit, np.asarray(boundary)


def _gate_and_sum(seg, earlier, req, base, limit, num_segments):
    """The reference's gate with its prefix sum as a second output: the
    same masked matmul, which XLA computes once, so the sum returned is
    the one the gate compares (the callers check that the verdicts are
    the gate's alone, and that the sum decides them)."""
    ok = jbatching.segment_prefix_ok(seg, earlier, req, base, limit,
                                     num_segments)
    same = seg[:, None] == seg[None, :]
    return ok, (same & earlier).astype(req.dtype) @ req


def _k2_both(seg, rank, req, base, limit):
    """(reference verdicts, the reference's f32 prefix sums inside its
    gate, the port's plain verdicts, its prefix sums, the chain's
    verdicts through the wrapper as the CPU runs it)."""
    s = base.shape[0]
    earlier = jnp.asarray(rank)[None, :] < jnp.asarray(rank)[:, None]
    args = (jnp.asarray(seg), earlier, jnp.asarray(req), jnp.asarray(base),
            jnp.asarray(limit))
    want = np.asarray(jax.jit(jbatching.segment_prefix_ok,
                              static_argnums=5)(*args, s))
    ok, want_cum = (np.asarray(x) for x in jax.jit(
        _gate_and_sum, static_argnums=5)(*args, s))
    np.testing.assert_array_equal(ok, want)
    seg_c = np.clip(seg, 0, s - 1)
    np.testing.assert_array_equal(np.all(
        base[seg_c] + want_cum + req <= limit[seg_c] + np.float32(EPS),
        axis=-1), want)
    same = (seg[:, None] == seg[None, :]) & np.asarray(earlier)
    t = [torch.from_numpy(x) for x in (seg, rank, req, base, limit)]
    got = segment_prefix_ok_plain(t[0], t[1], t[2], t[3], t[4], s, EPS)
    got_cum = xla_mask_dot(torch.from_numpy(same), t[2]).numpy()
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


@pytest.mark.parametrize("p, r", [(300, 4), (2048, 4), (2500, 4),
                                  (300, 11), (2048, 11)])
def test_fractional_gate_boundary_equals_reference(p, r):
    """ROADMAP fault C7, found by check C-a: with the limit on a pod's
    boundary, the last bit of a pod's prefix sum decides its gate. The
    plain K2 adds the same fractional requests in the reference's
    XLA:CPU order (`_xla.xla_mask_dot`), so every verdict and every
    prefix sum equals the reference's, bit for bit, and the boundary
    pods are gated both ways; the chain through the wrapper equals it."""
    seg, rank, req, base, limit, boundary = fractional_case(p, p, offset=0.0,
                                                            r=r)
    want, want_cum, got, got_cum, chain = _k2_both(seg, rank, req, base,
                                                   limit)
    assert_bits_equal(got_cum, want_cum)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(chain, want)
    assert 0 < want[boundary].sum() < len(boundary)


@pytest.mark.parametrize("p", [64, 300, 2000, 2048, 2500, 4100])
def test_fractional_gate_boundary_equals_reference_at_one_column(p):
    """Fault C7 at R = 1: XLA:CPU fuses the gate's sum into a vectorised
    loop, whose order depends on P alone (`_xla.fused_matvec_form`: the
    loop unrolled whole and its multiply-adds chained by the backend
    below 320 pods, four accumulators up to 4095, XLA's tiled dot from
    4096). The port's prefix sums equal the sum inside the reference's
    gate (`_gate_and_sum`) bit for bit on every pod, so do the verdicts,
    the boundary pods are gated both ways from 300 pods (at 64 the 40
    segments hold one or two pods, whose sums are exact), and the chain
    through the wrapper equals the plain gate."""
    seg, rank, req, base, limit, boundary = fractional_case(p, p, offset=0.0,
                                                            r=1)
    want, want_cum, got, got_cum, chain = _k2_both(seg, rank, req, base,
                                                   limit)
    assert_bits_equal(got_cum, want_cum)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(chain, got)
    if p >= 300:
        assert 0 < want[boundary].sum() < len(boundary)


@pytest.mark.parametrize("case, exact", [
    ("MiB multiples of 512 above 2^24", True),
    ("whole percents", True),
    ("zeros", True),
    ("a third of a mC", False),
    ("2^24 + 1 in ones", False),
    ("an infinity", False),
], ids=lambda x: x if isinstance(x, str) else None)
def test_order_switch_rule(case, exact):
    """K2's order switch (`exact_in_any_order`): True where every sum of
    the requests is exact in any order (multiples of 2^e summing below
    2^(24 + e), column by column, over every array given), else False;
    the chain on a forced False flag adds in the pinned order and on
    True through the matmul, equal where the rule holds."""
    rng = np.random.default_rng(3)
    req = np.zeros((300, 4), np.float32)
    if case.startswith("MiB"):
        req[:, 1] = 512.0 * rng.integers(1, 256, 300)   # sum above 2^24
        assert req[:, 1].sum() > 2 ** 24
    elif case == "whole percents":
        req[:, 0] = rng.integers(0, 101, 300)
    elif case.startswith("a third"):
        req[:, 0] = rng.integers(1, 4000, 300) / np.float32(3.0)
    elif case.startswith("2^24"):
        req = np.ones((2 ** 24 + 1, 1), np.float32)
    elif case == "an infinity":
        req[7, 2] = np.inf
    got = exact_in_any_order(torch.zeros((0, req.shape[1])),
                             torch.from_numpy(req))
    assert got.dtype == torch.bool and got.shape == (1,)
    assert bool(got) == exact
    if case.startswith("MiB"):
        seg = rng.integers(0, 8, 300).astype(np.int32)
        rank = rng.permutation(300).astype(np.int32)
        t = [torch.from_numpy(x) for x in (seg, rank, req)]
        table = (torch.zeros((8, 4)), torch.full((8, 4), 1.0e6), 8)
        both = [segment_prefix_chain(
            t[0][None], t[1], t[2], torch.ones(300, dtype=torch.bool),
            [table], EPS, exact=torch.tensor([flag])) for flag in (False,
                                                                   True)]
        assert torch.equal(both[0], both[1])
        assert 0 < int(both[0].sum()) < 300


def test_order_switch_checks_its_inputs():
    """The switch's wrapper refuses what its kernel cannot read: no
    array or more than four, another dtype, shapes other than [P, R]
    and [L, P, R], R outside [1, 11] or differing between the arrays."""
    req = torch.zeros((8, 4))
    for bad in ((), (req,) * 5, (req.double(),), (req[0],),
                (torch.zeros((8, 12)),), (req, torch.zeros((8, 3))),
                (torch.zeros((8, 0)),)):
        with pytest.raises((ValueError, TypeError)):
            exact_in_any_order(*bad)
    assert bool(exact_in_any_order(req, req[None].expand(3, 8, 4)))


@pytest.mark.parametrize("form", ["whole", "fractional", "zone take",
                                  "amplified level 0"])
def test_chain_decides_its_own_order_switch(form):
    """A K2 call given no flag decides the order switch itself, on its
    own request arrays (every level of req, and req0): `switch_out`
    gets the verdict, equal to `exact_in_any_order_plain` of those
    arrays, and the gate equals the call given that flag. A flag and
    switch_out together are refused."""
    rng = np.random.default_rng(5)
    p, s = 300, 8
    seg = torch.from_numpy(rng.integers(0, s, (2, p)).astype(np.int32))
    rank = torch.from_numpy(rng.permutation(p).astype(np.int32))
    req = torch.from_numpy((rng.integers(0, 9, (p, 4)) * 500.0).astype(
        np.float32))
    req0 = None
    if form == "fractional":
        req[:, 1] += torch.from_numpy(rng.uniform(0.0, 1.0, p).astype(
            np.float32))
    elif form == "zone take":
        req = req.reshape(p, 2, 2).transpose(0, 1)
    elif form == "amplified level 0":
        req0 = req.clone()
        req0[:, 0] *= 1.5
    r = req.shape[-1]
    table = (torch.zeros((s, r)), torch.full((s, r), 6000.0), s)
    active = torch.ones(p, dtype=torch.bool)
    flag = torch.zeros((1,), dtype=torch.bool)
    got = segment_prefix_chain(seg, rank, req, active, [table] * 2, EPS,
                               req0=req0, switch_out=flag)
    want = exact_in_any_order_plain(
        req, *(() if req0 is None else (req0,)))
    assert bool(flag) == bool(want) == (form != "fractional")
    assert torch.equal(got, segment_prefix_chain(
        seg, rank, req, active, [table] * 2, EPS, req0=req0, exact=want))
    assert 0 < int(got.sum()) < p
    with pytest.raises(ValueError, match="switch_out"):
        segment_prefix_chain(seg, rank, req, active, [table] * 2, EPS,
                             req0=req0, exact=want, switch_out=flag)


def _one_node_fractional(p, seed):
    """A one-node cluster (idle, its CPU and memory allocatable far above
    the batch, so that the load filter passes it at any memory limit)
    and p prod pods with fractional requests (mC / 3, MiB drawn
    from a uniform), in the reference's structs: every pod tries the
    node in the first step, so the node level's segment holds them all."""
    rng = np.random.default_rng(seed)
    snap = jsyn.synthetic_cluster(1, seed=seed)
    pods = jsyn.synthetic_pods(p, seed=seed + 1, prod_frac=1.0)
    req = np.asarray(pods.requests).copy()
    req[:, CPU] = rng.integers(1, 4000, p) / np.float32(3.0)
    req[:, MEM] = rng.uniform(0.1, 2048.0, p).astype(np.float32)
    alloc = np.asarray(snap.nodes.allocatable).copy()
    alloc[0, [CPU, MEM]] = 1.0e7
    nodes = snap.nodes
    idle = {k: jnp.zeros_like(getattr(nodes, k))
            for k in ("usage", "prod_usage", "agg_usage")}
    return (snap.replace(nodes=nodes.replace(
        allocatable=jnp.asarray(alloc), **idle)),
            pods.replace(requests=jnp.asarray(req)))


@pytest.mark.parametrize("p, fit_dims", [(300, (0, 1, 2, 3)), (300, None),
                                         (2048, (0, 1, 2, 3))],
                         ids=["300-R4", "300-R11", "2048-R4"])
def test_fractional_batch_boundary_equals_reference(p, fit_dims):
    """Fault C7 inside the reference's jitted `schedule_batch`, where
    the gate's matmul sits among the rest of the step: one node whose
    memory limit is set on a pod's boundary, with the left side summed
    in the pinned order (`_xla.xla_mask_dot`), and then one step below
    it, for boundary pods where the rank order's sum differs (a gate in
    rank order would decide the pod the other way at one of the two).
    Both packages schedule the batch with config 4's step: every field
    equal, bit for bit, and the boundary pod placed at its limit."""
    jsnap, jpods = _one_node_fractional(p, p)
    kw = dict(configs.CONFIG_4_KW, fit_dims=fit_dims)
    pods = to_port("PodBatch", jpods)
    rank = rank_by_priority(pods)
    req = pods.requests if fit_dims is None else pods.requests[:, list(
        fit_dims)]
    cum = xla_mask_dot(rank[None, :] < rank[:, None], req)[:, MEM].numpy()
    order = np.argsort(rank.numpy())
    mem = req[:, MEM].numpy()
    cum_rank = np.zeros(p, np.float32)
    cum_rank[order[1:]] = np.cumsum(mem[order][:-1], dtype=np.float32)
    base = np.float32(np.asarray(jsnap.nodes.requested)[0, MEM])
    lhs = ((base + cum).astype(np.float32) + mem).astype(np.float32)
    lhs_rank = ((base + cum_rank).astype(np.float32) + mem).astype(np.float32)
    middle = order[p // 4:3 * p // 4]
    boundary = middle[lhs_rank[middle] != lhs[middle]][:3]
    assert len(boundary) > 0
    eps = np.float32(EPS)
    for k in boundary:
        lim = np.float32(lhs[k] - eps)
        while np.float32(lim + eps) < lhs[k]:
            lim = np.nextafter(lim, np.float32(np.inf))
        while np.float32(lim + eps) > lhs[k]:
            lim = np.nextafter(lim, np.float32(-np.inf))
        below = lim
        while np.float32(below + eps) >= lhs[k]:
            below = np.nextafter(below, np.float32(-np.inf))
        for limit, placed in ((lim, True), (below, None)):
            alloc = np.asarray(jsnap.nodes.allocatable).copy()
            alloc[0, MEM] = limit
            snap = jsnap.replace(nodes=jsnap.nodes.replace(
                allocatable=jnp.asarray(alloc)))
            want = jcore.schedule_batch(snap, jpods, JCfg.make(), **kw)
            got = core.schedule_batch(to_port("ClusterSnapshot", snap), pods,
                                      LoadAwareConfig.make(device="cpu"),
                                      **kw)
            assert_bits_equal(tree(got), ref_tree(want))
            if placed:
                assert int(got.assignment[k]) == 0


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
