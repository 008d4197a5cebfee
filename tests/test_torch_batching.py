"""The port's priority ranking and segment prefix gate (K2's plain path)
against the JAX package's batching module."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from koordinator_tpu.scheduler import batching as jbatching
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch.scheduler import batching

from torch_port_ref import to_port
from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(-3, 3), min_size=1, max_size=40))
def test_stable_rank_equal_reference(keys):
    key = np.array(keys, np.int32)
    want = np.asarray(jbatching.stable_rank(jnp.asarray(key)))
    got = batching.stable_rank(torch.from_numpy(key)).numpy()
    np.testing.assert_array_equal(got, want)


def test_rank_by_priority_equal_reference():
    jpods = jsyn.synthetic_pods(500, seed=2)
    jpods = jpods.replace(priority=(np.asarray(jpods.priority) // 100
                                    ).astype(np.int32))  # many equal
    want = np.asarray(jbatching.rank_by_priority(jpods))
    got = batching.rank_by_priority(to_port("PodBatch", jpods)).numpy()
    np.testing.assert_array_equal(got, want)


P, R, S = 24, 3, 5


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_segment_prefix_ok_equal_reference(data):
    """Integer-valued inputs (the scheduler's: multiples of 500 mC and
    512 MiB), duplicate segments, out-of-range segments (>= S, and -1)
    and equal priorities."""
    ints = lambda lo, hi, n: np.array(  # noqa: E731
        data.draw(st.lists(st.integers(lo, hi), min_size=n, max_size=n)))
    seg = ints(-1, S + 1, P).astype(np.int32)
    prio = ints(0, 3, P).astype(np.int32)
    req = ints(0, 8, P * R).reshape(P, R).astype(np.float32) * 500.0
    base = ints(0, 20, S * R).reshape(S, R).astype(np.float32) * 500.0
    limit = base + ints(0, 12, S * R).reshape(S, R).astype(np.float32) * 500.0
    jrank = jbatching.stable_rank(jnp.asarray(-prio))
    earlier = jrank[None, :] < jrank[:, None]
    want = np.asarray(jbatching.segment_prefix_ok(
        jnp.asarray(seg), earlier, jnp.asarray(req), jnp.asarray(base),
        jnp.asarray(limit), S))
    rank = batching.stable_rank(torch.from_numpy(-prio))
    # the single-level gate: the chain with L = 1, every pod taking part
    got = batching.segment_prefix_chain(
        torch.from_numpy(seg)[None], rank, torch.from_numpy(req),
        torch.ones(P, dtype=torch.bool),
        [(torch.from_numpy(base), torch.from_numpy(limit), S)],
        batching.EPS).numpy()
    np.testing.assert_array_equal(got, want)


def test_segment_prefix_ok_wrapper_checks_its_inputs():
    seg = torch.zeros((1, 4), dtype=torch.int64)
    rank = torch.arange(4, dtype=torch.int32)
    req = torch.zeros((4, 2))
    active = torch.ones(4, dtype=torch.bool)
    table = torch.zeros((3, 2))
    with pytest.raises(TypeError, match="seg"):
        batching.segment_prefix_chain(seg, rank, req, active,
                                      [(table, table, 3)], 0.5)
    with pytest.raises(ValueError, match="limit"):
        batching.segment_prefix_chain(seg.int(), rank, req, active,
                                      [(table, torch.zeros((2, 2)), 3)], 0.5)


@pytest.mark.parametrize("case", ["duplicate rank", "rank out of range",
                                  "segment below -1"])
def test_segment_prefix_chain_refuses_broken_preconditions(case):
    """The kernel needs rank to be a permutation and active pods'
    segments >= -1 (it stops with a launch failure otherwise); the host
    path raises on the same inputs rather than gate them its own way."""
    p, r = 4, 2
    seg = torch.zeros((1, p), dtype=torch.int32)
    rank = torch.arange(p, dtype=torch.int32)
    active = torch.ones(p, dtype=torch.bool)
    if case == "duplicate rank":
        rank[1] = 0
    elif case == "rank out of range":
        rank[1] = p
    else:
        seg[0, 2] = -2
    table = (torch.zeros((3, r)), torch.ones((3, r)), 3)
    with pytest.raises(ValueError, match="permutation|below -1"):
        batching.segment_prefix_chain(seg, rank, torch.zeros((p, r)),
                                      active, [table], 0.5)
    if case == "segment below -1":   # an inactive pod's segment is not read
        active[2] = False
        batching.segment_prefix_chain(seg, rank, torch.zeros((p, r)),
                                      active, [table], 0.5)


def _reference_chain(seg, earlier, req, active, tables, mask=None):
    """schedule_batch's inner-step gate in the reference: the node level
    on the trying pods (core.py:767-770), the topology gates' verdict
    (`mask`, core.py:776-884) where given, then each quota level on the
    pods accepted so far (core.py:884-890)."""
    accept = jnp.asarray(active)
    for l, (level, (base, limit, s)) in enumerate(zip(seg, tables)):
        seg_l = jnp.where(accept, jnp.asarray(level), s)
        req_l = jnp.where(accept[:, None], jnp.asarray(req), 0.0)
        accept = accept & jbatching.segment_prefix_ok(
            seg_l, earlier, req_l, jnp.asarray(base), jnp.asarray(limit), s)
        if l == 0 and mask is not None:
            accept = accept & jnp.asarray(mask)
    return np.asarray(accept)


@pytest.mark.parametrize("levels", [1, 2, 3])
@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_segment_prefix_chain_equal_reference(levels, data):
    """The chained gate (K2's plain path) against the reference's
    segment_prefix_ok applied level by level with the accept chain:
    integer-valued inputs, levels with their own segment counts, pods
    out of range at some levels, inactive pods and equal priorities."""
    ints = lambda lo, hi, n: np.array(  # noqa: E731
        data.draw(st.lists(st.integers(lo, hi), min_size=n, max_size=n)))
    sizes = [data.draw(st.integers(1, 6)) for _ in range(levels)]
    seg = np.stack([ints(-1, s + 1, P) for s in sizes]).astype(np.int32)
    prio = ints(0, 3, P).astype(np.int32)
    active = ints(0, 4, P) > 0
    req = ints(0, 8, P * R).reshape(P, R).astype(np.float32) * 500.0
    tables = []
    for s in sizes:
        base = ints(0, 20, s * R).reshape(s, R).astype(np.float32) * 500.0
        limit = base + ints(0, 12, s * R).reshape(s, R).astype(
            np.float32) * 500.0
        tables.append((base, limit, s))
    jrank = jbatching.stable_rank(jnp.asarray(-prio))
    want = _reference_chain(seg, jrank[None, :] < jrank[:, None], req,
                            active, tables)
    got = batching.segment_prefix_chain(
        torch.from_numpy(seg), batching.stable_rank(torch.from_numpy(-prio)),
        torch.from_numpy(req), torch.from_numpy(active),
        [(torch.from_numpy(b), torch.from_numpy(lim), s)
         for b, lim, s in tables], batching.EPS).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("levels", [1, 2, 3])
@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_segment_prefix_chain_mask_after_level_0_equal_reference(levels,
                                                                 data):
    """The chain with the step's topology verdict ANDed in after the
    node level: the node level charges every active pod, the quota
    levels only those that pass both (the reference's order of gates)."""
    ints = lambda lo, hi, n: np.array(  # noqa: E731
        data.draw(st.lists(st.integers(lo, hi), min_size=n, max_size=n)))
    sizes = [data.draw(st.integers(1, 6)) for _ in range(levels)]
    seg = np.stack([ints(-1, s + 1, P) for s in sizes]).astype(np.int32)
    prio = ints(0, 3, P).astype(np.int32)
    active = ints(0, 4, P) > 0
    mask = ints(0, 2, P) > 0
    req = ints(0, 8, P * R).reshape(P, R).astype(np.float32) * 500.0
    tables = []
    for s in sizes:
        base = ints(0, 20, s * R).reshape(s, R).astype(np.float32) * 500.0
        limit = base + ints(0, 8, s * R).reshape(s, R).astype(
            np.float32) * 500.0
        tables.append((base, limit, s))
    jrank = jbatching.stable_rank(jnp.asarray(-prio))
    want = _reference_chain(seg, jrank[None, :] < jrank[:, None], req,
                            active, tables, mask)
    got = batching.segment_prefix_chain(
        torch.from_numpy(seg), batching.stable_rank(torch.from_numpy(-prio)),
        torch.from_numpy(req), torch.from_numpy(active),
        [(torch.from_numpy(b), torch.from_numpy(lim), s)
         for b, lim, s in tables], batching.EPS,
        torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)


def test_segment_prefix_chain_checks_its_inputs():
    p, r = 4, 2
    rank = torch.arange(p, dtype=torch.int32)
    req = torch.zeros((p, r))
    active = torch.ones(p, dtype=torch.bool)
    table = (torch.zeros((3, r)), torch.zeros((3, r)), 3)
    seg = torch.zeros((2, p), dtype=torch.int32)
    with pytest.raises(ValueError, match="seg"):   # 2 levels, 1 table
        batching.segment_prefix_chain(seg, rank, req, active, [table], 0.5)
    with pytest.raises(TypeError, match="active"):
        batching.segment_prefix_chain(seg, rank, req, active.int(),
                                      [table] * 2, 0.5)
    with pytest.raises(ValueError, match="mask"):
        batching.segment_prefix_chain(seg, rank, req, active, [table] * 2,
                                      0.5, torch.ones(p + 1, dtype=torch.bool))
    with pytest.raises(ValueError, match="a mask needs a level"):
        batching.segment_prefix_chain(seg[:0], rank, req, active, [], 0.5,
                                      active)
    with pytest.raises(ValueError, match=r"base\[1\]"):
        batching.segment_prefix_chain(
            seg, rank, req, active,
            [table, (torch.zeros((2, r)), torch.zeros((3, r)), 3)], 0.5)
    meta = [t.to("meta") for t in (seg, rank, req, active)]
    with pytest.raises(ValueError, match="unsupported device"):
        batching.segment_prefix_chain(
            *meta, [(torch.zeros((3, r), device="meta"),) * 2 + (3,)] * 2,
            0.5)


@pytest.mark.parametrize("zones", [2, 4])
@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_segment_prefix_chain_per_level_requests_equal_reference(zones, data):
    """The zone gates of a NUMA step as one chained call (K2's plain
    path): per-level requests req[z] = each pod's take in zone z, read
    in place from the [P, Z, 2] take (a strided view), and each level's
    base and limit a zone's columns of the [S, Z * 2] zone tables (a
    strided view), against the reference's per-zone loop of
    segment_prefix_ok (core.py:949-956), each zone seeing the previous
    zone's gate."""
    ints = lambda lo, hi, n: np.array(  # noqa: E731
        data.draw(st.lists(st.integers(lo, hi), min_size=n, max_size=n)))
    s = data.draw(st.integers(1, 6))
    choice = ints(0, s, P).astype(np.int32)          # s: not trying
    prio = ints(0, 3, P).astype(np.int32)
    acc = (ints(0, 4, P) > 0) & (choice < s)
    engaged = ints(0, 3, P) > 0
    take = ints(0, 6, P * zones * 2).reshape(P, zones, 2).astype(
        np.float32) * 500.0
    used = ints(0, 20, s * zones * 2).reshape(s, zones, 2).astype(
        np.float32) * 500.0
    cap = used + ints(0, 12, s * zones * 2).reshape(s, zones, 2).astype(
        np.float32) * 500.0
    jrank = jbatching.stable_rank(jnp.asarray(-prio))
    earlier = jrank[None, :] < jrank[:, None]
    want = jnp.asarray(acc)
    for z in range(zones):
        znow = want & jnp.asarray(engaged)
        zseg = jnp.where(znow, jnp.asarray(choice), s)
        want = want & jbatching.segment_prefix_ok(
            zseg, earlier, jnp.asarray(take[:, z, :]) * znow[:, None],
            jnp.asarray(used[:, z, :]), jnp.asarray(cap[:, z, :]), s)
    used_t = torch.from_numpy(used).reshape(s, zones * 2)
    cap_t = torch.from_numpy(cap).reshape(s, zones * 2)
    alive = batching.segment_prefix_chain(
        torch.from_numpy(choice)[None].expand(zones, P).contiguous(),
        batching.stable_rank(torch.from_numpy(-prio)),
        torch.from_numpy(take).transpose(0, 1),
        torch.from_numpy(acc & engaged),
        [(used_t[:, 2 * z:2 * z + 2], cap_t[:, 2 * z:2 * z + 2], s)
         for z in range(zones)], batching.EPS)
    got = (torch.from_numpy(acc & ~engaged) | alive).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


def test_segment_prefix_chain_checks_per_level_inputs():
    p, r = 4, 2
    rank = torch.arange(p, dtype=torch.int32)
    active = torch.ones(p, dtype=torch.bool)
    seg = torch.zeros((2, p), dtype=torch.int32)
    table = (torch.zeros((3, r)), torch.ones((3, r)), 3)
    with pytest.raises(ValueError, match="req"):   # 3 levels of requests
        batching.segment_prefix_chain(seg, rank, torch.zeros((3, p, r)),
                                      active, [table] * 2, 0.5)
    wide = torch.zeros((3, 2 * r))
    with pytest.raises(ValueError, match="column stride"):
        batching.segment_prefix_chain(seg, rank, torch.zeros((2, p, r)),
                                      active, [(wide[:, ::2], wide[:, ::2],
                                                3)] * 2, 0.5)
    with pytest.raises(ValueError, match="req: needs unit column stride"):
        batching.segment_prefix_chain(
            seg, rank, torch.zeros((2, p, 2 * r))[:, :, ::2], active,
            [table] * 2, 0.5)
    with pytest.raises(ValueError, match="row strides"):
        batching.segment_prefix_chain(
            seg, rank, torch.zeros((2, p, r)), active,
            [(wide[:, :r], torch.ones((3, r)), 3)] * 2, 0.5)
    got = batching.segment_prefix_chain(
        seg, rank, torch.zeros((2, p, r)), active,
        [(wide[:, :r], wide[:, r:], 3)] * 2, 0.5)
    assert bool(got.all())   # limit 0 + eps admits a zero request
