"""K3 `ordered_scatter_add_many` and its one-group form on the CPU: the
grouped plain version against separate plain calls and the reference's
`.at[].add(mode="drop")`, the descriptor the kernel takes (shapes,
pointers, the blocks of each group and their prefix), the wrapper's
refusals, the order-sensitive hot-row case that `chip_smoke.py` holds
the card to, and the grouped calls of one `schedule_batch`: one an
inner step, one a round, one for the batch's rebuild."""

from __future__ import annotations

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from koordinator_tpu_torch.kernels import scatter
from koordinator_tpu_torch.kernels.scatter import (
    MAX_GROUPS,
    group_blocks,
    ordered_scatter_add,
    ordered_scatter_add_many,
    ordered_scatter_add_plain,
    pack_groups,
)
from koordinator_tpu_torch.scheduler import core
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.testing.scatter_cases import hot_row_case
from koordinator_tpu_torch.utils import synthetic

from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)


def _group(rng, s, c, levels, p, hot=False):
    """(target, idx, rows) as numpy: fractional rows, indices with
    repeats, drops above S and below -S, and negatives that wrap; a hot
    row (row 0, or -S, its wrapped name) takes most of level 0."""
    target = (rng.uniform(0, 1e4, (s, c)) + 0.1).astype(np.float32)
    rows = (rng.uniform(0, 300, (p, c)) * np.pi).astype(np.float32)
    shape = (p,) if levels == 0 else (levels, p)
    idx = rng.integers(-s - 3, s + 4, shape).astype(np.int32)
    if hot and p and s:
        first = idx if levels == 0 else idx[0]
        first[:] = np.where(rng.uniform(size=p) < 0.8,
                            rng.choice([0, -s], p), first)
    return target, idx, rows


def _torch(group):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in group)


def _reference(target, idx, rows):
    """The reference's scatters: one `.at[].add(mode="drop")` a level,
    on XLA:CPU."""
    want = jnp.asarray(target)
    for level in (idx[None] if idx.ndim == 1 else idx):
        want = want.at[level].add(rows, mode="drop")
    return np.asarray(want)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 40), st.integers(1, 6),
                          st.integers(0, 3), st.integers(0, 60),
                          st.booleans()),
                min_size=1, max_size=6),
       st.integers(0, 2 ** 31 - 1))
def test_grouped_plain_equals_separate_plain_calls(shapes, seed):
    """Groups of mixed S, C, L (0: a one-dimensional index) and P, P = 0
    and S = 0 included, with negative, dropped and hot indices: the
    grouped form's outputs equal one `ordered_scatter_add_plain` call a
    group, bit for bit, and new tensors (the targets are unchanged)."""
    rng = np.random.default_rng(seed)
    groups = [_torch(_group(rng, *shape)) for shape in shapes]
    before = [t.clone() for t, _, _ in groups]
    got = ordered_scatter_add_many(groups)
    assert len(got) == len(groups)
    for out, (t, i, r), t0 in zip(got, groups, before):
        want = ordered_scatter_add_plain(t, i, r)
        assert out.shape == t.shape
        assert out.numpy().tobytes() == want.numpy().tobytes()
        assert torch.equal(t, t0)
        assert not t.numel() or out.data_ptr() != t.data_ptr()


@pytest.mark.parametrize("case", ["step", "fold", "levels"])
def test_grouped_form_equals_reference(case):
    """Cases whose outputs equal the reference's `.at[].add` on XLA:CPU
    bit for bit: a step's mix (a node table, a two-level quota table
    with a hot root, a count table of ones), the fair-share fold (one
    level of 5000 pods into 512 rows), and three levels with wraps and
    drops into a narrow table."""
    rng = np.random.default_rng({"step": 1, "fold": 2, "levels": 3}[case])
    if case == "step":
        shapes = [(500, 11, 0, 400, False), (24, 11, 2, 400, True),
                  (1600, 1, 4, 400, False)]
    elif case == "fold":
        shapes = [(512, 11, 0, 5000, False)]
    else:
        shapes = [(7, 3, 3, 300, True)]
    groups = [_group(rng, *shape) for shape in shapes]
    if case == "step":
        groups[2] = (np.round(groups[2][0]), groups[2][1],
                     np.ones_like(groups[2][2]))
    got = ordered_scatter_add_many([_torch(g) for g in groups])
    for out, g in zip(got, groups):
        assert out.numpy().tobytes() == _reference(*g).tobytes()


def test_hot_row_case_is_order_sensitive():
    """`testing.scatter_cases.hot_row_case`, the card's order check: the
    hot row's adds in reverse give other bits (so an order fault shows),
    while the plain version and the one-group and grouped forms give the
    sequential f32 loop's bits, which are the reference's."""
    for p in (300, 2000):
        target, idx, rows = hot_row_case(p, seed=p)
        s = target.shape[0]
        wrapped = np.where(idx < 0, idx + s, idx)
        seq, rev = target.copy(), target.copy()
        for j in range(p):
            if 0 <= wrapped[j] < s:
                seq[wrapped[j]] = seq[wrapped[j]] + rows[j]
        for j in reversed(range(p)):
            if 0 <= wrapped[j] < s:
                rev[wrapped[j]] = rev[wrapped[j]] + rows[j]
        assert (seq[0] != rev[0]).any()
        assert (wrapped == 0).sum() > p // 2
        t = _torch((target, idx, rows))
        one = ordered_scatter_add(*t).numpy()
        many = ordered_scatter_add_many([t, _torch(hot_row_case(50, seed=1))])
        for got in (one, many[0].numpy()):
            assert got.tobytes() == seq.tobytes()
        if p == 300:
            assert seq.tobytes() == _reference(target, idx, rows).tobytes()


@pytest.mark.parametrize("s, c, levels, p, blocks, rb", [
    (160_000, 1, 16, 2000, 63, 2540),     # the count commit
    (10_064, 11, 1, 2000, 111, 91),       # the node commit
    (64, 11, 2, 2000, 8, 8),              # the quota commit
    (512, 11, 1, 50_000, 86, 6),          # the fair-share fold
    (64, 24, 2, 2500, 10, 7),             # the reservation rebuild
    (100_000, 32, 1, 10, 264, 379),       # at most _MAX_BLOCKS
    (5, 3, 1, 100_000, 5, 1),             # at most S
    (0, 11, 1, 2000, 0, 1),               # nothing to own
    (40, 0, 1, 2000, 0, 1),
    (300, 4, 1, 0, 150, 2),               # no index: a copy
])
def test_group_blocks_rule(s, c, levels, p, blocks, rb):
    """The blocks a group takes and the target rows each owns, from the
    shapes alone: about as many index bytes read as target bytes read
    and written, and a block for each 512 indices, within [1, min(S,
    264)]; every row owned once."""
    assert group_blocks(s, c, levels, p) == (blocks, rb)
    if blocks:
        assert (blocks - 1) * rb < s <= blocks * rb


def test_pack_groups_descriptor():
    """The kernel's parameter struct: pointers and shapes of each group
    (a one-dimensional index is one level), each group's first block the
    prefix of the earlier groups' block counts (an empty target takes
    none), and the launch's total."""
    rng = np.random.default_rng(5)
    groups = [_torch(_group(rng, *shape)) for shape in
              [(10_064, 11, 0, 2000, False), (0, 4, 0, 10, False),
               (64, 11, 2, 2000, True), (160_000, 1, 16, 2000, False)]]
    outs = [torch.empty_like(t) for t, _, _ in groups]
    desc = pack_groups(groups, outs)
    assert desc.n == 4
    block0 = 0
    for k, ((t, i, r), o) in enumerate(zip(groups, outs)):
        g = desc.g[k]
        levels = 1 if i.dim() == 1 else i.shape[0]
        blocks, rb = group_blocks(t.shape[0], t.shape[1], levels,
                                  r.shape[0])
        # ctypes reads a null pointer (an empty tensor's) as None
        assert tuple(x or 0 for x in (g.target, g.idx, g.rows, g.out)) == (
            t.data_ptr(), i.data_ptr(), r.data_ptr(), o.data_ptr())
        assert (g.S, g.C, g.P, g.L, g.rb, g.block0) == (
            t.shape[0] if blocks else 0, t.shape[1], r.shape[0], levels, rb,
            block0)
        block0 += blocks
    assert desc.blocks == block0 == 111 + 8 + 63
    # the C struct's layout: two ints, then 56-byte groups
    assert scatter._Groups.g.offset == 8
    assert ctypes.sizeof(scatter._Group) == 56


def test_grouped_form_refuses_overlap_and_capacity():
    """Two targets that share memory (the same tensor, or overlapping
    views of one buffer) raise; adjacent views do not; more than
    MAX_GROUPS groups raise; so does a mixed device."""
    buf = torch.zeros((40, 2))
    idx = torch.tensor([0, 1, 5], dtype=torch.int32)
    rows = torch.ones((3, 2))
    with pytest.raises(ValueError, match="overlap"):
        ordered_scatter_add_many([(buf, idx, rows), (buf, idx, rows)])
    with pytest.raises(ValueError, match="overlap"):
        ordered_scatter_add_many([(buf[:20], idx, rows),
                                  (buf[19:30], idx, rows)])
    a, b = ordered_scatter_add_many([(buf[:20], idx, rows),
                                     (buf[20:], idx, rows)])
    assert a[0, 0] == 1.0 and b[5, 1] == 1.0 and buf.sum() == 0.0
    many = [(torch.zeros((2, 1)), idx[:1], rows[:1, :1])
            for _ in range(MAX_GROUPS + 1)]
    with pytest.raises(ValueError, match="at most 32"):
        ordered_scatter_add_many(many)
    assert len(ordered_scatter_add_many(many[:MAX_GROUPS])) == MAX_GROUPS
    with pytest.raises(ValueError, match="expected"):
        ordered_scatter_add_many([(buf, idx, rows),
                                  (torch.zeros((2, 2), device="meta"), idx,
                                   rows)])


def test_schedule_batch_makes_one_grouped_call_a_step_a_round_and_a_batch():
    """A gpu_share-like batch (the full gate's cluster and pods: NUMA
    zones, GPU instances, reservation slots, quotas, gangs, spread,
    anti-affinity and affinity families) on the CPU path: K3 is called
    once an inner step (every commit of the step), once a round (the
    estimates, the gang counts; the first round also the batch's gang
    attempts) and once for the rebuild (with the reservation slots')."""
    snap = synthetic.full_gate_cluster(120, seed=0, device="cpu")
    pods = synthetic.full_gate_pods(600, 120, seed=1, device="cpu")
    assert pods.has_spread and pods.has_anti and pods.has_aff
    assert snap.reservations.valid.any() and snap.devices.num_instances
    rounds, k = 2, 3
    scatter.ordered_scatter_add.calls = 0
    res = core.schedule_batch(snap, pods, LoadAwareConfig.make(device="cpu"),
                              num_rounds=rounds, k_choices=k)
    assert scatter.ordered_scatter_add.calls == rounds * k + rounds + 1
    assert (res.assignment >= 0).any() and res.gpu_take.any()
