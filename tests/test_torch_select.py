"""K1's and K3's plain versions against the JAX programs they replace:
the round's fit/score/jitter/mask/top-k (core.py:565-742) and the
`.at[].add(mode="drop")` commits."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.scheduler.plugins import loadaware as jla
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch.kernels.scatter import (
    ordered_scatter_add,
    ordered_scatter_add_plain,
)
from koordinator_tpu_torch.kernels.score_topk import score_topk
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.scheduler.plugins import loadaware

from torch_port_ref import to_port

FIT_DIMS = (0, 1, 2, 3)
SCORE_DIMS = (0, 1)


@functools.partial(jax.jit, static_argnames=("k", "tie_break"))
def reference_select(nodes, pods, cfg, static_ok, row_ok, *, k, tie_break):
    """The round prologue of koordinator_tpu/scheduler/core.py
    schedule_batch, restated for one call (no slot columns)."""
    fd = list(FIT_DIMS)
    fit = jnp.all(pods.requests[:, None, fd] + nodes.requested[None][..., fd]
                  <= nodes.allocatable[None][..., fd] + EPS, axis=-1)
    feasible = fit & static_ok & row_ok[:, None]
    scores = jla.score_matrix(nodes, pods, cfg, SCORE_DIMS)
    if tie_break:
        p, n = scores.shape
        pi = jnp.arange(p, dtype=jnp.uint32)[:, None]
        ni = jnp.arange(n, dtype=jnp.uint32)[None, :]
        h = (pi * jnp.uint32(2654435761) + ni * jnp.uint32(40503)) & 1023
        scores = scores + h.astype(jnp.float32) * (0.49 / 1024.0)
    masked = jnp.where(feasible, scores, -1.0)
    return jax.lax.top_k(masked, k)


def _case(seed, p, n, dup_nodes):
    """Nodes partly filled; with dup_nodes, groups of identical node
    columns so that many pairs tie exactly."""
    rng = np.random.default_rng(seed)
    snap = jsyn.synthetic_cluster(n, seed=seed)
    nodes = snap.nodes
    if dup_nodes:
        src = np.arange(n) // 4 * 4
        nodes = nodes.replace(**{
            f: np.asarray(getattr(nodes, f))[src]
            for f in ("allocatable", "usage", "prod_usage", "agg_usage")})
    alloc = np.asarray(nodes.allocatable)
    requested = (np.floor(rng.uniform(0, 0.97, alloc.shape) * alloc / 500)
                 * 500).astype(np.float32)
    nodes = nodes.replace(requested=requested)
    pods = jsyn.synthetic_pods(p, seed=seed + 7)
    static_ok = rng.uniform(size=(p, n)) < 0.85
    row_ok = rng.uniform(size=p) < 0.8
    return nodes, pods, static_ok, row_ok


@pytest.mark.parametrize("tie_break", [True, False])
@pytest.mark.parametrize("k,dup", [(8, False), (8, True), (32, True)])
def test_score_topk_plain_equals_reference(tie_break, k, dup):
    nodes, pods, static_ok, row_ok = _case(3, 96, 64, dup)
    jcfg = jla.LoadAwareConfig.make()
    want_val, want_idx = reference_select(
        nodes, pods, jcfg, jnp.asarray(static_ok), jnp.asarray(row_ok),
        k=k, tie_break=tie_break)
    want_val, want_idx = np.asarray(want_val), np.asarray(want_idx)

    cfg = loadaware.LoadAwareConfig.make(device="cpu")
    tn, tp = to_port("NodeState", nodes), to_port("PodBatch", pods)
    node_term, prod_term, alloc_s, weights = loadaware.score_terms(
        tn, cfg, SCORE_DIMS)
    val, idx = score_topk(
        torch.from_numpy(static_ok), torch.from_numpy(row_ok),
        tp.requests[:, list(FIT_DIMS)].contiguous(),
        tn.requested[:, list(FIT_DIMS)].contiguous(),
        tn.allocatable[:, list(FIT_DIMS)].contiguous(),
        tp.estimated[:, list(SCORE_DIMS)].contiguous(),
        loadaware.prod_scored(tp, cfg), node_term, prod_term, alloc_s,
        tn.metric_fresh, weights, k, tie_break, EPS, fma_sum=True)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert val.numpy().tobytes() == want_val.tobytes()
    # the case has ties beyond the masked -1 entries, infeasible rows,
    # and rows with fewer than k feasible nodes
    assert (want_val == -1.0).all(axis=1).any()
    if not tie_break:
        top = want_val[:, :2]
        assert ((top[:, 0] == top[:, 1]) & (top[:, 0] >= 0)).any()


def test_ordered_scatter_add_plain_is_bit_equal_to_reference():
    """Non-integer rows, repeated targets, dropped indices: the same
    sums, bit for bit, as the reference's CPU scatter."""
    rng = np.random.default_rng(11)
    s, c, p = 50, 11, 4000
    target = (rng.uniform(0, 1e4, (s, c)) + 0.1).astype(np.float32)
    rows = (rng.uniform(0, 300, (p, c)) * np.pi).astype(np.float32)
    idx = rng.integers(0, s + 30, p).astype(np.int32)   # >= s is dropped
    want = np.asarray(jnp.asarray(target).at[idx].add(rows, mode="drop"))
    got = ordered_scatter_add(torch.from_numpy(target), torch.from_numpy(idx),
                              torch.from_numpy(rows)).numpy()
    assert got.tobytes() == want.tobytes()
    # a sequential in-order float32 loop gives the same bits
    seq = target.copy()
    for j in range(p):
        if idx[j] < s:
            seq[idx[j]] = seq[idx[j]] + rows[j]
    assert seq.tobytes() == want.tobytes()
    # and the order matters: summing the rows first would not
    pre = target + np.stack([rows[idx == t].sum(0, dtype=np.float32)
                             for t in range(s)])
    assert pre.tobytes() != want.tobytes()


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_ordered_scatter_add_levels_equal_sequential_reference(levels):
    """idx [L, P]: bit-equal to L reference scatters in a row, with
    non-integer rows, one hot target row (every pod on it at level 0,
    as the quota root takes them), repeats, drops and negative indices
    (numpy's wrap)."""
    rng = np.random.default_rng(20 + levels)
    s, c, p = 40, 11, 3000
    target = (rng.uniform(0, 1e4, (s, c)) + 0.1).astype(np.float32)
    rows = (rng.uniform(0, 300, (p, c)) * np.e).astype(np.float32)
    idx = rng.integers(-3, s + 10, (levels, p)).astype(np.int32)
    idx[0] = np.where(rng.uniform(size=p) < 0.9, 0, idx[0])
    want = jnp.asarray(target)
    for level in idx:
        want = want.at[level].add(rows, mode="drop")
    want = np.asarray(want)
    got = ordered_scatter_add(torch.from_numpy(target),
                              torch.from_numpy(idx),
                              torch.from_numpy(rows)).numpy()
    assert got.tobytes() == want.tobytes()
    if levels > 1:   # the levels' order matters for these rows
        rev = ordered_scatter_add(torch.from_numpy(target),
                                  torch.from_numpy(idx[::-1].copy()),
                                  torch.from_numpy(rows)).numpy()
        assert rev.tobytes() != want.tobytes()


def test_ordered_scatter_add_wraps_negative_indices_as_reference():
    """[-S, 0) names row S + idx, as the reference's `.at[]` does;
    indices below -S and from S up are dropped."""
    rng = np.random.default_rng(30)
    s, c, p = 7, 3, 200
    target = (rng.uniform(0, 1e3, (s, c)) + 0.1).astype(np.float32)
    rows = (rng.uniform(0, 30, (p, c)) * np.pi).astype(np.float32)
    idx = rng.integers(-s - 3, s + 3, p).astype(np.int32)
    assert (idx < -s).any() and ((idx >= -s) & (idx < 0)).any()
    want = np.asarray(jnp.asarray(target).at[idx].add(rows, mode="drop"))
    got = ordered_scatter_add(torch.from_numpy(target), torch.from_numpy(idx),
                              torch.from_numpy(rows)).numpy()
    assert got.tobytes() == want.tobytes()


def test_wrappers_refuse_other_devices():
    t = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ordered_scatter_add(t, torch.zeros(3, dtype=torch.int32,
                                           device="meta"),
                            torch.zeros((3, 2), device="meta"))
    assert ordered_scatter_add_plain(
        torch.zeros((2, 1)), torch.tensor([1, 5, 1], dtype=torch.int32),
        torch.ones((3, 1))).flatten().tolist() == [0.0, 2.0]
