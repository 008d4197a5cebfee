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
    got = batching.segment_prefix_ok(
        torch.from_numpy(seg), rank, torch.from_numpy(req),
        torch.from_numpy(base), torch.from_numpy(limit), S,
        batching.EPS).numpy()
    np.testing.assert_array_equal(got, want)


def test_segment_prefix_ok_wrapper_checks_its_inputs():
    seg = torch.zeros(4, dtype=torch.int64)
    rank = torch.arange(4, dtype=torch.int32)
    req = torch.zeros((4, 2))
    table = torch.zeros((3, 2))
    with pytest.raises(TypeError, match="seg"):
        batching.segment_prefix_ok(seg, rank, req, table, table, 3, 0.5)
    with pytest.raises(ValueError, match="limit"):
        batching.segment_prefix_ok(seg.int(), rank, req, table,
                                   torch.zeros((2, 2)), 3, 0.5)
