"""Helpers of the tests that hold the PyTorch port (koordinator_tpu_torch)
against the JAX package: a JAX struct is flattened to numpy and handed
to the port's bridge, as the port's own users would carry state over."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from koordinator_tpu_torch.bridge import from_reference, to_numpy


def numpy_tree(x) -> dict:
    """{field: np.ndarray} of a JAX-package struct, nested structs as
    nested dicts, host-side switches (bool/int/str) as they are."""
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = numpy_tree(v)
        elif isinstance(v, (bool, int, str)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def with_zones(snap, z: int, seed: int):
    """The JAX-package snapshot `snap` with z NUMA zones a node, as
    numpy draws from `seed`: each node's cpu and memory split over its
    zones (Dirichlet shares, multiples of 500 mC / 512 MiB), about 15 %
    of the zones invalid (zone 0 valid), zones partly used, every
    topology policy code, the reservations' zone columns z wide with no
    hold, and the GPU instances spread over the zones in index order."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    nodes, resv, dev = snap.nodes, snap.reservations, snap.devices
    alloc = np.asarray(nodes.allocatable)
    n = alloc.shape[0]
    share = rng.dirichlet(np.ones(z), n).astype(np.float32)
    cap = np.zeros((n, z, 2), np.float32)
    cap[:, :, 0] = np.floor(alloc[:, None, 0] * share / 500) * 500
    cap[:, :, 1] = np.floor(alloc[:, None, 1] * share / 512) * 512
    valid = rng.uniform(size=(n, z)) < 0.85
    valid[:, 0] = True
    cap = cap * valid[:, :, None]
    used = np.floor(cap * rng.uniform(0, 0.6, (n, z, 1)) / 500) * 500
    v = np.asarray(resv.numa_free).shape[0]
    numa = np.asarray(dev.gpu_numa)
    i = numa.shape[1]
    spread = np.broadcast_to((np.arange(i) * z // max(i, 1))[None], numa.shape)
    return snap.replace(
        nodes=nodes.replace(
            numa_cap=jnp.asarray(cap),
            numa_free=jnp.asarray((cap - used).astype(np.float32)),
            numa_valid=jnp.asarray(valid),
            numa_policy=jnp.asarray(rng.integers(0, 4, n).astype(np.int32))),
        reservations=resv.replace(
            numa_free=jnp.zeros((v, z, 2), jnp.float32),
            numa_valid=jnp.zeros((v, z), bool)),
        devices=dev.replace(gpu_numa=jnp.asarray(
            np.where(numa >= 0, spread, numa).astype(np.int32))))


def to_port(struct_name: str, x):
    """The port's twin of JAX struct `x`, on the host."""
    return from_reference(struct_name, numpy_tree(x), device="cpu")


def assert_trees_equal(got: dict, want: dict, path: str = "") -> None:
    """Leaf-by-leaf equality (dtype, shape and every value; NaN-free)."""
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_trees_equal(g, w, f"{path}.{k}")
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, \
                (f"{path}.{k}", g.dtype, w.dtype, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=f"{path}.{k}")
        else:
            assert g == w, (f"{path}.{k}", g, w)


def assert_bits_equal(got, want, path=""):
    """Leaf by leaf: same dtype and shape, f32 bit for bit, the rest
    exactly (nested dicts recurse; plain values compare equal)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_bits_equal(got[k], want[k], f"{path}.{k}")
        return
    if not isinstance(want, np.ndarray) and not hasattr(want, "dtype"):
        assert got == want, (path, got, want)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (path, got.dtype, want.dtype, got.shape, want.shape)
    if want.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=path)


def tree(x) -> dict:
    """The port struct's numpy tree without host-side switches."""
    return {k: v for k, v in to_numpy(x).items()
            if isinstance(v, (np.ndarray, dict))}


def ref_tree(x) -> dict:
    return {k: v for k, v in numpy_tree(x).items()
            if isinstance(v, (np.ndarray, dict))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for a test module that imports this
    fixture. The port's plain path runs thousands of small torch ops a
    batch; with the suite's six workers each holding torch's default
    pool (a thread a core), every op waits on the other processes'
    threads: a guarded full-gate batch at 96 nodes took 0.9 s in six
    one-thread processes and 174 s in six default ones."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reference_sweep_and_tail(step, tail_step, snap, pods, cfg, chunk, *,
                             tail_chunk, min_passes, max_passes,
                             topo_prefix=None, topo_mask=None):
    """bench.py's sweep and device tail (:435-496) on the JAX package,
    driven from the host: the sweep a Python loop over the reference's
    own jitted `step` (each chunk's count0 fields the counts so far,
    charged with its assignment after it, as bench.py's scan body
    does), the tail the reference's host-driven tail orchestration
    (tests/test_cascade.py `_host_tail`, held equal to the device
    `tail_compaction_loop` by `test_device_tail_matches_host_tail`).
    One compile of each step instead of the scan-and-while program's:
    XLA:CPU compiles that one in minutes. Returns (snap, counts,
    assignment, stats [after sweep, final, never retried, passes], the
    sweep's res_slot), the arrays as numpy."""
    import jax.numpy as jnp

    from koordinator_tpu.scheduler import core as jcore
    from koordinator_tpu.utils import synthetic as jsyn
    from test_cascade import _host_tail

    stacked = jsyn.stack_pod_chunks(pods, chunk)
    counts = tuple(jnp.asarray(getattr(pods, f)) for f in jcore.COUNT_FIELDS)
    assign, res_slot = [], []
    for c in range(next(iter(stacked.values())).shape[0]):
        batch = pods.replace(**{k: v[c] for k, v in stacked.items()},
                             **dict(zip(jcore.COUNT_FIELDS, counts)))
        res = step(snap, batch, cfg)
        counts = jcore.charge_all_counts(counts, batch, res.assignment)
        snap = res.snapshot
        assign.append(res.assignment)
        res_slot.append(res.res_slot)
    snap, counts, assign, stats = _host_tail(
        tail_step, snap, counts, jnp.concatenate(assign), pods, cfg,
        tail_chunk=tail_chunk, min_passes=min_passes, max_passes=max_passes,
        topo_prefix=topo_prefix, topo_mask=topo_mask)
    return (snap, tuple(np.asarray(c) for c in counts), np.asarray(assign),
            np.asarray(stats), np.concatenate([np.asarray(r)
                                               for r in res_slot]))


def api_to_reference(obj):
    """The reference's counterpart of a port typed host object (the
    inverse of `bridge.api_from_reference`): found by class name in the
    reference's `api.types` or `slo_controller.config` and filled by the
    reference class's fields that the object has; enums carried by
    value, resource lists re-keyed to the reference's ResourceKind."""
    import enum

    from koordinator_tpu.api import extension as jext
    from koordinator_tpu.api import types as jtypes
    from koordinator_tpu.slo_controller import config as jconfig

    if isinstance(obj, dict):
        return {api_to_reference(k): api_to_reference(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(api_to_reference(v) for v in obj)
    if isinstance(obj, enum.Enum):
        cls = (getattr(jext, type(obj).__name__, None)
               or getattr(jconfig, type(obj).__name__))
        return cls(obj.value)
    if not dataclasses.is_dataclass(obj):
        return obj
    name = type(obj).__name__
    cls = getattr(jtypes, name, None) or getattr(jconfig, name)
    have = {f.name for f in dataclasses.fields(obj)}
    return cls(**{f.name: api_to_reference(getattr(obj, f.name))
                  for f in dataclasses.fields(cls) if f.name in have})
