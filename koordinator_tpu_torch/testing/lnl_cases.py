"""K11's edge cases (the LowNodeLoad plan's classification and
eviction order), as numpy columns that the reference's `_plan_prelude`
and the port's `lnl_eviction_order` both take. `tests/
test_torch_descheduler.py` holds the plain version against the
reference on each at a small size; `chip_smoke.py check_lnl` holds the
kernel against the plain version on each on the card, on `big` (N =
10 000 nodes, P = 300 000 pods: past the old kernel's 32-bit key
field) and on `pending` at `BLOCK_EDGES`.

Each case is a dict of the plan's columns: usage and capacity f32[N,
11], fresh and source_mask bool[N], pod_node i32[P] (-1 nodeless),
pod_usage_r f32[P, 2], pod_req f32[P, 11], pod_eligible bool[P], low,
high and weights f32[2], rdims i32[2] and rdims_onehot f32[2, 11] (the
threshold dims CPU and memory), fit_dims, and `deviation` (the mode
the case runs in)."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

R = 11
RDIMS = (0, 1)


def base_columns(n: int, p: int, seed: int) -> Dict[str, np.ndarray]:
    """N nodes at usage uniform in 5-95 % of 64 cores and 256 GiB, a
    tenth of them tied on usage with node 0 (sources tied on their
    weighted usage), every node fresh and allowed as a source; P pods
    spread over the nodes (sorted by node, a few nodeless), requests in
    whole 500 mC / 500 MiB, a fifth of them zero; thresholds 45/60 low,
    65/80 high, weights 1."""
    rng = np.random.default_rng(seed)
    cap = np.full((n, R), 64000.0, np.float32)
    cap[:, 1] = 262144.0
    frac = rng.uniform(0.05, 0.95, (n, R)).astype(np.float32)
    frac[rng.uniform(size=n) < 0.1] = frac[0]
    usage = (cap * frac).astype(np.float32)
    pod_node = np.sort(rng.integers(-1, n, p)).astype(np.int32)
    pur = (rng.integers(0, 8, (p, 2)) * 500.0).astype(np.float32)
    pur[rng.uniform(size=p) < 0.2] = 0.0
    req = np.zeros((p, R), np.float32)
    req[:, :2] = pur
    onehot = np.zeros((len(RDIMS), R), np.float32)
    onehot[np.arange(len(RDIMS)), RDIMS] = 1.0
    return dict(usage=usage, capacity=cap, fresh=np.ones(n, bool),
                source_mask=np.ones(n, bool), pod_node=pod_node,
                pod_usage_r=pur, pod_req=req,
                pod_eligible=rng.uniform(size=p) < 0.9,
                low=np.array([45, 60], np.float32),
                high=np.array([65, 80], np.float32),
                weights=np.ones(2, np.float32),
                rdims=np.array(RDIMS, np.int32), rdims_onehot=onehot,
                fit_dims=(0, 1), deviation=False)


def hot_node(n, p, seed):
    """Every pod on one source node: one bucket holds all P pods."""
    c = base_columns(n, p, seed)
    c["usage"][3, :2] = c["capacity"][3, :2] * np.float32(0.97)
    c["pod_node"][:] = 3
    return c


def nodeless(n, p, seed):
    """Every pod on no node: all in the last bucket, none active."""
    c = base_columns(n, p, seed)
    c["pod_node"][:] = -1
    return c


def no_source(n, p, seed):
    """No node may be a source (the anomaly gate holds them all)."""
    c = base_columns(n, p, seed)
    c["source_mask"][:] = False
    return c


def one_source(n, p, seed):
    """Exactly one node over the high thresholds."""
    c = base_columns(n, p, seed)
    c["usage"] = (c["capacity"] * np.float32(0.5)).astype(np.float32)
    c["usage"][n // 2, 0] = c["capacity"][n // 2, 0] * np.float32(0.9)
    return c


def signed_zeros(n, p, seed):
    """Pods tied on their weighted usage: zero requests, requests that
    cancel under weights 1 and -1 (an exact zero), and equal nonzero
    ones; -w is -0.0 for every zero (the fused chain never yields
    -0.0), which the sort key compares equal to +0.0, so the ties break
    by index. Sources tied on their weighted usage% likewise."""
    c = base_columns(n, p, seed)
    c["weights"] = np.array([1.0, -1.0], np.float32)
    rng = np.random.default_rng(seed + 1)
    kind = rng.integers(0, 3, p)
    v = (rng.integers(1, 4, p) * 500.0).astype(np.float32)
    c["pod_usage_r"][:] = 0.0
    c["pod_usage_r"][kind == 1] = v[kind == 1, None]
    c["pod_usage_r"][kind == 2, 0] = 1500.0
    c["pod_usage_r"][kind == 2, 1] = 500.0
    c["usage"][: n // 2] = c["usage"][0]
    return c


def deviation(n, p, seed):
    """Deviation mode: thresholds 10/10 around the fresh nodes'
    average, a tenth of the nodes stale."""
    c = base_columns(n, p, seed)
    c["fresh"] = np.random.default_rng(seed + 2).uniform(size=n) >= 0.1
    c["low"] = np.array([10, 10], np.float32)
    c["high"] = np.array([10, 5], np.float32)
    c["deviation"] = True
    return c


def one_pod(n, p, seed):
    """P = 1, on a source."""
    c = hot_node(n, 1, seed)
    c["pod_eligible"][:] = True
    return c


def pending(n, p, seed):
    """A quarter of the pods, pod 0 among them, on no node (the
    scheduler's pending pods): the nodeless bucket is never empty."""
    c = base_columns(n, p, seed)
    c["pod_node"][np.random.default_rng(seed + 3).uniform(size=p) < 0.25] = -1
    c["pod_node"][0] = -1
    return c


CASES: Dict[str, Callable[[int, int, int], Dict[str, np.ndarray]]] = {
    "hot node": hot_node, "nodeless": nodeless, "no source": no_source,
    "one source": one_source, "signed zeros": signed_zeros,
    "deviation": deviation, "P=1": one_pod}
# (N, P): the tests' size; the card's; the shape past the old 32-bit
# key field (bit_length(N) + bit_length(P - 1) = 14 + 19 = 33)
SMALL = (70, 400)
CARD = (10_000, 11_796)
BIG = (10_000, 300_000)
# (N, P) for `pending` where the N + 1 buckets fill whole blocks of the
# kernel's 1024 threads, so that no bucket's thread lies past the last
BLOCK_EDGES = ((1023, 1), (1023, 600), (2047, 1), (2047, 600))


def big(seed: int = 0) -> Dict[str, np.ndarray]:
    """N = 10 000, P = 300 000: 30 pods a node on average."""
    return base_columns(*BIG, seed)


def k11_args(c: Dict[str, np.ndarray]):
    """The numpy arrays of `lnl_eviction_order`'s positional arguments,
    in order, and the mode."""
    return tuple(c[k] for k in (
        "usage", "capacity", "fresh", "source_mask", "pod_node",
        "pod_usage_r", "pod_eligible", "low", "high", "weights",
        "rdims")), bool(c["deviation"])
