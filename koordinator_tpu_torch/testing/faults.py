"""Seeded, deterministic fault injectors: the column corruptions that
the device health guards must catch, and stale delta stamps that the
store's version guard must refuse.

Counterpart of `koordinator_tpu/testing/faults.py` (:28-164): the same
fault lists, expected guard bits and `default_rng(seed)` draws in the
same order, so that a seed corrupts the same rows in both packages. The
edits run with torch on the tensors' own device (the rows are drawn on
the host); only `bad_domain_index` reads a carrier column back to name
the rows it poisons. The runtime faults and crash points of the
reference are hooks of the service's degradation ladder and journal,
which the port does not have yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.scheduler import guards

SNAPSHOT_FAULTS = ("nan_metric_column", "negative_allocatable",
                   "overcommit_row", "numa_free_above_cap")
BATCH_FAULTS = ("nan_pod_request", "negative_pod_request",
                "bad_gang_id", "bad_domain_index")
DELTA_FAULTS = ("stale_delta",)

# fault class -> the guard-word bit its detection sets
EXPECTED_BIT = {
    "nan_metric_column": guards.NODE_METRIC_NONFINITE,
    "negative_allocatable": guards.NODE_BAD_ALLOCATABLE,
    "overcommit_row": guards.NODE_OVERCOMMIT,
    "numa_free_above_cap": guards.NODE_NUMA_INVALID,
    "nan_pod_request": guards.POD_NONFINITE,
    "negative_pod_request": guards.POD_NEGATIVE,
    "bad_gang_id": guards.POD_ID_RANGE,
    "bad_domain_index": guards.POD_DOMAIN_RANGE,
}


def _index(rows: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(rows, dtype=torch.long, device=like.device)


class FaultInjector:
    """One seeded source of faults; every choice draws from the seed."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def _rows(self, n: int, n_rows: int) -> np.ndarray:
        return np.sort(self.rng.choice(n, size=min(n_rows, n),
                                       replace=False))

    def corrupt_snapshot(self, snap, kind: str,
                         n_rows: int = 1) -> Tuple[object, np.ndarray]:
        """-> (corrupted snapshot, corrupted node row indices)."""
        nodes = snap.nodes
        rows = self._rows(nodes.schedulable.shape[0], n_rows)
        at = _index(rows, nodes.schedulable)
        if kind == "nan_metric_column":
            usage = nodes.usage.clone()
            usage[at, int(self.rng.integers(usage.shape[1]))] = float("nan")
            nodes = nodes.replace(usage=usage)
        elif kind == "negative_allocatable":
            alloc = nodes.allocatable.clone()
            alloc[at, int(self.rng.integers(alloc.shape[1]))] = -1.0
            nodes = nodes.replace(allocatable=alloc)
        elif kind == "overcommit_row":
            req = nodes.requested.clone()
            req[at] = nodes.allocatable[at] + guards.OVERCOMMIT_TOL + 50.0
            nodes = nodes.replace(requested=req)
        elif kind == "numa_free_above_cap":
            # only a valid zone counts as inconsistent: force one
            free = nodes.numa_free.clone()
            free[at, 0, 0] = (nodes.numa_cap[at, 0, 0]
                              + guards.OVERCOMMIT_TOL + 10.0)
            valid = nodes.numa_valid.clone()
            valid[at, 0] = True
            nodes = nodes.replace(numa_free=free, numa_valid=valid)
        else:
            raise ValueError(f"unknown snapshot fault {kind!r}")
        return snap.replace(nodes=nodes), rows

    def corrupt_batch(self, pods, kind: str,
                      n_rows: int = 1) -> Tuple[object, np.ndarray]:
        """-> (corrupted batch, the pod rows quarantine must catch)."""
        rows = self._rows(pods.valid.shape[0], n_rows)
        at = _index(rows, pods.valid)
        if kind in ("nan_pod_request", "negative_pod_request"):
            req = pods.requests.clone()
            req[at, int(self.rng.integers(req.shape[1]))] = (
                float("nan") if kind == "nan_pod_request" else -100.0)
            return pods.replace(requests=req), rows
        if kind == "bad_gang_id":
            gid = pods.gang_id.clone()
            gid[at] = 1_000_000
            return pods.replace(gang_id=gid), rows
        if kind == "bad_domain_index":
            if not pods.has_spread:
                raise ValueError("bad_domain_index needs a spread-modeling "
                                 "batch")
            dom = pods.spread_domain.clone()
            g = int(self.rng.integers(dom.shape[0]))
            dom[g, int(self.rng.integers(dom.shape[1]))] = (
                pods.spread_count0.shape[1] + 3)
            carriers = np.where(pods.spread_carrier[:, g].cpu().numpy())[0]
            return pods.replace(spread_domain=dom), carriers
        raise ValueError(f"unknown batch fault {kind!r}")

    def stale_delta(self, delta, applied_version: Optional[int] = None):
        """Re-stamp a delta at or below the applied version (the store
        must no-op it)."""
        cur = applied_version
        if cur is None:
            cur = int(np.asarray(delta.source_version))
        stale = int(self.rng.integers(0, max(cur, 1)))
        return delta.replace(source_version=torch.tensor(stale,
                                                         dtype=torch.int32))
