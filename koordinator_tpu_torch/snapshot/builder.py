"""Typed resource lists to columns: the port's copy of
`koordinator_tpu/snapshot/builder.py`'s `resource_vec`, which the
descheduler's columns are built with."""

from __future__ import annotations

import numpy as np

from koordinator_tpu_torch.api.extension import NUM_RESOURCES


def resource_vec(rl) -> np.ndarray:
    """f32[NUM_RESOURCES] of a ResourceList (absent kinds are 0)."""
    v = np.zeros((NUM_RESOURCES,), np.float32)
    for k, val in rl.items():
        v[int(k)] = val
    return v
