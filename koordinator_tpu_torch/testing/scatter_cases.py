"""K3's order-sensitive input: one hot target row that takes every
index, rows of mixed magnitude, so that any other order of the adds
changes the last bits of the sum. `tests/test_torch_scatter.py` shows
the order matters on it (a reversed order differs); `chip_smoke.py`
holds the kernel to the plain version on it."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def hot_row_case(p: int, c: int = 11, s: int = 64, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(target f32[S, C], idx i32[P], rows f32[P, C]): nine in ten
    indices on row 0, the rest spread over the other rows or dropped
    (S, -1 wraps to S - 1); rows uniform fractions times 10^u, u
    uniform in [-3, 4), so that the running sum of row 0 rounds at
    every add."""
    rng = np.random.default_rng(seed)
    target = (rng.uniform(0.0, 1.0e4, (s, c)) + 0.1).astype(np.float32)
    rows = (rng.uniform(0.0, 1.0, (p, c))
            * 10.0 ** rng.uniform(-3.0, 4.0, (p, c))).astype(np.float32)
    idx = rng.integers(-1, s + 1, p).astype(np.int32)
    idx = np.where(rng.uniform(size=p) < 0.9, 0, idx).astype(np.int32)
    return target, idx, rows
