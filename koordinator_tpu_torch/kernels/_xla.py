"""The reference's maximum, minimum and row scrub as XLA:CPU computes
them, NaN operands and signed zeros included (max(-0, +0) = +0,
min(+0, -0) = -0 in either order), which torch.maximum, torch.minimum
and clamp do not follow. The guard kernels' plain versions and
`snapshot.delta`'s clamps use them; `csrc/guard.cuh` states the same
rule for the kernels.
"""

from __future__ import annotations

import torch


def _ordered(a: torch.Tensor, b, swap_if_negative: bool):
    a, b = torch.broadcast_tensors(a, torch.as_tensor(b, dtype=a.dtype,
                                                      device=a.device))
    swap = torch.signbit(a) if swap_if_negative else ~torch.signbit(a)
    return torch.where(swap, b, a), torch.where(swap, a, b)


def xla_max(a: torch.Tensor, b) -> torch.Tensor:
    """XLA:CPU's jnp.maximum (f32; b may be a Python float): the
    operands as (b, a) where a's sign bit is clear, then the larger, a
    NaN first operand winning (`csrc/guard.cuh`)."""
    x, y = _ordered(a, b, swap_if_negative=False)
    return torch.where(torch.isnan(x) | (x > y), x, y)


def xla_min(a: torch.Tensor, b) -> torch.Tensor:
    """XLA:CPU's jnp.minimum, the mirror of `xla_max`."""
    x, y = _ordered(a, b, swap_if_negative=True)
    return torch.where(torch.isnan(x) | (x < y), x, y)


def scrub(x: torch.Tensor) -> torch.Tensor:
    """guards._scrub_rows' clean value: max(nan_to_num(x), 0) with NaN
    and +-inf to 0 (every zero comes out +0)."""
    return xla_max(torch.where(torch.isfinite(x), x, 0.0), 0.0)
