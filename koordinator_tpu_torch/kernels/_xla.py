"""The reference's maximum, minimum and row scrub as XLA:CPU computes
them, NaN operands and signed zeros included (max(-0, +0) = +0,
min(+0, -0) = -0 in either order), which torch.maximum, torch.minimum
and clamp do not follow. The guard kernels' plain versions and
`snapshot.delta`'s clamps use them; `csrc/guard.cuh` states the same
rule for the kernels. `xla_mask_dot` is the reference's masked [P, P]
x [P, R] product of the segment prefix gate in XLA:CPU's order of
additions (`csrc/segment_prefix_ok.cu` forms it the same way).
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


def xla_mask_dot(mask: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """f32[P, R]: mask (bool[P, P]) @ req (f32[P, R]) as XLA:CPU adds
    the reference's gate sum (batching.py:63, `mask @ req` of a 0/1
    mask, jitted with the gate; an AVX2 host), element (i, c) from
    these f32 additions, each rounded (a masked-out term adds +0, which
    changes no sum):

    - R >= 2, P >= 8 (XLA's dot): four lane sums, lane l adding
      mask[i, j] * req[j, c] over j = l mod 4, j < 4 * (P // 4), in
      index order from 0, folded as (l0 + l1) + (l2 + l3); the tail
      j >= 4 * (P // 4) summed on its own from 0 in index order and
      added last.
    - R >= 2, P < 8: one sum from 0 in index order.
    - R = 1 (the dot fused into the gate's loop, LLVM's vector loop):
      32 lane sums over j < 32 * (P // 32), lane (u, l) adding the
      j with (j // 8) mod 4 = u and j mod 8 = l in index order; the
      four vectors combine as ((v1 + v0) + v2) + v3 and the eight lanes
      fold in halves, ((l0 + l4) + (l2 + l6)) + ((l1 + l5) + (l3 + l7));
      then the rest goes four at a time into four lanes that start
      from (that sum, 0, 0, 0), folded as (a0 + a2) + (a1 + a3); the
      last P mod 4 terms are added in index order. Below 32 pods, one
      sum from 0 in index order.

    The R >= 2 forms matched XLA:CPU (jax 0.9.0) on every row of random
    dense and segment masks at R = 2..4 for P in 1..5000, at R = 5 and
    8 for 8 <= P <= 4096 and at R = 11 for 16 <= P <= 2500. The R = 1
    form matched every row at P = 32..40, 400..1500, 2048, 2049, 2500,
    2503 and 3000, but not all rows at P = 63..301 (where LLVM unrolls
    the loop whole and the backend reassociates the chains), 2000 or
    4100: ROADMAP fault C7 stays open there."""
    p, r = req.shape
    m = mask.to(req.dtype)
    if r == 1:
        return _fused_matvec(m, req)
    q = p // 4 * 4 if p >= 8 else 0
    acc = req.new_zeros((p, 4, r))
    if q:
        mq = m[:, :q].reshape(p, q // 4, 4)
        rq = req[:q].reshape(q // 4, 4, r)
        for k in range(q // 4):
            acc = acc + mq[:, k, :, None] * rq[k][None]
    tail = req.new_zeros((p, r))
    for j in range(q, p):
        tail = tail + m[:, j, None] * req[j][None]
    a = acc.unbind(1)
    return ((a[0] + a[1]) + (a[2] + a[3])) + tail


def _fused_matvec(m: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """`xla_mask_dot`'s R = 1 form (m f32[P, P], req f32[P, 1])."""
    p = m.shape[0]
    x = req[:, 0]
    out = req.new_zeros((p,))
    q = p // 32 * 32 if p >= 32 else 0
    if q:
        v = req.new_zeros((p, 4, 8))
        for k in range(q // 32):
            j = 32 * k
            v = v + m[:, j:j + 32].reshape(p, 4, 8) * x[j:j + 32].reshape(4, 8)
        w = ((v[:, 1] + v[:, 0]) + v[:, 2]) + v[:, 3]
        h = w[:, :4] + w[:, 4:]
        out = (h[:, 0] + h[:, 2]) + (h[:, 1] + h[:, 3])
        e = q + (p - q) // 4 * 4
        if e > q:
            a = torch.stack([out] + [torch.zeros_like(out)] * 3, dim=1)
            for j in range(q, e, 4):
                a = a + m[:, j:j + 4] * x[j:j + 4]
            out = (a[:, 0] + a[:, 2]) + (a[:, 1] + a[:, 3])
        q = e
    for j in range(q, p):
        out = out + m[:, j] * x[j]
    return out[:, None]
