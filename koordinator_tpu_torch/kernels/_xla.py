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
    - R = 1: see `_fused_matvec`, whose rule is a function of P alone.

    The R >= 2 forms matched XLA:CPU (jax 0.9.0) on every row of random
    dense and segment masks at R = 2..4 for P in 1..5000, at R = 5 and
    8 for 8 <= P <= 4096 and at R = 11 for 16 <= P <= 2500."""
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


def _halves(v: torch.Tensor) -> torch.Tensor:
    """The lanes of v (f32[P, 2^k]) folded in halves: lane l + lane
    l + w/2 until one is left (LLVM's reassociated vector reduction)."""
    while v.shape[1] > 1:
        h = v.shape[1] // 2
        v = v[:, :h] + v[:, h:]
    return v[:, 0]


def fused_matvec_form(p: int):
    """(vf, ic, chain) of `_fused_matvec` at P pods: the vector width
    and the accumulators of XLA:CPU's R = 1 loop, and whether the loop
    is unrolled whole (the backend then folds the accumulators into
    one chain); None for index order, "gemv" above the fusion."""
    if p >= 4096:
        return "gemv"
    if p < 28:
        return None
    if p < 32:
        return 4, 2, True
    if p < 48:
        return 8, 4, True
    if p < 64:
        return 8, 2, True
    return 8, 4, p < 320


def _fused_matvec(m: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """`xla_mask_dot`'s R = 1 form (m f32[P, P], req f32[P, 1]): row i's
    terms t[j] = m[i, j] * req[j], added as XLA:CPU (jax 0.9.0, an
    AVX-512 host with FMA) runs the gate's fused loop, read from its
    optimised IR and its machine code. With (vf, ic, chain) =
    `fused_matvec_form(P)` and chunk (k, u) the vf terms from
    vf * (ic * k + u), n = P // (vf * ic) whole steps:

    - P < 28: one sum from +0 in index order.
    - loop (320 <= P < 4096): accumulator u (lanes from -0, lane 0 of
      the first from +0) adds chunks (0, u), (1, u), ... in order; they
      combine as ((a1 + a0) + a2) + a3.
    - chain (28 <= P < 320; the loop unrolled whole, the fused
      multiply-adds reassociated by the backend into one chain): one
      vector from chunk (0, 0), then chunks (1, 0) .. (n - 1, 0), then
      for each u >= 1 chunks (1, u), (0, u), (2, u) .. (n - 1, u).
    - then the vector's lanes fold in halves (lane l + lane l + w/2);
    - the rest r = P - n * vf * ic (vf 8 only): where r // w > 0 for the
      epilogue's width w (8 where r mod 8 < 4, else 4), a vector from
      (that sum, -0, ...) adds the next w terms r // w times and folds
      in halves; the last terms are added one at a time in index order.
    - gemv (P >= 4096: the product leaves the fusion and runs XLA's
      tiled dot): eight lanes by j mod 8 over j < 8 * (P // 8), summed
      from +0, folded ((l0 + l1) + (l2 + l3)) + ((l4 + l5) + (l6 + l7))
      on rows below 8 * (P // 8) and in halves on the last P mod 8 rows;
      plus the terms j >= 8 * (P // 8) summed from +0 in index order.

    Every P from 1 to 700 and samples to 5000 matched every row of
    dense and two-segment masks (ROADMAP fault C7)."""
    p = m.shape[0]
    t = m * req[:, 0][None, :]
    form = fused_matvec_form(p)
    if form is None:
        out = t.new_zeros((p,))
        for j in range(p):
            out = out + t[:, j]
        return out[:, None]
    if form == "gemv":
        q = p // 8 * 8
        lanes = t.new_zeros((p, 8))
        for j in range(0, q, 8):
            lanes = lanes + t[:, j:j + 8]
        pair = lanes[:, 0::2] + lanes[:, 1::2]
        out = (pair[:, 0] + pair[:, 1]) + (pair[:, 2] + pair[:, 3])
        rows = p // 8 * 8
        out[rows:] = _halves(lanes[rows:])
        tail = t.new_zeros((p,))
        for j in range(q, p):
            tail = tail + t[:, j]
        return (out + tail)[:, None]
    vf, ic, chain = form
    step = vf * ic
    n = p // step

    def chunk(k, u):
        return t[:, step * k + vf * u:step * k + vf * (u + 1)]

    first = torch.full((p, vf), -0.0, dtype=t.dtype, device=t.device)
    first[:, 0] = 0.0
    if chain:
        acc = first + chunk(0, 0)
        for k in range(1, n):
            acc = acc + chunk(k, 0)
        for u in range(1, ic):
            for k in ([1, 0] + list(range(2, n))) if n > 1 else [0]:
                acc = acc + chunk(k, u)
    else:
        a = [first] + [torch.full_like(first, -0.0) for _ in range(ic - 1)]
        for k in range(n):
            for u in range(ic):
                a[u] = a[u] + chunk(k, u)
        acc = a[1] + a[0]
        for u in range(2, ic):
            acc = acc + a[u]
    out = _halves(acc)
    j = n * step
    if vf == 8:
        rest = p - j
        w = 8 if rest % 8 < 4 else 4
        if rest >= w:
            v = torch.full((p, w), -0.0, dtype=t.dtype, device=t.device)
            v[:, 0] = out
            for _ in range(rest // w):
                v = v + t[:, j:j + w]
                j += w
            out = _halves(v)
    for k in range(j, p):
        out = out + t[:, k]
    return out[:, None]
