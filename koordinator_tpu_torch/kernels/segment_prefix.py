"""K2 segment_prefix_ok: the priority-ordered same-segment prefix gate,
chained over the levels of one commit step.

Kernel: `csrc/segment_prefix_ok.cu`. Replaces
koordinator_tpu/scheduler/batching.py segment_prefix_ok (a masked
[P, P] x [P, R] matmul on the TPU), run for node capacity and then for
each quota level in every inner commit step: one launch takes the node
gate and every quota level, with the step's pod topology verdict (K8)
ANDed in between them, where the reference's topology gates sit
(core.py:776-884). Level 0 may read requests of its own (the node
level's amplified CPU, core.py:757-763, against the quota levels' raw
requests). Above 2048 pods the launch walks the rank order a tile of
2048 at a time, each level carrying its segments' sums from tile to
tile. A launch whose sums are not exact in any order (the order
switch, `exact_in_any_order`'s rule: a flag on the device that the
caller decided once a batch, or that the launch decides itself before
its first level; no host sync) adds them in the reference's XLA:CPU
order instead (`_xla.xla_mask_dot`, fault C7), as the plain version
does on the same flag.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from koordinator_tpu_torch.api.extension import NUM_RESOURCES
from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels._xla import xla_mask_dot
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check

TILE_PODS = 2048  # a tile: one block of 512 threads, four pods a thread
MAX_LEVELS = 8
MAX_SWITCH_ARRAYS = 4  # request arrays an order switch launch reads

# (base f32[S, R], limit f32[S, R], S) of one level
Table = Tuple[torch.Tensor, torch.Tensor, int]


def _check_table(name: str, t: torch.Tensor, rows: int, cols: int,
                 device) -> None:
    """A level's base or limit: f32[rows, cols] on `device`, unit column
    stride, any row stride of at least `cols`."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
    if tuple(t.shape) != (rows, cols):
        raise ValueError(f"{name}: expected shape {(rows, cols)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.stride(1) != 1 or (rows > 1 and t.stride(0) < cols):
        raise ValueError(f"{name}: needs unit column stride and rows "
                         f"apart by at least {cols}")


def _check_req(req: torch.Tensor, levels: int, p: int, r: int,
               device) -> None:
    """The requests: f32[P, R] shared by the levels or f32[L, P, R] one
    a level, on `device`, unit column stride, rows at least R apart
    (any level stride: a zone's columns of a [P, Z, R] take, seen as
    [Z, P, R], are read in place)."""
    if req.dtype != torch.float32:
        raise TypeError(f"req: expected torch.float32, got {req.dtype}")
    shapes = ((p, r), (levels, p, r))
    if tuple(req.shape) not in shapes:
        raise ValueError(f"req: expected shape {shapes[0]} or {shapes[1]}, "
                         f"got {tuple(req.shape)}")
    if req.device != device:
        raise ValueError(f"req: on {req.device}, expected {device}")
    if (r > 1 and req.stride(-1) != 1) or (p > 1 and req.stride(-2) < r) or (
            req.dim() == 3 and req.stride(0) < 0):
        raise ValueError(f"req: needs unit column stride and rows apart by "
                         f"at least {r}")


def low_bit_exponent(x: torch.Tensor) -> torch.Tensor:
    """i32[...]: for finite nonzero f32 x the e with x an odd multiple of
    2^e (the exponent of its lowest set mantissa bit); x = 0 gives a
    value above any other's (it constrains nothing), non-finite x -1000
    (it fails every bound below)."""
    bits = x.contiguous().view(torch.int32)
    exp = (bits >> 23) & 0xFF
    mant = torch.where(exp == 0, bits & 0x7FFFFF, (bits & 0x7FFFFF) | 0x800000)
    low = torch.log2((mant & -mant).to(torch.float32)).to(torch.int32)
    e = torch.where(exp == 0, -149, exp - 150) + low
    e = torch.where(mant == 0, 1000, e)
    return torch.where(torch.isfinite(x), e, -1000).to(torch.int32)


def exact_in_any_order_plain(*reqs: torch.Tensor) -> torch.Tensor:
    """K2's order switch: bool[1] on the arrays' device, True where every
    sum of requests a K2 launch on these request arrays ([..., R], every
    row) can form is exact in any order. The rule, for each array and
    column: the requests are multiples of one power of two 2^e (the
    smallest of the column's `low_bit_exponent`s) and the sum of their
    magnitudes stays below 2^(24 + e). Then every partial sum of
    requests is a multiple of 2^e below 2^(24 + e), which an f32 holds
    exactly, so any order of the additions gives the same bits (a pod's
    base is added once, after its sum): so for requests in whole
    millicores and MiB (multiples of 500 and 512 in every workload),
    whole GPU and aux percents. Where it fails, K2 and its plain version
    add in the reference's order (`_xla.xla_mask_dot`); a launch may
    pass a flag decided on a superset of its rows."""
    ok = None
    for req in reqs:
        x = req.reshape(-1, req.shape[-1])
        if not x.shape[0]:
            continue
        e = low_bit_exponent(x).amin(dim=0).double()
        total = x.abs().sum(dim=0, dtype=torch.float64)
        col = (e == 1000) | ((e >= -149) & (total < torch.exp2(24.0 + e)))
        ok = col.all() if ok is None else ok & col.all()
    if ok is None:
        return torch.ones((1,), dtype=torch.bool, device=reqs[0].device)
    return ok.reshape(1)


def exact_in_any_order(*reqs: torch.Tensor) -> torch.Tensor:
    """`exact_in_any_order_plain`, the order switch, as K2's launches
    read it: a kernel of `csrc/segment_prefix_ok.cu` for CUDA tensors
    (one launch, one block; no host sync), the plain version for CPU
    tensors. reqs: up to 4 f32 arrays [P, R] or [L, P, R] (any level
    and row strides, unit column stride) of one R <= 11. The scheduler
    decides it here once a batch for the requests fixed for the batch;
    a K2 launch given no flag (the step's own arrays: GPU, zone,
    amplified levels) decides it in its own launch by the same block
    function."""
    if not reqs or len(reqs) > MAX_SWITCH_ARRAYS:
        raise ValueError(f"exact_in_any_order: 1 to {MAX_SWITCH_ARRAYS} "
                         f"arrays, got {len(reqs)}")
    dev, r = reqs[0].device, reqs[0].shape[-1]
    for k, req in enumerate(reqs):
        if req.dtype != torch.float32:
            raise TypeError(f"reqs[{k}]: expected torch.float32, got "
                            f"{req.dtype}")
        if req.dim() not in (2, 3) or req.shape[-1] != r or not 0 < r <= (
                NUM_RESOURCES):
            raise ValueError(f"reqs[{k}]: expected [P, R] or [L, P, R] "
                             f"with one R in [1, {NUM_RESOURCES}], got "
                             f"{tuple(req.shape)}")
        if req.device != dev:
            raise ValueError(f"reqs[{k}]: on {req.device}, expected {dev}")
    if dev.type == "cpu":
        return exact_in_any_order_plain(*reqs)
    if dev.type != "cuda":
        raise ValueError(f"exact_in_any_order: unsupported device {dev}")
    arrays = [q if q.stride(-1) == 1 and (q.shape[-2] <= 1
                                          or q.stride(-2) >= r)
              else q.contiguous() for q in reqs]
    a3 = [q if q.dim() == 3 else q[None] for q in arrays]
    n = len(a3)
    ptrs = (ctypes.c_void_p * n)(*(q.data_ptr() for q in a3))
    lstr = (ctypes.c_longlong * n)(*(q.stride(0) for q in a3))
    levels = (ctypes.c_int * n)(*(q.shape[0] for q in a3))
    rows = (ctypes.c_int * n)(*(q.shape[1] for q in a3))
    rstr = (ctypes.c_int * n)(*(q.stride(1) if q.shape[1] > 1 else r
                                for q in a3))
    out = torch.empty((1,), dtype=torch.bool, device=dev)
    fn = TOOLCHAIN.function("segment_prefix_ok", "koord_order_switch",
                            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                            + [ctypes.c_void_p] * 2)
    rc = fn(ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(lstr, ctypes.c_void_p),
            ctypes.cast(levels, ctypes.c_void_p),
            ctypes.cast(rows, ctypes.c_void_p),
            ctypes.cast(rstr, ctypes.c_void_p), n, r, _launch.ptr(out),
            _launch.stream(dev))
    check(rc, "exact_in_any_order")
    exact_in_any_order.launches += 1
    return out


exact_in_any_order.launches = 0


def segment_prefix_ok_plain(seg: torch.Tensor, rank: torch.Tensor,
                            req: torch.Tensor, base_used: torch.Tensor,
                            limit: torch.Tensor, num_segments: int,
                            eps: float,
                            exact: Optional[bool] = None) -> torch.Tensor:
    """bool[P]: base_used[seg] + Σ req of the same-segment pods ranked
    earlier + own req <= limit[seg] + eps on every column; segments
    >= num_segments ("no candidate") pass. The reference's masked
    matmul, its sums added in XLA:CPU's order (`_xla.xla_mask_dot`), so
    that fractional requests gate as the reference gates them; where
    the sums are exact in any order (`exact`, else
    `exact_in_any_order_plain(req)`) the matmul gives the same bits and
    runs instead."""
    same = seg[:, None] == seg[None, :]
    earlier = rank[None, :] < rank[:, None]
    if exact is None:
        exact = bool(exact_in_any_order_plain(req))
    if exact:
        cum = (same & earlier).to(req.dtype) @ req
    else:
        cum = xla_mask_dot(same & earlier, req)
    seg_c = seg.clamp(0, num_segments - 1).long()
    ok = torch.all(base_used[seg_c] + cum + req <= limit[seg_c] + eps, dim=-1)
    return ok | (seg >= num_segments)


def _launch_exact(req: torch.Tensor, req0: Optional[torch.Tensor],
                  exact: Optional[torch.Tensor], rule) -> torch.Tensor:
    """A launch's order switch: the caller's flag, else `rule` (the
    switch or its plain version) on the launch's request arrays."""
    if exact is not None:
        return exact
    return rule(req, *(() if req0 is None else (req0,)))


def segment_prefix_chain_plain(seg: torch.Tensor, rank: torch.Tensor,
                               req: torch.Tensor, active: torch.Tensor,
                               tables: Sequence[Table], eps: float,
                               mask: Optional[torch.Tensor] = None,
                               req0: Optional[torch.Tensor] = None,
                               exact: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """bool[P]: `active`, narrowed level by level: at level l the pods
    still alive are gated by `segment_prefix_ok_plain` on seg[l],
    tables[l] and the level's requests (req0 at level 0 where given,
    else req[l] of a per-level req [L, P, R], else the shared req
    [P, R]); the others sit out (segment out of range, no request).
    `mask` (bool[P]), where given, is ANDed into the alive pods after
    level 0: level 0 charges every active pod, the later levels only
    those that pass both. `exact` (bool[1]) is the launch's order
    switch, as the kernel reads it (None: decided here on req and
    req0)."""
    alive = active
    scan = bool(_launch_exact(req, req0, exact, exact_in_any_order_plain))
    for l, (level, (base_used, limit, num_segments)) in enumerate(
            zip(seg, tables)):
        seg_l = torch.where(alive, level, num_segments).to(torch.int32)
        req_l = req0 if l == 0 and req0 is not None else (
            req[l] if req.dim() == 3 else req)
        req_l = torch.where(alive[:, None], req_l, 0.0)
        alive = alive & segment_prefix_ok_plain(
            seg_l, rank, req_l, base_used, limit, num_segments, eps, scan)
        if l == 0 and mask is not None:
            alive = alive & mask
    return alive


def segment_prefix_chain(seg: torch.Tensor, rank: torch.Tensor,
                         req: torch.Tensor, active: torch.Tensor,
                         tables: Sequence[Table], eps: float,
                         mask: Optional[torch.Tensor] = None,
                         req0: Optional[torch.Tensor] = None,
                         exact: Optional[torch.Tensor] = None,
                         switch_out: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The chained gate of `segment_prefix_chain_plain`: the kernel for
    CUDA tensors (one launch for all levels; L = 1 is the reference's
    single-level gate), the plain version for CPU tensors. seg:
    i32[L, P]; rank: i32[P]; req: f32[P, R] shared by the levels, or
    f32[L, P, R] one a level; active: bool[P]; tables: L levels of
    (base, limit, S), base and limit f32[S, R] with unit column stride
    and one row stride (a column slice of a wider table is taken as it
    is); req likewise needs only unit column stride; mask: bool[P] or
    None, ANDed in after level 0 (L >= 1); req0: f32[P, R] level 0's
    own requests with req's row stride, or None; exact: bool[1], the
    order switch (`exact_in_any_order` of req and req0, or of a
    superset of their rows: a caller that decides it once a batch
    passes it), or None: the launch decides it itself, by the same rule
    on req (every level) and req0, before its first level (no launch of
    its own); switch_out: bool[1] or None, where `exact` is None, gets
    the verdict the launch decided. Takes any P (above 2048 the tiled
    walk), R <= 11, L <= 8.

    rank must be a permutation of [0, P) and every active pod's
    segments >= -1. On the host a call that breaks this raises
    ValueError; on the card the kernel checks it and stops with a
    launch failure, which the next synchronisation raises."""
    p, r = req.shape[-2:]
    levels = len(tables)
    dev = req.device
    _launch.check_tensor("seg", seg, torch.int32, (levels, p), dev)
    _launch.check_tensor("rank", rank, torch.int32, (p,), dev)
    _check_req(req, levels, p, r, dev)
    _launch.check_tensor("active", active, torch.bool, (p,), dev)
    if mask is not None:
        _launch.check_tensor("mask", mask, torch.bool, (p,), dev)
        if not levels:
            raise ValueError("segment_prefix_chain: a mask needs a level")
    if req0 is not None:
        _check_req(req0, 1, p, r, dev)
        if req0.dim() != 2 or (p > 1 and req0.stride(0) != req.stride(-2)):
            raise ValueError("segment_prefix_chain: req0 needs shape "
                             "[P, R] and req's row stride")
        if not levels:
            raise ValueError("segment_prefix_chain: req0 needs a level")
    if exact is not None:
        _launch.check_tensor("exact", exact, torch.bool, (1,), dev)
        if switch_out is not None:
            raise ValueError("segment_prefix_chain: switch_out needs "
                             "exact None")
    if switch_out is not None:
        _launch.check_tensor("switch_out", switch_out, torch.bool, (1,), dev)
    for l, (base_used, limit, num_segments) in enumerate(tables):
        for name, t in (("base", base_used), ("limit", limit)):
            _check_table(f"{name}[{l}]", t, num_segments, r, dev)
        if base_used.stride(0) != limit.stride(0):
            raise ValueError(f"tables[{l}]: base and limit row strides "
                             f"differ")
    if dev.type == "cpu":
        if p and (rank.min() < 0 or rank.max() >= p or not bool(
                torch.all(torch.bincount(rank, minlength=p) == 1))):
            raise ValueError("segment_prefix_chain: rank is not a "
                             "permutation of [0, P)")
        if bool(torch.any((seg < -1) & active)):
            raise ValueError("segment_prefix_chain: an active pod has a "
                             "segment below -1")
        flag = _launch_exact(req, req0, exact, exact_in_any_order_plain)
        if switch_out is not None:
            switch_out.copy_(flag)
        return segment_prefix_chain_plain(seg, rank, req, active, tables, eps,
                                          mask, req0, flag)
    if dev.type != "cuda":
        raise ValueError(f"segment_prefix_chain: unsupported device {dev}")
    if r > NUM_RESOURCES or levels > MAX_LEVELS:
        raise ValueError(f"segment_prefix_chain: R={r}, L={levels} above "
                         f"its capacity ({NUM_RESOURCES}, {MAX_LEVELS})")
    if any(t[2] <= 0 for t in tables) or r == 0:
        raise ValueError("segment_prefix_chain: empty table")
    out = torch.empty((p,), dtype=torch.bool, device=dev)
    # the flag the launch reads, or the byte it writes its own verdict to
    decide = exact is None
    flag = exact if not decide else (
        switch_out if switch_out is not None
        else torch.empty((1,), dtype=torch.bool, device=dev))
    if decide and not p:
        flag.fill_(True)
    fn = TOOLCHAIN.function("segment_prefix_ok", "koord_segment_prefix_chain",
                            [ctypes.c_void_p] * 7 + [ctypes.c_int]
                            + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                            + [ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_float, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p])
    bases = (ctypes.c_void_p * max(levels, 1))(
        *(t[0].data_ptr() for t in tables))
    limits = (ctypes.c_void_p * max(levels, 1))(
        *(t[1].data_ptr() for t in tables))
    nseg = (ctypes.c_int * max(levels, 1))(*(t[2] for t in tables))
    strides = (ctypes.c_int * max(levels, 1))(
        *(t[0].stride(0) for t in tables))
    work = None
    if p > TILE_PODS:
        # the rank order, then a carry a level and segment (and one for
        # the pods of no segment)
        work = torch.empty((p + sum((t[2] + 1) * r for t in tables),),
                           dtype=torch.int32, device=dev)
    rc = fn(_launch.ptr(seg), _launch.ptr(rank), _launch.ptr(req),
            None if req0 is None else _launch.ptr(req0),
            _launch.ptr(active),
            None if mask is None else _launch.ptr(mask), _launch.ptr(flag),
            int(decide), ctypes.cast(bases, ctypes.c_void_p),
            ctypes.cast(limits, ctypes.c_void_p),
            ctypes.cast(nseg, ctypes.c_void_p),
            ctypes.cast(strides, ctypes.c_void_p), levels, p, r,
            req.stride(0) if req.dim() == 3 else 0,
            req.stride(-2) if p > 1 else r, eps,
            None if work is None else _launch.ptr(work), _launch.ptr(out),
            _launch.stream(dev))
    check(rc, "segment_prefix_chain")
    segment_prefix_chain.launches += 1
    return out


segment_prefix_chain.launches = 0

