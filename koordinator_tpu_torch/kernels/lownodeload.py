"""K10-K13: the descheduler's LowNodeLoad balance plan (BASELINE config 5).

Kernels: `csrc/lownodeload_fit.cu` (K10 `lnl_node_fit`),
`csrc/lownodeload_order.cu` (K11 `lnl_eviction_order`),
`csrc/lownodeload_prefix.cu` (K12 `lnl_plan_prefix`) and
`csrc/lownodeload_capped.cu` (K13 `lnl_plan_capped`), sharing
`csrc/lownodeload.cuh`. Together they replace the two jitted programs
of koordinator_tpu/descheduler/lownodeload_device.py: `_plan_prelude`
(:68-126) is K11 (classification, budget, order) and K10 (node_fit),
`plan_kernel` (:141-187) adds K12, `plan_kernel_capped` (:208-276) K13.

The plain versions beside the wrappers round as XLA:CPU compiles the
reference, so that the CPU tests hold them bit for bit:
- `jnp.cumsum` is XLA's blocked scan (`xla_cumsum`): a sequential
  prefix within blocks of 16, the blocks' totals scanned by the same
  rule, each block's exclusive carry added to its prefix;
- a column sum over the nodes is XLA's tree reduction
  (`xla_column_sum`): sequential windows of 32 rows, the padding split
  evenly before and after, until 32 partials or fewer remain, then
  summed in order;
- the weighted sums over the threshold dims are a chain of fused
  multiply-adds (`weighted_sum`), and each budget term is
  `fma(capacity * high, 0.01, -usage)`: XLA contracts both; `x / 100`
  is `x * f32(0.01)`, while `pct`'s divide stays a true divide;
- `sel(x) = x @ rdims_onehot.T` is a gather plus +0.0 (equal to the
  dot for finite inputs, a -0.0 turned +0.0);
- the sorts compare -0.0 equal to +0.0 (and every NaN equal and
  last), stably.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from koordinator_tpu_torch.api.extension import NUM_RESOURCES
from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check

# K12 scans the pods in one block's shared memory up to this many
# (csrc/lownodeload_prefix.cu); above it, in device memory
SHARED_KEYS = 16384
# K13 keeps the namespace counts in shared memory
MAX_NAMESPACES = 32768
MAX_RD = NUM_RESOURCES
EPS = 1e-9
SCAN_BASE = 16   # XLA:CPU's blocked scan
TREE_BASE = 32   # XLA:CPU's tree reduction


class EvictionOrder(NamedTuple):
    order: torch.Tensor       # i32[P] the global eviction order
    active: torch.Tensor      # bool[P] eligible, on a node, node a source
    budget0: torch.Tensor     # f32[Rd] the destinations' headroom
    high_abs: torch.Tensor    # f32[N, Rd] high threshold in usage units
    low_mask: torch.Tensor    # bool[N] underutilized (destinations)
    usage_sel: torch.Tensor   # f32[N, Rd] usage on the threshold dims


# --- XLA:CPU's orders of additions, in plain torch ------------------------

def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along dim 0 of f32[n] or f32[n, C], added in
    XLA:CPU's blocked order (its rewrite of `jnp.cumsum`)."""
    n = x.shape[0]
    pad = -n % SCAN_BASE
    if n <= SCAN_BASE:
        pad = SCAN_BASE - n
    xp = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    blocks = xp.reshape((-1, SCAN_BASE) + tuple(x.shape[1:]))
    inner = torch.empty_like(blocks)
    acc = torch.zeros_like(blocks[:, 0])
    for j in range(SCAN_BASE):
        acc = acc + blocks[:, j]
        inner[:, j] = acc
    if blocks.shape[0] == 1:
        return inner.reshape(xp.shape)[:n]
    incl = xla_cumsum(inner[:, -1])
    carry = torch.cat([torch.zeros_like(incl[:1]), incl[:-1]])
    return (carry[:, None] + inner).reshape(xp.shape)[:n]


def xla_column_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum along dim 0 of f32[n, C] in XLA:CPU's tree order: windows of
    32 rows summed in order (the padding split evenly before and
    after) while more than 32 rows remain, then the rest in order."""
    while x.shape[0] > TREE_BASE:
        n = x.shape[0]
        pad = -n % TREE_BASE
        lo = pad // 2
        xp = torch.cat([x.new_zeros((lo,) + tuple(x.shape[1:])), x,
                        x.new_zeros((pad - lo,) + tuple(x.shape[1:]))])
        blocks = xp.reshape((-1, TREE_BASE) + tuple(x.shape[1:]))
        acc = torch.zeros_like(blocks[:, 0])
        for j in range(TREE_BASE):
            acc = acc + blocks[:, j]
        x = acc
    acc = x.new_zeros(x.shape[1:])
    for i in range(x.shape[0]):
        acc = acc + x[i]
    return acc


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32 (a fused multiply-add), for f32
    operands: the product is exact in f64, the sum's f64 rounding is
    made odd from its exact error (TwoSum), and odd rounding to 53 bits
    then to 24 rounds as once."""
    a64 = a.double()
    b64 = torch.as_tensor(b, dtype=torch.float32).double().to(a64.device)
    c64 = c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def weighted_sum(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """f32[M]: sum over d of x[:, d] * weights[d], as XLA:CPU contracts
    it: acc = fma(x[:, d], weights[d], acc) from acc = 0, in d order."""
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for d in range(x.shape[1]):
        acc = fma_f32(x[:, d], weights[d], acc)
    return acc


# --- K10 lnl_node_fit ------------------------------------------------------

def _fit_dims(fit_dims: Optional[Sequence[int]]) -> list:
    dims = list(range(NUM_RESOURCES)) if fit_dims is None else [
        int(d) for d in fit_dims]
    if any(not 0 <= d < NUM_RESOURCES for d in dims):
        raise ValueError(f"fit_dims {dims} outside [0, {NUM_RESOURCES})")
    return dims


def lnl_node_fit_plain(pod_req: torch.Tensor, pod_node: torch.Tensor,
                       capacity: torch.Tensor, low_mask: torch.Tensor,
                       fit_dims: Optional[Sequence[int]]) -> torch.Tensor:
    """bool[P]: pod p fits some low node n on fit_dims, pod_req[p] <=
    capacity[n] - node_req[n] + 0.5, where node_req sums each node's
    pods' requests in pod order (the reference's scatter-add; a pod of
    node -1 adds nothing). On the host: torch's CPU index_add_ adds in
    index order."""
    fd = _fit_dims(fit_dims)
    on_node = pod_node >= 0
    pn = pod_node.clamp_min(0).long()
    node_req = torch.zeros_like(capacity).index_add_(
        0, pn, pod_req * on_node[:, None])
    dest_free = (capacity - node_req)[low_mask][:, fd]      # [L, F]
    fits = (pod_req[:, None, fd] <= dest_free[None] + 0.5).all(-1)
    return fits.any(-1)


def lnl_node_fit(pod_req: torch.Tensor, pod_node: torch.Tensor,
                 capacity: torch.Tensor, low_mask: torch.Tensor,
                 fit_dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The fits of `lnl_node_fit_plain`: the kernel for CUDA tensors, the
    plain version for CPU tensors. pod_req f32[P, R], pod_node i32[P]
    (-1 = no node), capacity f32[N, R], low_mask bool[N]; fit_dims the
    dims compared (None = all R)."""
    p, r = pod_req.shape
    n = capacity.shape[0]
    dev = pod_req.device
    for name, t, dt, shape in (
            ("pod_req", pod_req, torch.float32, (p, NUM_RESOURCES)),
            ("pod_node", pod_node, torch.int32, (p,)),
            ("capacity", capacity, torch.float32, (n, NUM_RESOURCES)),
            ("low_mask", low_mask, torch.bool, (n,))):
        _launch.check_tensor(name, t, dt, shape, dev)
    fd = _fit_dims(fit_dims)
    if dev.type == "cpu":
        return lnl_node_fit_plain(pod_req, pod_node, capacity, low_mask, fd)
    if dev.type != "cuda":
        raise ValueError(f"lnl_node_fit: unsupported device {dev}")
    fits = torch.empty((p,), dtype=torch.bool, device=dev)
    if p == 0:
        return fits
    dest = torch.empty((max(n, 1), max(len(fd), 1)), dtype=torch.float32,
                       device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    mask = sum(1 << d for d in set(fd))
    fn = TOOLCHAIN.function("lownodeload_fit", "koord_lnl_node_fit",
                            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                            + [ctypes.c_void_p])
    rc = fn(_launch.ptr(pod_req), _launch.ptr(pod_node),
            _launch.ptr(capacity), _launch.ptr(low_mask), _launch.ptr(dest),
            _launch.ptr(count), _launch.ptr(fits), p, n, mask,
            _launch.stream(dev))
    check(rc, "lnl_node_fit")
    lnl_node_fit.launches += 1
    return fits


lnl_node_fit.launches = 0


# --- K11 lnl_eviction_order ------------------------------------------------

def lnl_eviction_order_plain(usage, capacity, fresh, source_mask, pod_node,
                             pod_usage_r, pod_eligible, low, high, weights,
                             rdims, use_deviation: bool) -> EvictionOrder:
    """The reference's classification and eviction order
    (`_plan_prelude` less node_fit): usage%, the low and high masks
    (thresholds moved to the fresh nodes' average in deviation mode),
    high_abs, the budget, the pods that may go (eligible, on a node, the
    node a source), and the order: pods by (their node's rank among the
    sources by weighted usage% descending, non-sources after in index
    order, nodeless pods last; weighted usage descending; index)."""
    n = usage.shape[0]
    rd = rdims.long()
    usage_sel = usage[:, rd] + 0.0
    cap_sel = capacity[:, rd] + 0.0
    eps = torch.tensor(EPS, dtype=torch.float32, device=usage.device)
    pct = 100.0 * usage_sel / torch.maximum(cap_sel, eps)
    if use_deviation:
        nf = max(int(fresh.sum()), 1)
        avg = xla_column_sum(torch.where(fresh[:, None], pct, 0.0)) / \
            torch.tensor(float(nf), dtype=torch.float32)
        low = torch.clamp(avg - low, 0.0, 100.0)
        high = torch.clamp(avg + high, 0.0, 100.0)
    low_mask = fresh & (pct < low[None, :]).all(1)
    high_mask = fresh & (pct > high[None, :]).any(1)
    scaled = cap_sel * high[None, :]
    hundredth = torch.tensor(0.01, dtype=torch.float32)
    high_abs = scaled * hundredth
    source = source_mask & high_mask
    term = torch.where(low_mask[:, None],
                       fma_f32(scaled, hundredth, -usage_sel), 0.0)
    budget0 = xla_column_sum(term)
    on_node = pod_node >= 0
    pn = pod_node.clamp_min(0).long()
    active = pod_eligible & on_node & source[pn]
    node_w = weighted_sum(pct, weights)
    key = torch.where(source, -node_w, float("inf"))
    src_rank = torch.empty(n, dtype=torch.int64, device=usage.device)
    # torch's stable sort, like the reference's, compares -0.0 equal to
    # +0.0 and puts NaN last
    src_rank[torch.argsort(key, stable=True)] = torch.arange(
        n, device=usage.device)
    pod_w = weighted_sum(pod_usage_r, weights)
    ord1 = torch.argsort(-pod_w, stable=True)
    pod_rank = torch.where(on_node, src_rank[pn], n)
    order = ord1[torch.argsort(pod_rank[ord1], stable=True)]
    return EvictionOrder(order.to(torch.int32), active, budget0, high_abs,
                         low_mask, usage_sel)


# the kernel's ranks and indices are int32
MAX_INDEX = (1 << 31) - 2


def check_eviction_order_shape(n: int, p: int, rdn: int) -> None:
    """Raise ValueError unless K11 takes N nodes, P pods and Rd threshold
    dims: N >= 1, 1 <= Rd <= 11, N + 1 and P int32 indices (its keys
    keep the index in 32 bits of their own, beside the rank or the
    weight, so N and P no longer limit each other)."""
    if not 1 <= rdn <= MAX_RD or not 1 <= n <= MAX_INDEX - 1 or not (
            0 <= p <= MAX_INDEX):
        raise ValueError(f"lnl_eviction_order: N={n}, P={p}, Rd={rdn} "
                         f"outside 1 <= N < {MAX_INDEX}, 0 <= P <= "
                         f"{MAX_INDEX}, 1 <= Rd <= {MAX_RD}")


def lnl_eviction_order(usage, capacity, fresh, source_mask, pod_node,
                       pod_usage_r, pod_eligible, low, high, weights, rdims,
                       use_deviation: bool) -> EvictionOrder:
    """`lnl_eviction_order_plain`'s outputs: the kernel for CUDA
    tensors, the plain version for CPU tensors. usage, capacity
    f32[N, R]; fresh, source_mask bool[N]; pod_node i32[P]; pod_usage_r
    f32[P, Rd]; pod_eligible bool[P]; low, high, weights f32[Rd]; rdims
    i32[Rd] (the threshold dims' columns). Grid-wide, one cooperative
    launch with grid barriers between its steps
    (`csrc/lownodeload_order.cu`). Any N >= 1 and P whose indices fit
    int32 (`check_eviction_order_shape`), 1 <= Rd <= 11."""
    n = usage.shape[0]
    p, rdn = pod_usage_r.shape
    dev = usage.device
    for name, t, dt, shape in (
            ("usage", usage, torch.float32, (n, NUM_RESOURCES)),
            ("capacity", capacity, torch.float32, (n, NUM_RESOURCES)),
            ("fresh", fresh, torch.bool, (n,)),
            ("source_mask", source_mask, torch.bool, (n,)),
            ("pod_node", pod_node, torch.int32, (p,)),
            ("pod_usage_r", pod_usage_r, torch.float32, (p, rdn)),
            ("pod_eligible", pod_eligible, torch.bool, (p,)),
            ("low", low, torch.float32, (rdn,)),
            ("high", high, torch.float32, (rdn,)),
            ("weights", weights, torch.float32, (rdn,)),
            ("rdims", rdims, torch.int32, (rdn,))):
        _launch.check_tensor(name, t, dt, shape, dev)
    check_eviction_order_shape(n, p, rdn)
    if dev.type == "cpu":
        return lnl_eviction_order_plain(
            usage, capacity, fresh, source_mask, pod_node, pod_usage_r,
            pod_eligible, low, high, weights, rdims, use_deviation)
    if dev.type != "cuda":
        raise ValueError(f"lnl_eviction_order: unsupported device {dev}")
    out = EvictionOrder(
        order=torch.empty((p,), dtype=torch.int32, device=dev),
        active=torch.empty((p,), dtype=torch.bool, device=dev),
        budget0=torch.empty((rdn,), dtype=torch.float32, device=dev),
        high_abs=torch.empty((n, rdn), dtype=torch.float32, device=dev),
        low_mask=torch.empty((n,), dtype=torch.bool, device=dev),
        usage_sel=torch.empty((n, rdn), dtype=torch.float32, device=dev))
    # the kernel's scratch: budget terms and tree partials, node keys and
    # ranks, the pods' buckets, slots and keys (the C side's layout)
    size = TOOLCHAIN.function("lownodeload_order",
                              "koord_lnl_eviction_order_scratch",
                              [ctypes.c_int] * 3)
    size.restype = ctypes.c_longlong
    scratch = torch.empty((max(size(n, p, rdn), 1),), dtype=torch.uint8,
                          device=dev)
    tensors = (usage, capacity, fresh, source_mask, pod_node, pod_usage_r,
               pod_eligible, low, high, weights, rdims, out.order,
               out.active, out.budget0, out.high_abs, out.low_mask,
               out.usage_sel, scratch)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    dims = (ctypes.c_int * 4)(n, p, rdn, int(bool(use_deviation)))
    fn = TOOLCHAIN.function("lownodeload_order", "koord_lnl_eviction_order",
                            [ctypes.c_void_p] * 3)
    rc = fn(ptrs, dims, _launch.stream(dev))
    check(rc, "lnl_eviction_order")
    lnl_eviction_order.launches += 1
    return out


lnl_eviction_order.launches = 0


# --- K12 lnl_plan_prefix ---------------------------------------------------

def _sorted_columns(order, active, pod_node, pod_usage_r, usage_sel,
                    high_abs):
    """The plan's columns along the order; a pod of node -1 reads the
    last node's row, as the reference's negative gather does."""
    o = order.long()
    ns = pod_node[o].long()
    return (ns, active[o], pod_usage_r[o], usage_sel[ns], high_abs[ns])


def lnl_plan_prefix_plain(order, active, pod_node, pod_usage_r, usage_sel,
                          high_abs, budget0, max_evictions: int
                          ) -> torch.Tensor:
    """bool[P] take of the reference's uncapped plan (plan_kernel
    :162-187): along the order, a pod goes while its node is still over
    high_abs on some dim after the earlier takes of that node, while the
    budget is open on every dim after the earlier takes, and while fewer
    than max_evictions were taken; the prefix sums are XLA's."""
    p = order.shape[0]
    ns, act_s, u_s, un, ha = _sorted_columns(order, active, pod_node,
                                             pod_usage_r, usage_sel,
                                             high_abs)
    x = torch.where(act_s[:, None], u_s, 0.0)
    ex = xla_cumsum(x) - x
    is_start = torch.ones(p, dtype=torch.bool, device=order.device)
    is_start[1:] = ns[1:] != ns[:-1]
    idx = torch.arange(p, device=order.device)
    start_idx = torch.cummax(torch.where(is_start, idx, -1), 0).values
    seg_ex = ex - ex[start_idx.clamp_min(0)]
    still_over = ((un - seg_ex) > ha).any(1)
    take0 = act_s & still_over
    taken_x = torch.where(take0[:, None], u_s, 0.0)
    cum_before = xla_cumsum(taken_x) - taken_x
    budget_ok = ((budget0[None, :] - cum_before) > 0.0).all(1)
    t0 = take0.to(torch.int64)
    cnt_before = torch.cumsum(t0, 0) - t0
    take_sorted = take0 & budget_ok & (cnt_before < int(max_evictions))
    take = torch.zeros(p, dtype=torch.bool, device=order.device)
    take[order.long()] = take_sorted
    return take


def _check_plan(order, active, pod_node, pod_usage_r, usage_sel, high_abs,
                budget0):
    p, rdn = pod_usage_r.shape
    n = usage_sel.shape[0]
    dev = order.device
    for name, t, dt, shape in (
            ("order", order, torch.int32, (p,)),
            ("active", active, torch.bool, (p,)),
            ("pod_node", pod_node, torch.int32, (p,)),
            ("pod_usage_r", pod_usage_r, torch.float32, (p, rdn)),
            ("usage_sel", usage_sel, torch.float32, (n, rdn)),
            ("high_abs", high_abs, torch.float32, (n, rdn)),
            ("budget0", budget0, torch.float32, (rdn,))):
        _launch.check_tensor(name, t, dt, shape, dev)
    return p, n, rdn, dev


def lnl_plan_prefix(order, active, pod_node, pod_usage_r, usage_sel,
                    high_abs, budget0, max_evictions: int) -> torch.Tensor:
    """The take of `lnl_plan_prefix_plain`: the kernel for CUDA tensors,
    the plain version for CPU tensors. order i32[P] a permutation,
    active bool[P], pod_node i32[P], pod_usage_r f32[P, Rd], usage_sel
    and high_abs f32[N, Rd], budget0 f32[Rd]. One block, any P (above
    16384 its columns in device memory)."""
    p, n, rdn, dev = _check_plan(order, active, pod_node, pod_usage_r,
                                 usage_sel, high_abs, budget0)
    if dev.type == "cpu":
        return lnl_plan_prefix_plain(order, active, pod_node, pod_usage_r,
                                     usage_sel, high_abs, budget0,
                                     max_evictions)
    if dev.type != "cuda":
        raise ValueError(f"lnl_plan_prefix: unsupported device {dev}")
    if not 1 <= rdn <= MAX_RD or n < 1:
        raise ValueError(f"lnl_plan_prefix: N={n}, Rd={rdn} outside "
                         f"N >= 1, 1 <= Rd <= {MAX_RD}")
    take = torch.empty((p,), dtype=torch.bool, device=dev)
    if p == 0:
        return take
    # above SHARED_KEYS the kernel's arrays (csrc/lownodeload_prefix.cu
    # smem_bytes: col f32, start i32, over and ok u8, the scan's levels)
    work = (torch.empty((p * 10 + (p // 15 + 32) * 4 + 16,),
                        dtype=torch.uint8, device=dev)
            if p > SHARED_KEYS else None)
    tensors = (order, active, pod_node, pod_usage_r, usage_sel, high_abs,
               budget0, take, work)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    dims = (ctypes.c_int * 4)(p, n, rdn, int(max_evictions))
    fn = TOOLCHAIN.function("lownodeload_prefix", "koord_lnl_plan_prefix",
                            [ctypes.c_void_p] * 3)
    rc = fn(ptrs, dims, _launch.stream(dev))
    check(rc, "lnl_plan_prefix")
    lnl_plan_prefix.launches += 1
    return take


lnl_plan_prefix.launches = 0


# --- K13 lnl_plan_capped ---------------------------------------------------

def lnl_plan_capped_plain(order, active, pod_node, pod_usage_r, usage_sel,
                          high_abs, budget0, pod_ns, ns_counts0, per_node0,
                          max_evictions: int, max_per_node: int,
                          max_per_ns: int) -> torch.Tensor:
    """bool[P] take of the reference's capped plan (plan_kernel_capped
    :231-276): one step a pod along the order, in the reference's step
    order: on a node's first pod reset the removed usage and seed the
    node's count from per_node0; want = active, the node still over
    high_abs after its removed usage, the budget open; allow = under
    the cycle, node and namespace caps; a taken pod charges the
    removed usage, the budget and the three counts. f32 as the
    reference (a take adds u * 1, a skip u * 0)."""
    p = order.shape[0]
    ns, act_s, u_s, un, ha = (t.cpu().numpy() for t in _sorted_columns(
        order, active, pod_node, pod_usage_r, usage_sel, high_abs))
    o = order.cpu().numpy().astype(np.int64)
    nsid = pod_ns.cpu().numpy()[o]
    cnt0 = per_node0.cpu().numpy()[ns]
    counts = ns_counts0.cpu().numpy().astype(np.int32).copy()
    rdn = u_s.shape[1]
    removed = np.zeros((rdn,), np.float32)
    budget = budget0.cpu().numpy().astype(np.float32).copy()
    node_cnt, total = 0, 0
    take_s = np.zeros((p,), bool)
    one, zero = np.float32(1.0), np.float32(0.0)
    for i in range(p):
        if i == 0 or ns[i] != ns[i - 1]:
            removed = np.zeros((rdn,), np.float32)
            node_cnt = int(cnt0[i])
        still_over = bool(((un[i] - removed) > ha[i]).any())
        budget_open = bool((budget > 0.0).all())
        want = bool(act_s[i]) and still_over and budget_open
        allow = (total < max_evictions and node_cnt < max_per_node
                 and counts[nsid[i]] < max_per_ns)
        take = want and allow
        tf = one if take else zero
        removed = removed + u_s[i] * tf
        budget = budget - u_s[i] * tf
        total += int(take)
        node_cnt += int(take)
        counts[nsid[i]] += int(take)
        take_s[i] = take
    out = torch.zeros(p, dtype=torch.bool)
    out[torch.from_numpy(o)] = torch.from_numpy(take_s)
    return out.to(order.device)


def lnl_plan_capped(order, active, pod_node, pod_usage_r, usage_sel,
                    high_abs, budget0, pod_ns, ns_counts0, per_node0,
                    max_evictions: int, max_per_node: int,
                    max_per_ns: int) -> torch.Tensor:
    """The take of `lnl_plan_capped_plain`: the kernel for CUDA tensors,
    the plain version for CPU tensors. As `lnl_plan_prefix`, plus pod_ns
    i32[P] (namespace ids into ns_counts0), ns_counts0 i32[NS] and
    per_node0 i32[N] (the limiter's counts so far) and the three caps.
    One walker: P unlimited, NS at most 32768."""
    p, n, rdn, dev = _check_plan(order, active, pod_node, pod_usage_r,
                                 usage_sel, high_abs, budget0)
    ns_n = ns_counts0.shape[0]
    for name, t, shape in (("pod_ns", pod_ns, (p,)),
                           ("ns_counts0", ns_counts0, (ns_n,)),
                           ("per_node0", per_node0, (n,))):
        _launch.check_tensor(name, t, torch.int32, shape, dev)
    if dev.type == "cpu":
        return lnl_plan_capped_plain(
            order, active, pod_node, pod_usage_r, usage_sel, high_abs,
            budget0, pod_ns, ns_counts0, per_node0, max_evictions,
            max_per_node, max_per_ns)
    if dev.type != "cuda":
        raise ValueError(f"lnl_plan_capped: unsupported device {dev}")
    if not 1 <= ns_n <= MAX_NAMESPACES or not 1 <= rdn <= MAX_RD or n < 1:
        raise ValueError(f"lnl_plan_capped: NS={ns_n}, N={n}, Rd={rdn} "
                         f"outside 1 <= NS <= {MAX_NAMESPACES}, N >= 1, "
                         f"1 <= Rd <= {MAX_RD}")
    take = torch.empty((p,), dtype=torch.bool, device=dev)
    if p == 0:
        return take
    tensors = (order, active, pod_node, pod_usage_r, usage_sel, high_abs,
               budget0, pod_ns, ns_counts0, per_node0, take)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    dims = (ctypes.c_int * 7)(p, n, rdn, ns_n, int(max_evictions),
                              int(max_per_node), int(max_per_ns))
    fn = TOOLCHAIN.function("lownodeload_capped", "koord_lnl_plan_capped",
                            [ctypes.c_void_p] * 3)
    rc = fn(ptrs, dims, _launch.stream(dev))
    check(rc, "lnl_plan_capped")
    lnl_plan_capped.launches += 1
    return take


lnl_plan_capped.launches = 0
