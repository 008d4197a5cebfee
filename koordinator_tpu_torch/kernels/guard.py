"""K14 guard_nodes and K15 guard_pods: the device health guard's scan
and row scrub of the node columns and of a pod batch.

Kernels: `csrc/guard_nodes.cu`, `csrc/guard_pods.cu` (shared rules in
`csrc/guard.cuh`). They replace koordinator_tpu/scheduler/guards.py
_node_defects, _batch_defects (with _bad_domain_groups) and
_quarantine: each finds its rows' defect classes, ORs their bits into a
health vector and adds its bad rows to it, and writes the scrubbed
columns anew (a healthy row bit for bit). `health` is i32[3] =
[word, bad nodes, bad pods], the reference's u32[3] held as int32 (the
word uses bits 0-11); both kernels accumulate into the same vector.

The plain versions take the reference's maximum, minimum and scrub from
`kernels/_xla.py`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels._xla import scrub, xla_min
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check
from koordinator_tpu_torch.snapshot.schema import NodeState, PodBatch

OVERCOMMIT_TOL = 1.0
NODE_METRIC_NONFINITE = 1 << 0
NODE_BAD_ALLOCATABLE = 1 << 1
NODE_BAD_REQUESTED = 1 << 2
NODE_OVERCOMMIT = 1 << 3
NODE_NUMA_INVALID = 1 << 4
POD_NONFINITE = 1 << 8
POD_NEGATIVE = 1 << 9
POD_ID_RANGE = 1 << 10
POD_DOMAIN_RANGE = 1 << 11

# the scrubbed node columns, in the kernel's order; the metric columns
# are the third to the ninth
NODE_COLUMNS = ("allocatable", "requested", "usage", "prod_usage",
                "agg_usage", "assigned_estimated", "assigned_correction",
                "prod_assigned_estimated", "prod_assigned_correction",
                "numa_free")
METRIC_COLUMNS = NODE_COLUMNS[2:9]
# (switch, domain map, count table, carrier matrix) of each family
DOMAIN_FAMILIES = (
    ("has_spread", "spread_domain", "spread_count0", "spread_carrier"),
    ("has_anti", "anti_domain", "anti_count0", "anti_carrier"),
    ("has_aff", "aff_domain", "aff_count0", "aff_carrier"),
)
MAX_R = 16      # csrc/guard_nodes.cu, csrc/guard_pods.cu
MAX_Z = 8
MAX_GROUPS = 64  # a family, csrc/guard_pods.cu


def _rows_any(bad: torch.Tensor) -> torch.Tensor:
    return bad.reshape(bad.shape[0], -1).any(dim=1)


def _row_where(bad: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(bad.reshape(bad.shape + (1,) * (a.dim() - 1)), a, b)


def _flag(any_bad: torch.Tensor, bit: int) -> torch.Tensor:
    return any_bad.to(torch.int32) * bit


def _health(health: Optional[torch.Tensor], device) -> torch.Tensor:
    if health is None:
        return torch.zeros(3, dtype=torch.int32, device=device)
    _launch.check_tensor("health", health, torch.int32, (3,), device)
    return health


def guard_nodes_plain(nodes: NodeState, force: Optional[torch.Tensor],
                      health: torch.Tensor
                      ) -> Tuple[NodeState, torch.Tensor]:
    """(scrubbed nodes, node_bad bool[N]): the scan of _node_defects,
    its bits ORed into health[0] and its bad rows added to health[1]
    (in place), and the rows of `force` (or of the scan where force is
    None) scrubbed as _quarantine scrubs them."""
    bad_metric = torch.zeros_like(nodes.schedulable)
    for f in METRIC_COLUMNS:
        bad_metric = bad_metric | _rows_any(~torch.isfinite(getattr(nodes,
                                                                    f)))
    alloc, req = nodes.allocatable, nodes.requested
    bad_alloc = _rows_any(~torch.isfinite(alloc) | (alloc < 0.0))
    bad_req = _rows_any(~torch.isfinite(req) | (req < 0.0))
    over = (req > alloc + OVERCOMMIT_TOL).any(dim=1)
    free, cap = nodes.numa_free, nodes.numa_cap
    numa = ((~torch.isfinite(free) | (free < 0.0)
             | (free > cap + OVERCOMMIT_TOL)) & nodes.numa_valid[:, :, None])
    bad_numa = _rows_any(numa)
    node_bad = bad_metric | bad_alloc | bad_req | over | bad_numa
    health[0] |= (_flag(bad_metric.any(), NODE_METRIC_NONFINITE)
                  | _flag(bad_alloc.any(), NODE_BAD_ALLOCATABLE)
                  | _flag(bad_req.any(), NODE_BAD_REQUESTED)
                  | _flag(over.any(), NODE_OVERCOMMIT)
                  | _flag(bad_numa.any(), NODE_NUMA_INVALID))
    health[1] += node_bad.sum().to(torch.int32)
    rows = node_bad if force is None else force
    out = {f: _row_where(rows, scrub(getattr(nodes, f)), getattr(nodes, f))
           for f in NODE_COLUMNS}
    out["requested"] = _row_where(
        rows, xla_min(scrub(req), scrub(alloc)), req)
    out["numa_free"] = _row_where(rows, xla_min(scrub(free), cap), free)
    out["schedulable"] = nodes.schedulable & ~rows
    return nodes.replace(**out), node_bad


def guard_nodes(nodes: NodeState, force: Optional[torch.Tensor] = None,
                health: Optional[torch.Tensor] = None
                ) -> Tuple[NodeState, torch.Tensor, torch.Tensor]:
    """(scrubbed nodes, node_bad bool[N], health i32[3]) of
    `guard_nodes_plain`: the kernel for CUDA tensors, the plain version
    for CPU tensors. `force` (bool[N]) names the rows to scrub instead
    of the scan's (apply_quarantine's masks); `health` is accumulated
    into (zeros where None). The node columns of `NODE_COLUMNS` are
    written anew, the rest of `nodes` is shared. N, R <= 16, Z <= 8."""
    n, r = nodes.allocatable.shape
    z = nodes.numa_cap.shape[1]
    agg = nodes.agg_usage.shape[1]
    dev = nodes.allocatable.device
    widths = {f: (r,) for f in NODE_COLUMNS}
    widths["agg_usage"] = (agg, r)
    widths["numa_free"] = (z, 2)
    for f in NODE_COLUMNS:
        _launch.check_tensor(f, getattr(nodes, f), torch.float32,
                             (n,) + widths[f], dev)
    _launch.check_tensor("numa_cap", nodes.numa_cap, torch.float32,
                         (n, z, 2), dev)
    _launch.check_tensor("numa_valid", nodes.numa_valid, torch.bool, (n, z),
                         dev)
    _launch.check_tensor("schedulable", nodes.schedulable, torch.bool, (n,),
                         dev)
    if force is not None:
        _launch.check_tensor("force", force, torch.bool, (n,), dev)
    health = _health(health, dev)
    if dev.type == "cpu":
        out, node_bad = guard_nodes_plain(nodes, force, health)
        return out, node_bad, health
    if dev.type != "cuda":
        raise ValueError(f"guard_nodes: unsupported device {dev}")
    if not (1 <= r <= MAX_R and z <= MAX_Z and 1 <= agg <= 8):
        raise ValueError(f"guard_nodes: R={r}, Z={z}, NUM_AGG={agg} above "
                         f"the kernel's {MAX_R}, {MAX_Z}, 8")
    out = {f: torch.empty_like(getattr(nodes, f)) for f in NODE_COLUMNS}
    out["schedulable"] = torch.empty_like(nodes.schedulable)
    node_bad = torch.empty_like(nodes.schedulable)
    if n:
        tensors = ([getattr(nodes, f) for f in NODE_COLUMNS]
                   + [nodes.numa_cap, nodes.numa_valid, nodes.schedulable,
                      force] + [out[f] for f in NODE_COLUMNS]
                   + [out["schedulable"], node_bad, health])
        ptrs = (ctypes.c_void_p * len(tensors))(
            *(None if x is None else x.data_ptr() for x in tensors))
        dims = (ctypes.c_int * 4)(n, r, z, agg)
        fn = TOOLCHAIN.function("guard_nodes", "koord_guard_nodes",
                                [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p])
        check(fn(ptrs, dims, _launch.stream(dev)), "guard_nodes")
        guard_nodes.launches += 1
    return nodes.replace(**out), node_bad, health


guard_nodes.launches = 0


def _id_oob(ids: torch.Tensor, cap: int) -> torch.Tensor:
    """-1 is the 'none' sentinel; below it or at the capacity is out."""
    return (ids < -1) | (ids >= cap)


def _families(pods: PodBatch):
    """(domain field, count width, carrier field) of each family whose
    switch is on."""
    return [(dom, getattr(pods, cnt).shape[1], car)
            for switch, dom, cnt, car in DOMAIN_FAMILIES
            if getattr(pods, switch)]


def guard_pods_plain(pods: PodBatch, n_gangs: int, n_quotas: int,
                     force: Optional[torch.Tensor], health: torch.Tensor
                     ) -> Tuple[PodBatch, torch.Tensor]:
    """(scrubbed batch, pod_bad bool[P]): the scan of _batch_defects,
    its bits ORed into health[0] and its bad rows added to health[2]
    (in place), the rows of `force` (or of the scan) scrubbed and made
    invalid, and each bad domain group's row set to -1."""
    req, est, ratio = pods.requests, pods.estimated, pods.gpu_ratio
    bad_nonfinite = (_rows_any(~torch.isfinite(req))
                     | _rows_any(~torch.isfinite(est))
                     | ~torch.isfinite(ratio))
    bad_neg = (req < 0.0).any(dim=1) | (est < 0.0).any(dim=1) | (ratio < 0.0)
    bad_id = (_id_oob(pods.gang_id, n_gangs) | _id_oob(pods.quota_id, n_quotas)
              | _id_oob(pods.selector_id, pods.selector_match.shape[0])
              | _id_oob(pods.toleration_id, pods.tol_forbid.shape[0]))
    bad_domain = torch.zeros_like(pods.valid)
    any_group = torch.zeros((), dtype=torch.bool, device=req.device)
    domains = {}
    for dom_f, width, car_f in _families(pods):
        dom = getattr(pods, dom_f)
        bg = ((dom < -1) | (dom >= width)).any(dim=1)
        bad_domain = bad_domain | (getattr(pods, car_f) & bg[None, :]).any(
            dim=1)
        any_group = any_group | bg.any()
        domains[dom_f] = torch.where(bg[:, None], -1, dom).to(torch.int32)
    pod_bad = bad_nonfinite | bad_neg | bad_id | bad_domain
    health[0] |= (_flag(bad_nonfinite.any(), POD_NONFINITE)
                  | _flag(bad_neg.any(), POD_NEGATIVE)
                  | _flag(bad_id.any(), POD_ID_RANGE)
                  | _flag(any_group, POD_DOMAIN_RANGE))
    health[2] += pod_bad.sum().to(torch.int32)
    rows = pod_bad if force is None else force
    return pods.replace(
        valid=pods.valid & ~rows,
        requests=_row_where(rows, scrub(req), req),
        estimated=_row_where(rows, scrub(est), est),
        gpu_ratio=_row_where(rows, scrub(ratio), ratio), **domains), pod_bad


def guard_pods(pods: PodBatch, n_gangs: int, n_quotas: int,
               force: Optional[torch.Tensor] = None,
               health: Optional[torch.Tensor] = None
               ) -> Tuple[PodBatch, torch.Tensor, torch.Tensor]:
    """(scrubbed batch, pod_bad bool[P], health i32[3]) of
    `guard_pods_plain`: the kernel for CUDA tensors (two launches where
    a family is on, else one), the plain version for CPU tensors.
    n_gangs and n_quotas are the snapshot's table capacities; `force`
    and `health` as in `guard_nodes`. Requests, estimates, GPU ratio,
    valid and the domain maps of the families on are written anew."""
    p, r = pods.requests.shape
    dev = pods.requests.device
    fams = _families(pods)
    checks = [("requests", pods.requests, torch.float32, (p, r)),
              ("estimated", pods.estimated, torch.float32, (p, r)),
              ("gpu_ratio", pods.gpu_ratio, torch.float32, (p,)),
              ("valid", pods.valid, torch.bool, (p,))]
    checks += [(f, getattr(pods, f), torch.int32, (p,)) for f in (
        "gang_id", "quota_id", "selector_id", "toleration_id")]
    n = None
    for dom_f, _, car_f in fams:
        dom = getattr(pods, dom_f)
        n = dom.shape[1] if n is None else n
        checks += [(dom_f, dom, torch.int32, (None, n)),
                   (car_f, getattr(pods, car_f), torch.bool,
                    (p, dom.shape[0]))]
    if force is not None:
        checks.append(("force", force, torch.bool, (p,)))
    for name, x, dt, shape in checks:
        _launch.check_tensor(name, x, dt, shape, dev)
    health = _health(health, dev)
    if dev.type == "cpu":
        out, pod_bad = guard_pods_plain(pods, n_gangs, n_quotas, force,
                                        health)
        return out, pod_bad, health
    if dev.type != "cuda":
        raise ValueError(f"guard_pods: unsupported device {dev}")
    if r > MAX_R:
        raise ValueError(f"guard_pods: R={r} above {MAX_R}")
    groups = [getattr(pods, d).shape[0] for d, _, _ in fams]
    if any(g > MAX_GROUPS for g in groups):
        raise ValueError(f"guard_pods: {groups} groups, above {MAX_GROUPS} "
                         "a family")
    out = {f: torch.empty_like(getattr(pods, f))
           for f in ("requests", "estimated", "gpu_ratio", "valid")}
    pod_bad = torch.empty_like(pods.valid)
    by_dom = {d: (w, c) for d, w, c in fams}
    dom_in, car_in, dom_out, g_dims, d_dims = [], [], [], [], []
    for _, dom_f, _, car_f in DOMAIN_FAMILIES:
        on = dom_f in by_dom
        dom_in.append(getattr(pods, dom_f) if on else None)
        car_in.append(getattr(pods, car_f) if on else None)
        dom_out.append(torch.empty_like(getattr(pods, dom_f)) if on
                       else None)
        g_dims.append(getattr(pods, dom_f).shape[0] if on else 0)
        d_dims.append(by_dom[dom_f][0] if on else 0)
    n_groups = sum(g_dims)
    bad_group = torch.empty((max(n_groups, 1),), dtype=torch.bool,
                            device=dev)
    tensors = ([pods.requests, pods.estimated, pods.gpu_ratio, pods.gang_id,
                pods.quota_id, pods.selector_id, pods.toleration_id,
                pods.valid, force] + dom_in + car_in
               + [out["requests"], out["estimated"], out["gpu_ratio"],
                  out["valid"], pod_bad] + dom_out + [bad_group, health])
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if x is None else x.data_ptr() for x in tensors))
    dims = (ctypes.c_int * 13)(
        p, r, n or 0, n_gangs, n_quotas, pods.selector_match.shape[0],
        pods.tol_forbid.shape[0], *g_dims, *d_dims)
    launches = (1 if n_groups else 0) + (1 if p else 0)
    if launches:
        fn = TOOLCHAIN.function("guard_pods", "koord_guard_pods",
                                [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p])
        check(fn(ptrs, dims, _launch.stream(dev)), "guard_pods")
        guard_pods.launches += launches
    domains = {d: o for (_, d, _, _), o in zip(DOMAIN_FAMILIES, dom_out)
               if o is not None}
    return pods.replace(**out, **domains), pod_bad, health


guard_pods.launches = 0
