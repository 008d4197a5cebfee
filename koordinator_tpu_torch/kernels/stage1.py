"""K9 stage1_mask: the cascade's stage-1 candidate mask of a batch.

Kernel: `csrc/stage1_mask.cu`. Replaces koordinator_tpu/scheduler/
cascade.py:117 stage1_mask (ops/feasibility.py:44 resource_fit, :60
pod_ancestors, :72 quota_ceiling_ok) over the static gates: one pass
writes the bool[P, N] mask of the pairs that pass the factored static
gates (`cascade.GateTerms`), the batch-start fit over the checked dims
and the pod's quota ceiling. On the full-gate path it is the pair mask
that K4 and K6 AND their prefix rows into and K1 reads.
"""

from __future__ import annotations

import ctypes

import torch

from koordinator_tpu_torch.api.extension import NUM_RESOURCES
from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check
from koordinator_tpu_torch.ops import feasibility
from koordinator_tpu_torch.scheduler.cascade import GateTerms, expand_gates


def stage1_mask_plain(gates: GateTerms, req_fit: torch.Tensor,
                      requested_fit: torch.Tensor, alloc_fit: torch.Tensor,
                      pod_anc: torch.Tensor, used_fit: torch.Tensor,
                      runtime_fit: torch.Tensor, quota_depth: int,
                      eps: float) -> torch.Tensor:
    """bool[P, N]: `expand_gates(gates)` AND the fit of req_fit against
    each node's requested_fit / alloc_fit AND each pod's quota ceiling
    over the first quota_depth levels of pod_anc (`ops/feasibility.py`),
    the operands already restricted to the checked dims."""
    fit = torch.all(req_fit[:, None, :] + requested_fit[None]
                    <= alloc_fit[None] + eps, dim=-1)
    ceiling = feasibility.quota_ceiling_terms(pod_anc, used_fit, runtime_fit,
                                              req_fit, quota_depth, eps)
    return expand_gates(gates) & fit & ceiling[:, None]


def stage1_mask(gates: GateTerms, req_fit: torch.Tensor,
                requested_fit: torch.Tensor, alloc_fit: torch.Tensor,
                pod_anc: torch.Tensor, used_fit: torch.Tensor,
                runtime_fit: torch.Tensor, quota_depth: int,
                eps: float) -> torch.Tensor:
    """The mask of `stage1_mask_plain`: the kernel for CUDA tensors, the
    plain version for CPU tensors. `gates` over P pods and N nodes
    (selector table S x L; with tolerations the forbid table T x G);
    req_fit f32[P, F]; requested_fit, alloc_fit f32[N, F]; pod_anc
    i32[P, D] (-1 = no ancestor at that depth); used_fit, runtime_fit
    f32[Q, F]; 0 <= quota_depth <= D; F <= NUM_RESOURCES; on the card
    P / 64 <= 65 535 (a block owns 64 pods and 512 nodes)."""
    p, f = req_fit.shape
    n = gates.label_group.shape[0]
    s, labels = gates.selector_match.shape
    d = pod_anc.shape[1]
    q = used_fit.shape[0]
    dev = req_fit.device
    checks = [
        ("selector_id", gates.selector_id, torch.int32, (p,)),
        ("prod_gate", gates.prod_gate, torch.bool, (p,)),
        ("daemonset", gates.daemonset, torch.bool, (p,)),
        ("device_ok", gates.device_ok, torch.bool, (p,)),
        ("req_fit", req_fit, torch.float32, (p, f)),
        ("pod_anc", pod_anc, torch.int32, (p, d)),
        ("label_group", gates.label_group, torch.int32, (n,)),
        ("node_ok", gates.node_ok, torch.bool, (n,)),
        ("prod_node_ok", gates.prod_node_ok, torch.bool, (n,)),
        ("metric_fresh", gates.metric_fresh, torch.bool, (n,)),
        ("schedulable", gates.schedulable, torch.bool, (n,)),
        ("requested_fit", requested_fit, torch.float32, (n, f)),
        ("alloc_fit", alloc_fit, torch.float32, (n, f)),
        ("selector_match", gates.selector_match, torch.bool, (s, labels)),
        ("used_fit", used_fit, torch.float32, (q, f)),
        ("runtime_fit", runtime_fit, torch.float32, (q, f))]
    taints = gates.tol_forbid is not None
    t = groups = 0
    if taints:
        t, groups = gates.tol_forbid.shape
        checks += [
            ("toleration_id", gates.toleration_id, torch.int32, (p,)),
            ("taint_group", gates.taint_group, torch.int32, (n,)),
            ("tol_forbid", gates.tol_forbid, torch.bool, (t, groups))]
    for name, x, dt, shape in checks:
        _launch.check_tensor(name, x, dt, shape, dev)
    if not 0 <= quota_depth <= d:
        raise ValueError(f"stage1_mask: quota_depth={quota_depth} outside "
                         f"[0, {d}]")
    if f > NUM_RESOURCES:
        raise ValueError(f"stage1_mask: F={f} above {NUM_RESOURCES}")
    if dev.type == "cpu":
        return stage1_mask_plain(gates, req_fit, requested_fit, alloc_fit,
                                 pod_anc, used_fit, runtime_fit, quota_depth,
                                 eps)
    if dev.type != "cuda":
        raise ValueError(f"stage1_mask: unsupported device {dev}")
    if labels == 0 or (taints and (t == 0 or groups == 0)) or (
            quota_depth and q == 0):
        raise ValueError("stage1_mask: empty selector, toleration or quota "
                         "table")
    out = torch.empty((p, n), dtype=torch.bool, device=dev)
    if not (p and n):
        return out
    tensors = (gates.selector_id, gates.prod_gate, gates.daemonset,
               gates.device_ok, gates.toleration_id, req_fit, pod_anc,
               gates.label_group, gates.node_ok, gates.prod_node_ok,
               gates.metric_fresh, gates.schedulable, gates.taint_group,
               requested_fit, alloc_fit, gates.selector_match,
               gates.tol_forbid, used_fit, runtime_fit, out)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if x is None else x.data_ptr() for x in tensors))
    dims = (ctypes.c_int * 10)(p, n, f, s, labels, t, groups, d, quota_depth,
                               q)
    fn = TOOLCHAIN.function("stage1_mask", "koord_stage1_mask",
                            [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_float, ctypes.c_void_p])
    rc = fn(ptrs, dims, eps, _launch.stream(dev))
    check(rc, "stage1_mask")
    stage1_mask.launches += 1
    return out


stage1_mask.launches = 0
