"""Snapshot deltas on the device: per-node metric and topology rows, and
forget (un-assume) of failed binds, without re-uploading whole columns.

Counterpart of `koordinator_tpu/snapshot/delta.py`. A delta is K rows
(idx = -1 rows are padding) built on the host and moved to the
snapshot's device with the apply; `apply_metric_delta` and
`apply_topology_delta` replace those rows in the node and device
columns through kernel K16 (`kernels/delta_rows.py`: the touched
columns cloned, then every column's rows in two launches, the last row
winning on a repeated index as XLA's scatter leaves it). `forget_pods`
returns the charges of failed binds through kernel K3's ordered
scatter-adds (node requested and estimates, quota levels, gang counts,
NUMA takes, GPU and aux instances, reservation holds), then clamps. Each is
functional: it returns a new snapshot with `version` one higher and
writes nothing of the snapshot it was given.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from koordinator_tpu_torch.api.extension import (
    NUM_AUX_TYPES,
    PriorityClass,
    ResourceKind,
)
from koordinator_tpu_torch.kernels.delta_rows import delta_rows
from koordinator_tpu_torch.kernels._xla import xla_max, xla_min
from koordinator_tpu_torch.kernels.scatter import ordered_scatter_add_named
from koordinator_tpu_torch.ops.feasibility import pod_ancestors
from koordinator_tpu_torch.snapshot.schema import ClusterSnapshot, Struct

PROD = int(PriorityClass.PROD)
CPU = int(ResourceKind.CPU)

__all__ = ["NodeMetricDelta", "NodeTopologyDelta", "DeltaRejectReason",
           "apply_metric_delta", "apply_topology_delta", "delta_version",
           "forget_pods"]


class DeltaRejectReason(enum.Enum):
    """Why the store's version guard refused a delta (`SnapshotStore.
    take_delta_rejection`)."""

    STALE_VERSION = "stale_version"          # version < last applied
    DUPLICATE_VERSION = "duplicate_version"  # version == last applied


def delta_version(delta) -> Optional[int]:
    """Host-side read of a delta's source version; None = unversioned,
    which always applies. The version stays on the host (the deltas'
    `to` leaves it there), so this never reads the card."""
    v = getattr(delta, "source_version", None)
    if v is None:
        return None
    return int(np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v))


class _Delta(Struct):
    """`to(device)` moves the rows and leaves `source_version` (host
    metadata for the store's guard) where it is."""

    def to(self, device):
        version = self.source_version
        moved = super().to(device)
        return dataclasses.replace(moved, source_version=version)


@dataclasses.dataclass
class NodeMetricDelta(_Delta):
    """K node rows of the metric-derived columns; idx = -1 rows are
    padding. `source_version` is the producer's sequence number (i32[]
    on the host, or None = unversioned): the store, not the apply,
    refuses a version at or below the last applied one."""

    idx: torch.Tensor                       # i32[K] node row, -1 = pad
    metric_fresh: torch.Tensor              # bool[K]
    usage: torch.Tensor                     # f32[K, R]
    prod_usage: torch.Tensor                # f32[K, R]
    agg_usage: torch.Tensor                 # f32[K, NUM_AGG, R]
    has_agg: torch.Tensor                   # bool[K]
    assigned_estimated: torch.Tensor        # f32[K, R]
    assigned_correction: torch.Tensor       # f32[K, R]
    prod_assigned_estimated: torch.Tensor   # f32[K, R]
    prod_assigned_correction: torch.Tensor  # f32[K, R]
    source_version: Optional[torch.Tensor] = None


@dataclasses.dataclass
class NodeTopologyDelta(_Delta):
    """K node rows of the identity columns (node add, remove, update
    within the padded capacity) and the device pools, with the metric
    columns as a nested NodeMetricDelta. A removed node is a zeroed row
    (schedulable=False, allocatable=0, metric_fresh=False)."""

    idx: torch.Tensor                # i32[K] node row, -1 = pad
    allocatable: torch.Tensor        # f32[K, R]
    requested: torch.Tensor          # f32[K, R]
    schedulable: torch.Tensor        # bool[K]
    label_group: torch.Tensor        # i32[K]
    taint_group: torch.Tensor        # i32[K]
    numa_cap: torch.Tensor           # f32[K, Z, 2]
    numa_free: torch.Tensor          # f32[K, Z, 2]
    numa_valid: torch.Tensor         # bool[K, Z]
    numa_policy: torch.Tensor        # i32[K]
    cpu_amplification: torch.Tensor  # f32[K]
    gpu_total: torch.Tensor          # f32[K, 3]
    gpu_free: torch.Tensor           # f32[K, I, 3]
    gpu_valid: torch.Tensor          # bool[K, I]
    gpu_numa: torch.Tensor           # i32[K, I]
    gpu_pcie: torch.Tensor           # i32[K, I]
    aux_free: torch.Tensor           # f32[K, 2, J]
    aux_valid: torch.Tensor          # bool[K, 2, J]
    metric: Optional[NodeMetricDelta] = None  # same idx
    source_version: Optional[torch.Tensor] = None


METRIC_FIELDS = ("metric_fresh", "usage", "prod_usage", "agg_usage",
                 "has_agg", "assigned_estimated", "assigned_correction",
                 "prod_assigned_estimated", "prod_assigned_correction")
TOPOLOGY_NODE_FIELDS = ("allocatable", "requested", "schedulable",
                        "label_group", "taint_group", "numa_cap",
                        "numa_free", "numa_valid", "numa_policy",
                        "cpu_amplification")
TOPOLOGY_DEVICE_FIELDS = ("gpu_total", "gpu_free", "gpu_valid", "gpu_numa",
                          "gpu_pcie", "aux_free", "aux_valid")


def apply_metric_delta(snap: ClusterSnapshot,
                       delta: NodeMetricDelta) -> ClusterSnapshot:
    """The metric rows replaced (delta.py:108): each row is that node's
    full recomputed metric view."""
    dev = snap.nodes.allocatable.device
    delta = delta.to(dev)
    nodes = snap.nodes
    cols = delta_rows([(getattr(nodes, f), getattr(delta, f), 0)
                       for f in METRIC_FIELDS], [delta.idx])
    return snap.replace(nodes=nodes.replace(**dict(zip(METRIC_FIELDS, cols))),
                        version=snap.version + 1)


def apply_topology_delta(snap: ClusterSnapshot,
                         delta: NodeTopologyDelta) -> ClusterSnapshot:
    """The identity, device and metric rows replaced (delta.py:209), all
    in one K16 call: the identity and device columns by delta.idx, the
    metric columns by delta.metric.idx."""
    dev = snap.nodes.allocatable.device
    delta = delta.to(dev)
    nodes, devices, metric = snap.nodes, snap.devices, delta.metric
    columns = ([(getattr(nodes, f), getattr(delta, f), 0)
                for f in TOPOLOGY_NODE_FIELDS]
               + [(getattr(devices, f), getattr(delta, f), 0)
                  for f in TOPOLOGY_DEVICE_FIELDS]
               + [(getattr(nodes, f), getattr(metric, f), 1)
                  for f in METRIC_FIELDS])
    cols = delta_rows(columns, [delta.idx, metric.idx])
    n_node = len(TOPOLOGY_NODE_FIELDS)
    n_dev = len(TOPOLOGY_DEVICE_FIELDS)
    node_cols = dict(zip(TOPOLOGY_NODE_FIELDS, cols[:n_node]))
    node_cols.update(zip(METRIC_FIELDS, cols[n_node + n_dev:]))
    return snap.replace(
        nodes=nodes.replace(**node_cols),
        devices=devices.replace(**dict(zip(TOPOLOGY_DEVICE_FIELDS,
                                           cols[n_node:n_node + n_dev]))),
        version=snap.version + 1)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x [P, ...] as [P, C] for K3."""
    return x.reshape(x.shape[0], -1).contiguous()


def forget_pods(snap: ClusterSnapshot, pods, result,
                mask: torch.Tensor,
                enable_amplification: Optional[bool] = None
                ) -> ClusterSnapshot:
    """Un-assume (delta.py:254): return the charges of the `mask`ed pods
    of a schedule_batch result whose binds failed, the exact inverse of
    its commit: node requested (non-consumers only), the estimates,
    quota used at every level, gang assumed, NUMA takes (to the node's
    pool or the slot's hold), GPU instances (likewise), aux instances
    (delta.py:344-356, both pools in one scatter, unclamped), slot free,
    and a forgotten AllocateOnce consumer re-opens its slot. The adds
    run through K3 in the reference's order; the clamps follow XLA's
    max and min. A CPU-bind pod of an amplified result
    (`result.amplified`, or `enable_amplification` where given) returns
    its CPU times its node's ratio, as it was charged
    (delta.py:284-291)."""
    from koordinator_tpu_torch.scheduler.plugins import deviceshare

    amp = enable_amplification
    if amp is None:
        amp = getattr(result, "amplified", False)
    nodes, quotas, gangs = snap.nodes, snap.quotas, snap.gangs
    resv, devices = snap.reservations, snap.devices
    dev = nodes.allocatable.device
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    n = nodes.num_nodes
    n_res = resv.valid.shape[0]
    assign = result.assignment
    und = mask & (assign >= 0)
    on_slot = result.res_slot >= 0
    i32 = torch.int32

    def at(cond, idx, drop):
        return torch.where(cond, idx, drop).to(i32)

    node_tgt = at(und, assign, n)
    node_only = at(und & ~on_slot, assign, n)
    und_f = und.to(torch.float32)
    req = pods.requests * und_f[:, None]
    req_node = req
    if amp:
        f_amp = torch.where(und & pods.numa_single, nodes.cpu_amplification[
            assign.clamp(0, n - 1).long()], 1.0)
        req_node = req.clone()
        req_node[:, CPU] = req_node[:, CPU] * f_amp
    # every scatter of the forget in one grouped K3 call
    commits = {"requested": (nodes.requested, node_only, -req_node)}
    est = pods.estimated * und_f[:, None]
    commits["est"] = (nodes.assigned_estimated, node_tgt, -est)
    is_prod = (pods.priority_class == PROD).to(torch.float32)
    commits["prod_est"] = (nodes.prod_assigned_estimated, node_tgt,
                           -est * is_prod[:, None])

    n_quotas = quotas.used.shape[0]
    anc = torch.where(und[:, None], pod_ancestors(quotas, pods), -1)
    commits["used"] = (quotas.used,
                       at(anc >= 0, anc, n_quotas).T.contiguous(), -req)

    n_gangs = gangs.assumed.shape[0]
    gang_tgt = at(und & (pods.gang_id >= 0), pods.gang_id.clamp_min(0),
                  n_gangs)
    ones = torch.ones((pods.gang_id.shape[0], 1), dtype=torch.float32,
                      device=dev)
    commits["gang"] = (torch.zeros((n_gangs, 1), dtype=torch.float32,
                                   device=dev), gang_tgt, ones)

    take = _rows(result.numa_take * und_f[:, None, None])
    commits["numa"] = (_rows(nodes.numa_free), node_only, take)
    slot_tgt = at(und & on_slot, result.res_slot.clamp_min(0), n_res)
    commits["resv_numa"] = (_rows(resv.numa_free), slot_tgt, take)

    if devices.num_instances:
        _, per_f = deviceshare.per_instance_at(
            devices, deviceshare.gpu_request(pods.requests, pods.gpu_ratio),
            assign)
        g_upd = _rows(result.gpu_take.to(torch.float32)[:, :, None]
                      * per_f[:, None, :] * und_f[:, None, None])
        commits["gpu"] = (_rows(devices.gpu_free), node_only, g_upd)
        commits["resv_gpu"] = (_rows(resv.gpu_free), slot_tgt, g_upd)

    aux_free = devices.aux_free
    n_aux = aux_free.shape[2]
    if n_aux:
        a_req = deviceshare.aux_request(pods.requests)
        took = und[:, None] & (a_req > 0) & (result.aux_inst >= 0)
        n_seg = n * NUM_AUX_TYPES * n_aux
        seg = deviceshare.aux_segments(assign.clamp_min(0), result.aux_inst,
                                       took, n_aux, n_seg)
        commits["aux"] = (aux_free.reshape(n_seg, 1), seg.T.reshape(-1),
                          (a_req * took).T.reshape(-1, 1))

    commits["resv_free"] = (resv.free, slot_tgt, req)
    outs = ordered_scatter_add_named(commits)
    requested, assigned_est = outs["requested"], outs["est"]
    prod_est, used = outs["prod_est"], outs["used"]
    assumed = gangs.assumed - outs["gang"][:, 0].to(i32)
    numa_free = xla_min(outs["numa"].view(nodes.numa_free.shape),
                        nodes.numa_cap)
    resv_numa = outs["resv_numa"].view(resv.numa_free.shape)
    gpu_free, resv_gpu = devices.gpu_free, resv.gpu_free
    if "gpu" in outs:
        gpu_free = outs["gpu"].view(devices.gpu_free.shape)
        resv_gpu = outs["resv_gpu"].view(resv.gpu_free.shape)
    if "aux" in outs:
        aux_free = outs["aux"].view(aux_free.shape)
    resv_free = outs["resv_free"]
    reopen = torch.zeros((n_res + 1,), dtype=torch.bool, device=dev)
    reopen = reopen.index_fill_(0, slot_tgt.long(), True)[:n_res]
    return snap.replace(
        nodes=nodes.replace(requested=xla_max(requested, 0.0),
                            assigned_estimated=xla_max(assigned_est, 0.0),
                            prod_assigned_estimated=xla_max(prod_est, 0.0),
                            numa_free=numa_free),
        quotas=quotas.replace(used=xla_max(used, 0.0)),
        gangs=gangs.replace(assumed=assumed.clamp_min(0)),
        reservations=resv.replace(free=resv_free, numa_free=resv_numa,
                                  gpu_free=resv_gpu,
                                  valid=resv.valid | (reopen
                                                      & resv.allocate_once)),
        devices=devices.replace(gpu_free=gpu_free, aux_free=aux_free),
        version=snap.version + 1)
