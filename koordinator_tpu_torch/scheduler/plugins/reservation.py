"""Reservation slots as virtual node columns.

Counterpart of `koordinator_tpu/scheduler/plugins/reservation.py`
slot_columns and rebuild_reservations. A reservation's full hold is
already charged on its node's `requested` (the reserve pod); a pod
that its owners match may consume the slot instead of the node's open
capacity, as an extra column of the selection whose capacity is the
slot's remaining free (`core.schedule_batch` appends the V slots after
the N nodes). An AllocateOnce slot admits one consumer and is then
exhausted. The post-batch state draws the consumers' requests, zone
takes and instance takes down from the slots' holds, in the ordered
scatter (kernel K3).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from koordinator_tpu_torch.api.extension import AUX_KINDS
from koordinator_tpu_torch.kernels.scatter import ordered_scatter_add_named
from koordinator_tpu_torch.scheduler.cascade import GateTerms, expand_gates
from koordinator_tpu_torch.scheduler.plugins.deviceshare import (
    has_gpu_request,
)
from koordinator_tpu_torch.snapshot.schema import (
    ClusterSnapshot,
    PodBatch,
    ReservationState,
)


def slot_columns(snap: ClusterSnapshot, pods: PodBatch, gates: GateTerms
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(slot_ok bool[P, V], slot_alloc f32[V, R], slot_node i32[V]): pod
    p may consume slot v when the slot is valid and on a node, the pod's
    reservation owner is the slot's owner group, the batch's static
    gates (`gates`, without the device prefilter's row: a consumer draws
    from the hold, not the node's open pools) pass at the slot's node, a
    single-NUMA pod's slot holds a zone and a GPU pod's holds instances,
    and the pod asks for no aux resource; the slot's capacity is its
    remaining free; its node, -1 where it has none."""
    resv = snap.reservations
    if not resv.valid.shape[0]:   # no slot: no column to gate
        return (torch.zeros((pods.num_pods, 0), dtype=torch.bool,
                            device=pods.valid.device), resv.free, resv.node)
    node_c = resv.node.clamp_min(0).long()
    owner = pods.reservation_owner[:, None]
    has_zone = resv.numa_valid.any(dim=-1)
    has_gpu = resv.gpu_valid.any(dim=-1)
    has_aux = torch.zeros_like(pods.valid)
    for kind in AUX_KINDS:
        has_aux = has_aux | (pods.requests[:, kind] > 0)
    slot_ok = ((resv.valid & (resv.node >= 0))[None, :]
               & (owner >= 0) & (owner == resv.owner_group[None, :])
               & expand_gates(gates, node_c, device_term=False)
               & (~pods.numa_single[:, None] | has_zone[None, :])
               & (~has_gpu_request(pods.requests, pods.gpu_ratio)[:, None]
                  | has_gpu[None, :])
               & ~has_aux[:, None])
    return slot_ok, resv.free, resv.node


def reservation_groups(resv: ReservationState, pods: PodBatch,
                         res_slot: torch.Tensor, ok: torch.Tensor,
                         numa_take: Optional[torch.Tensor] = None,
                         gpu_take: Optional[torch.Tensor] = None,
                         gpu_per_inst: Optional[torch.Tensor] = None
                         ) -> Tuple[Dict[str, tuple], Callable]:
    """(groups, finish): the K3 groups of `rebuild_reservations` (the
    consumed requests and a count of consumers in one, the instance and
    zone takes) and the function that turns their outputs into the new
    state, so that the scheduler's rebuild runs them with its own
    commits in one call. With no slots, no groups."""
    n_res = resv.valid.shape[0]
    if not n_res:
        return {}, lambda outs: resv
    p = res_slot.shape[0]
    consuming = ok & (res_slot >= 0)
    tgt = torch.where(consuming, res_slot, n_res).to(torch.int32)
    # the consumed requests and a count of consumers, in one scatter
    cols = torch.cat([pods.requests, torch.ones_like(pods.requests[:, :1])],
                     dim=1) * consuming[:, None]
    groups = {"drawn": (torch.zeros((n_res, cols.shape[1]), dtype=cols.dtype,
                                    device=cols.device), tgt, cols)}
    if gpu_take is not None and gpu_per_inst is not None:
        v, i, dd = resv.gpu_free.shape
        groups["gpu"] = (resv.gpu_free.reshape(v, i * dd), tgt,
                         -(gpu_take[:, :, None] * gpu_per_inst[:, None, :]
                           * consuming[:, None, None]).reshape(p, i * dd))
    if numa_take is not None:
        v, z, two = resv.numa_free.shape
        groups["numa"] = (resv.numa_free.reshape(v, z * two), tgt,
                          -(numa_take * consuming[:, None, None]).reshape(
                              p, z * two))

    def finish(outs: Dict[str, torch.Tensor]) -> ReservationState:
        drawn = outs["drawn"]
        exhausted = resv.allocate_once & (drawn[:, -1] > 0)
        new_gpu_free, new_numa_free = resv.gpu_free, resv.numa_free
        if "gpu" in outs:
            new_gpu_free = torch.clamp_min(outs["gpu"], 0.0).view(
                resv.gpu_free.shape)
        if "numa" in outs:
            new_numa_free = torch.clamp_min(outs["numa"], 0.0).view(
                resv.numa_free.shape)
        return resv.replace(
            free=torch.clamp_min(resv.free - drawn[:, :-1], 0.0),
            gpu_free=new_gpu_free, numa_free=new_numa_free,
            valid=resv.valid & ~exhausted)

    return groups, finish


def rebuild_reservations(resv: ReservationState, pods: PodBatch,
                         res_slot: torch.Tensor, ok: torch.Tensor,
                         numa_take: Optional[torch.Tensor] = None,
                         gpu_take: Optional[torch.Tensor] = None,
                         gpu_per_inst: Optional[torch.Tensor] = None
                         ) -> ReservationState:
    """The reservation state after the batch, from the surviving
    assignment (pods the gang barrier revoked give their share back):
    each slot's free less its consumers' requests, floored at 0; its
    zone and instance holds less their takes (`numa_take` f32[P, Z, 2];
    `gpu_take` bool[P, I] times `gpu_per_inst` f32[P, 3]) where the
    batch ran those paths; an AllocateOnce slot that a pod consumed is
    no longer valid (it keeps its remainder, so that a later forget can
    restore it). With no slots, unchanged."""
    groups, finish = reservation_groups(
        resv, pods, res_slot, ok, numa_take=numa_take, gpu_take=gpu_take,
        gpu_per_inst=gpu_per_inst)
    return finish(ordered_scatter_add_named(groups))
