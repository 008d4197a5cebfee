"""Reservation slots as virtual node columns: the form with no slots.

Counterpart of `koordinator_tpu/scheduler/plugins/reservation.py`
slot_columns and rebuild_reservations for V = 0, the slim workload's
snapshot. Live slots (V > 0) belong to the full-gate path and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from koordinator_tpu_torch.snapshot.schema import (
    ClusterSnapshot,
    PodBatch,
    ReservationState,
)


def _require_no_slots(resv: ReservationState) -> None:
    if resv.valid.shape[0]:
        raise NotImplementedError(
            "reservation slots (V > 0) are not ported; the slim path "
            "schedules against a snapshot without them")


def slot_columns(snap: ClusterSnapshot, pods: PodBatch
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(slot_ok bool[P, 0], slot_alloc f32[0, R], slot_node i32[0])."""
    _require_no_slots(snap.reservations)
    resv = snap.reservations
    slot_ok = torch.zeros((pods.num_pods, 0), dtype=torch.bool,
                          device=pods.valid.device)
    return slot_ok, resv.free, resv.node


def rebuild_reservations(resv: ReservationState, pods: PodBatch,
                         res_slot: torch.Tensor, ok: torch.Tensor,
                         numa_take: Optional[torch.Tensor] = None,
                         gpu_take: Optional[torch.Tensor] = None,
                         gpu_per_inst: Optional[torch.Tensor] = None
                         ) -> ReservationState:
    """The reservation state after the batch, given the consumers'
    slots, the placed pods, and their zone takes, GPU instance takes
    and per-instance requests where the batch ran those paths (the
    reference's arguments): with no slots, unchanged."""
    _require_no_slots(resv)
    return resv
