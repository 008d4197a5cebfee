"""Tensor twins of the JAX package's snapshot structs.

Each struct is a `@dataclass` of torch tensors with the same field
names, dtypes and pad fills as `koordinator_tpu/snapshot/schema.py`
(`STRUCT_SPECS`); `STRUCT_SPECS` below repeats those spec strings so
that a test can hold the two tables against each other, and
`bridge.py` reads them to carry numpy arrays across. Shapes: N nodes,
P pods, Q quotas, G gangs, V reservation slots, Z NUMA zones, I GPU
instances, J aux instances, R = NUM_RESOURCES.

Structs are immutable by convention: `replace(**kw)` returns a copy
with some fields swapped (as flax's `replace` does), `to(device)` moves
every tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

AGG_TYPES = ("avg", "p50", "p90", "p95", "p99")
NUM_AGG = len(AGG_TYPES)
MAX_QUOTA_DEPTH = 6
NUM_DEV_DIMS = 3

# spec dtype token -> torch dtype
DTYPES = {"f32": torch.float32, "i32": torch.int32, "i8": torch.int8,
          "bool": torch.bool}


class Struct:
    """Shared helpers of the tensor dataclasses."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device):
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, Struct)):
                v = v.to(device)
            out[f.name] = v
        return dataclasses.replace(self, **out)


@dataclasses.dataclass
class NodeState(Struct):
    allocatable: torch.Tensor      # f32[N, R]
    requested: torch.Tensor        # f32[N, R]
    usage: torch.Tensor            # f32[N, R]
    prod_usage: torch.Tensor       # f32[N, R]
    agg_usage: torch.Tensor        # f32[N, NUM_AGG, R]
    assigned_estimated: torch.Tensor        # f32[N, R]
    assigned_correction: torch.Tensor       # f32[N, R]
    prod_assigned_estimated: torch.Tensor   # f32[N, R]
    prod_assigned_correction: torch.Tensor  # f32[N, R]
    metric_fresh: torch.Tensor     # bool[N]
    has_agg: torch.Tensor          # bool[N]
    schedulable: torch.Tensor      # bool[N]
    label_group: torch.Tensor      # i32[N]
    taint_group: torch.Tensor      # i32[N]
    numa_cap: torch.Tensor         # f32[N, Z, 2]
    numa_free: torch.Tensor        # f32[N, Z, 2]
    numa_valid: torch.Tensor       # bool[N, Z]
    numa_policy: torch.Tensor      # i32[N]
    cpu_amplification: torch.Tensor  # f32[N]

    @property
    def num_nodes(self) -> int:
        return self.allocatable.shape[0]


@dataclasses.dataclass
class PodBatch(Struct):
    requests: torch.Tensor         # f32[P, R]
    estimated: torch.Tensor        # f32[P, R]
    qos: torch.Tensor              # i8[P]
    priority_class: torch.Tensor   # i8[P]
    priority: torch.Tensor         # i32[P]
    gang_id: torch.Tensor          # i32[P], -1 = none
    quota_id: torch.Tensor         # i32[P], -1 = none
    selector_id: torch.Tensor      # i32[P], -1 = match all
    selector_match: torch.Tensor   # bool[S, L]
    reservation_owner: torch.Tensor  # i32[P]
    gpu_ratio: torch.Tensor        # f32[P]
    numa_single: torch.Tensor      # bool[P]
    daemonset: torch.Tensor        # bool[P]
    toleration_id: torch.Tensor    # i32[P]
    tol_forbid: torch.Tensor       # bool[T, TG]
    tol_prefer: torch.Tensor       # f32[T, TG]
    spread_id: torch.Tensor        # i32[P]
    spread_carrier: torch.Tensor   # bool[P, SG]
    spread_member: torch.Tensor    # bool[P, SG]
    spread_max_skew: torch.Tensor  # f32[SG]
    spread_domain: torch.Tensor    # i32[SG, N]
    spread_count0: torch.Tensor    # f32[SG, DM]
    spread_dvalid: torch.Tensor    # bool[SG, DM]
    anti_id: torch.Tensor          # i32[P]
    anti_member: torch.Tensor      # bool[P, AG]
    anti_carrier: torch.Tensor     # bool[P, AG]
    anti_domain: torch.Tensor      # i32[AG, N]
    anti_count0: torch.Tensor      # f32[AG, DM]
    anti_carrier_count0: torch.Tensor  # f32[AG, DM]
    aff_id: torch.Tensor           # i32[P]
    aff_carrier: torch.Tensor      # bool[P, FG]
    aff_member: torch.Tensor       # bool[P, FG]
    aff_domain: torch.Tensor       # i32[FG, N]
    aff_count0: torch.Tensor       # f32[FG, DM]
    valid: torch.Tensor            # bool[P]
    # which constraint families the batch models (host-side switches)
    has_taints: bool = False
    has_spread: bool = False
    has_anti: bool = False
    has_aff: bool = False

    @property
    def num_pods(self) -> int:
        return self.requests.shape[0]


# the [P]-leading PodBatch columns that a per-pod gather (chunking, the
# straggler tail) permutes together
PER_POD_FIELDS = ("requests", "estimated", "qos", "priority_class",
                  "priority", "gang_id", "quota_id", "selector_id",
                  "reservation_owner", "gpu_ratio", "numa_single",
                  "daemonset", "toleration_id", "spread_id",
                  "spread_carrier", "spread_member", "anti_id",
                  "anti_member", "anti_carrier", "aff_id", "aff_carrier",
                  "aff_member", "valid")


@dataclasses.dataclass
class QuotaState(Struct):
    min: torch.Tensor              # f32[Q, R]
    max: torch.Tensor              # f32[Q, R]
    shared_weight: torch.Tensor    # f32[Q, R]
    parent: torch.Tensor           # i32[Q]
    ancestors: torch.Tensor        # bool[Q, Q]
    depth_ancestor: torch.Tensor   # i32[Q, MAX_QUOTA_DEPTH]
    used: torch.Tensor             # f32[Q, R]
    demand: torch.Tensor           # f32[Q, R]
    allow_lent: torch.Tensor       # bool[Q]
    runtime: torch.Tensor          # f32[Q, R]
    valid: torch.Tensor            # bool[Q]


@dataclasses.dataclass
class GangState(Struct):
    min_member: torch.Tensor       # i32[G]
    member_count: torch.Tensor     # i32[G]
    assumed: torch.Tensor          # i32[G]
    strict: torch.Tensor           # bool[G]
    satisfied: torch.Tensor        # bool[G]
    valid: torch.Tensor            # bool[G]


@dataclasses.dataclass
class DeviceState(Struct):
    gpu_total: torch.Tensor        # f32[N, 3]
    gpu_free: torch.Tensor         # f32[N, I, 3]
    gpu_valid: torch.Tensor        # bool[N, I]
    gpu_numa: torch.Tensor         # i32[N, I]
    gpu_pcie: torch.Tensor         # i32[N, I]
    aux_free: torch.Tensor         # f32[N, 2, J]
    aux_valid: torch.Tensor        # bool[N, 2, J]

    @property
    def num_instances(self) -> int:
        return self.gpu_free.shape[1]


@dataclasses.dataclass
class ReservationState(Struct):
    node: torch.Tensor             # i32[V]
    free: torch.Tensor             # f32[V, R]
    owner_group: torch.Tensor      # i32[V]
    allocate_once: torch.Tensor    # bool[V]
    valid: torch.Tensor            # bool[V]
    gpu_free: torch.Tensor         # f32[V, I, 3]
    gpu_valid: torch.Tensor        # bool[V, I]
    numa_free: torch.Tensor        # f32[V, Z, 2]
    numa_valid: torch.Tensor       # bool[V, Z]


@dataclasses.dataclass
class ClusterSnapshot(Struct):
    nodes: NodeState
    quotas: QuotaState
    gangs: GangState
    reservations: ReservationState
    devices: DeviceState
    version: torch.Tensor          # i32[]

    @property
    def num_nodes(self) -> int:
        return self.nodes.num_nodes


# The JAX package's STRUCT_SPECS, field for field: dtype, dims and the
# pad predicate of each padded dim ("~pad:<fill>"). A field whose spec
# names another struct nests it; a leading "?" marks a leaf that may be
# None. The delta structs live in `snapshot/delta.py`. Bare-symbol entries of the reference
# (num_nodes = "N") are properties here and are left out.
STRUCT_SPECS: Dict[str, Dict[str, str]] = {
    "NodeState": {
        "allocatable": "f32[N~pad:unschedulable,R]",
        "requested": "f32[N~pad:unschedulable,R]",
        "usage": "f32[N~pad:unschedulable,R]",
        "prod_usage": "f32[N~pad:unschedulable,R]",
        "agg_usage": "f32[N~pad:unschedulable,AGG,R]",
        "assigned_estimated": "f32[N~pad:unschedulable,R]",
        "assigned_correction": "f32[N~pad:unschedulable,R]",
        "prod_assigned_estimated": "f32[N~pad:unschedulable,R]",
        "prod_assigned_correction": "f32[N~pad:unschedulable,R]",
        "metric_fresh": "bool[N~pad:false]",
        "has_agg": "bool[N~pad:false]",
        "schedulable": "bool[N~pad:false]",
        "label_group": "i32[N~pad:zero]",
        "taint_group": "i32[N~pad:zero]",
        "numa_cap": "f32[N~pad:unschedulable,Z~pad:zero,2]",
        "numa_free": "f32[N~pad:unschedulable,Z~pad:zero,2]",
        "numa_valid": "bool[N~pad:false,Z~pad:false]",
        "numa_policy": "i32[N~pad:zero]",
        "cpu_amplification": "f32[N~pad:one]",
    },
    "PodBatch": {
        "requests": "f32[P~pad:zero,R]",
        "estimated": "f32[P~pad:zero,R]",
        "qos": "i8[P~pad:zero]",
        "priority_class": "i8[P~pad:zero]",
        "priority": "i32[P~pad:zero]",
        "gang_id": "i32[P~pad:-1]",
        "quota_id": "i32[P~pad:-1]",
        "selector_id": "i32[P~pad:-1]",
        "selector_match": "bool[S,L]",
        "reservation_owner": "i32[P~pad:-1]",
        "gpu_ratio": "f32[P~pad:zero]",
        "numa_single": "bool[P~pad:false]",
        "daemonset": "bool[P~pad:false]",
        "toleration_id": "i32[P~pad:zero]",
        "tol_forbid": "bool[T,TG]",
        "tol_prefer": "f32[T,TG]",
        "spread_id": "i32[P~pad:-1]",
        "spread_carrier": "bool[P~pad:false,SG]",
        "spread_member": "bool[P~pad:false,SG]",
        "spread_max_skew": "f32[SG]",
        "spread_domain": "i32[SG,N~pad:-1]",
        "spread_count0": "f32[SG,DM~pad:zero]",
        "spread_dvalid": "bool[SG,DM~pad:false]",
        "anti_id": "i32[P~pad:-1]",
        "anti_member": "bool[P~pad:false,AG]",
        "anti_carrier": "bool[P~pad:false,AG]",
        "anti_domain": "i32[AG,N~pad:-1]",
        "anti_count0": "f32[AG,DM~pad:zero]",
        "anti_carrier_count0": "f32[AG,DM~pad:zero]",
        "aff_id": "i32[P~pad:-1]",
        "aff_carrier": "bool[P~pad:false,FG]",
        "aff_member": "bool[P~pad:false,FG]",
        "aff_domain": "i32[FG,N~pad:-1]",
        "aff_count0": "f32[FG,DM~pad:zero]",
        "valid": "bool[P~pad:false]",
    },
    "QuotaState": {
        "min": "f32[Q~pad:zero,R]",
        "max": "f32[Q~pad:inf,R]",
        "shared_weight": "f32[Q~pad:zero,R]",
        "parent": "i32[Q~pad:-1]",
        "ancestors": "bool[Q~pad:false,Q~pad:false]",
        "depth_ancestor": "i32[Q~pad:-1,QD]",
        "used": "f32[Q~pad:zero,R]",
        "demand": "f32[Q~pad:zero,R]",
        "allow_lent": "bool[Q~pad:one]",
        "runtime": "f32[Q~pad:inf,R]",
        "valid": "bool[Q~pad:false]",
    },
    "GangState": {
        "min_member": "i32[G~pad:one]",
        "member_count": "i32[G~pad:zero]",
        "assumed": "i32[G~pad:zero]",
        "strict": "bool[G~pad:one]",
        "satisfied": "bool[G~pad:false]",
        "valid": "bool[G~pad:false]",
    },
    "DeviceState": {
        "gpu_total": "f32[N~pad:zero,DEV]",
        "gpu_free": "f32[N~pad:zero,I~pad:zero,DEV]",
        "gpu_valid": "bool[N~pad:false,I~pad:false]",
        "gpu_numa": "i32[N~pad:-1,I~pad:-1]",
        "gpu_pcie": "i32[N~pad:-1,I~pad:-1]",
        "aux_free": "f32[N~pad:zero,AX,J~pad:zero]",
        "aux_valid": "bool[N~pad:false,AX,J~pad:false]",
    },
    "ReservationState": {
        "node": "i32[V~pad:-1]",
        "free": "f32[V~pad:zero,R]",
        "owner_group": "i32[V~pad:-1]",
        "allocate_once": "bool[V~pad:one]",
        "valid": "bool[V~pad:false]",
        "gpu_free": "f32[V~pad:zero,I~pad:zero,DEV]",
        "gpu_valid": "bool[V~pad:false,I~pad:false]",
        "numa_free": "f32[V~pad:zero,Z~pad:zero,2]",
        "numa_valid": "bool[V~pad:false,Z~pad:false]",
    },
    "ClusterSnapshot": {
        "nodes": "NodeState",
        "quotas": "QuotaState",
        "gangs": "GangState",
        "reservations": "ReservationState",
        "devices": "DeviceState",
        "version": "i32[]",
    },
    "NodeMetricDelta": {
        "idx": "i32[K~pad:-1]",
        "metric_fresh": "bool[K~pad:false]",
        "usage": "f32[K~pad:zero,R]",
        "prod_usage": "f32[K~pad:zero,R]",
        "agg_usage": "f32[K~pad:zero,AGG,R]",
        "has_agg": "bool[K~pad:false]",
        "assigned_estimated": "f32[K~pad:zero,R]",
        "assigned_correction": "f32[K~pad:zero,R]",
        "prod_assigned_estimated": "f32[K~pad:zero,R]",
        "prod_assigned_correction": "f32[K~pad:zero,R]",
        "source_version": "?i32[]",
    },
    "NodeTopologyDelta": {
        "idx": "i32[K~pad:-1]",
        "allocatable": "f32[K~pad:zero,R]",
        "requested": "f32[K~pad:zero,R]",
        "schedulable": "bool[K~pad:false]",
        "label_group": "i32[K~pad:zero]",
        "taint_group": "i32[K~pad:zero]",
        "numa_cap": "f32[K~pad:zero,Z~pad:zero,2]",
        "numa_free": "f32[K~pad:zero,Z~pad:zero,2]",
        "numa_valid": "bool[K~pad:false,Z~pad:false]",
        "numa_policy": "i32[K~pad:zero]",
        "cpu_amplification": "f32[K~pad:one]",
        "gpu_total": "f32[K~pad:zero,DEV]",
        "gpu_free": "f32[K~pad:zero,I~pad:zero,DEV]",
        "gpu_valid": "bool[K~pad:false,I~pad:false]",
        "gpu_numa": "i32[K~pad:-1,I~pad:-1]",
        "gpu_pcie": "i32[K~pad:-1,I~pad:-1]",
        "aux_free": "f32[K~pad:zero,AX,J~pad:zero]",
        "aux_valid": "bool[K~pad:false,AX,J~pad:false]",
        "metric": "NodeMetricDelta",
        "source_version": "?i32[]",
    },
    "ScheduleResult": {
        "assignment": "i32[P~pad:-1]",
        "chosen_score": "f32[P~pad:-1]",
        "numa_zone": "i32[P~pad:-1]",
        "numa_take": "f32[P~pad:zero,Z~pad:zero,2]",
        "gpu_take": "bool[P~pad:false,I~pad:false]",
        "aux_inst": "i32[P~pad:-1,AX]",
        "res_slot": "i32[P~pad:-1]",
        "gang_failed": "bool[G~pad:false]",
        "snapshot": "ClusterSnapshot",
    },
}


def spec_dtype(spec: str):
    """The torch dtype of a leaf spec ("f32[N,R]" -> float32); None for
    a nested struct."""
    head = spec.split("[", 1)[0]
    return DTYPES.get(head)

