"""The typed host objects the descheduler, the quota revoke and the
node-resource controller read.

Own copy of the parts of `koordinator_tpu/api/types.py` that the port's
host code consumes (the port imports nothing of the JAX package):
`ObjectMeta`, `PodMetricInfo`, and the fields of `Pod` (with its QoS
and priority class), `Node` and `NodeMetric` (with `is_expired`;
slo/v1alpha1 NodeMetric, nodemetric_types.go:39-123) that the balance
plan, the eviction limiter, config 5's builder, the quota overuse
revoke and koord-manager's batch/mid overcommit read.
Field names and defaults are the reference's, so that
`bridge.api_from_reference` can carry its objects across by attribute.
ResourceList is a plain dict keyed by ResourceKind in canonical device
units (cpu-like: millicores, memory-like: MiB).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from koordinator_tpu_torch.api.extension import (
    PriorityClass,
    QoSClass,
    ResourceKind,
    priority_class_of,
)

ResourceList = Dict[ResourceKind, float]


@dataclasses.dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def namespaced_name(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclasses.dataclass
class Pod:
    """A pod as the host controllers see it. `requests` aggregates the
    pod's containers."""

    meta: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    requests: ResourceList = dataclasses.field(default_factory=dict)
    priority: Optional[int] = None
    node_name: str = ""          # "" == pending
    priority_class_name: str = ""  # k8s PriorityClass reference
    priority_class_label: str = ""
    qos_label: str = ""
    quota_name: str = ""         # elastic quota label
    is_daemonset: bool = False
    phase: str = "Pending"

    @property
    def qos(self) -> QoSClass:
        return QoSClass.parse(self.qos_label)

    @property
    def priority_class(self) -> PriorityClass:
        return priority_class_of(self.priority, self.priority_class_label,
                                 self.priority_class_name)


@dataclasses.dataclass
class Node:
    meta: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    allocatable: ResourceList = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PodMetricInfo:
    namespace: str = ""
    name: str = ""
    priority_class: PriorityClass = PriorityClass.NONE
    usage: ResourceList = dataclasses.field(default_factory=dict)

    @property
    def namespaced_name(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclasses.dataclass
class NodeMetric:
    """Per-node usage report written by the node agent: the fields the
    descheduler and the node-resource controller read."""

    node_name: str = ""
    update_time: float = 0.0           # unix seconds
    node_usage: ResourceList = dataclasses.field(default_factory=dict)
    system_usage: ResourceList = dataclasses.field(default_factory=dict)
    pods_metric: List[PodMetricInfo] = dataclasses.field(default_factory=list)
    prod_reclaimable: ResourceList = dataclasses.field(default_factory=dict)

    def is_expired(self, expiration_seconds: float,
                   now: Optional[float] = None) -> bool:
        """isNodeMetricExpired (plugins/loadaware/helper.go)."""
        now = time.time() if now is None else now
        return (self.update_time <= 0
                or now - self.update_time >= expiration_seconds)
