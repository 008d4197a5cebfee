"""The typed host objects the descheduler reads.

Own copy of the parts of `koordinator_tpu/api/types.py` that the port's
descheduler consumes (the port imports nothing of the JAX package):
`ObjectMeta`, `PodMetricInfo`, and the fields of `Pod`, `Node` and
`NodeMetric` (with `is_expired`; slo/v1alpha1 NodeMetric,
nodemetric_types.go:39-123) that the balance plan, the eviction
limiter and config 5's builder read.
Field names and defaults are the reference's, so that
`bridge.api_from_reference` can carry its objects across by attribute.
ResourceList is a plain dict keyed by ResourceKind in canonical device
units (cpu-like: millicores, memory-like: MiB).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from koordinator_tpu_torch.api.extension import PriorityClass, ResourceKind

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
    """A running pod as the descheduler sees it. `requests` aggregates
    the pod's containers."""

    meta: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    requests: ResourceList = dataclasses.field(default_factory=dict)
    priority: Optional[int] = None
    node_name: str = ""          # "" == pending
    qos_label: str = ""
    is_daemonset: bool = False


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
    descheduler reads."""

    node_name: str = ""
    update_time: float = 0.0           # unix seconds
    node_usage: ResourceList = dataclasses.field(default_factory=dict)
    pods_metric: List[PodMetricInfo] = dataclasses.field(default_factory=list)

    def is_expired(self, expiration_seconds: float,
                   now: Optional[float] = None) -> bool:
        """isNodeMetricExpired (plugins/loadaware/helper.go)."""
        now = time.time() if now is None else now
        return (self.update_time <= 0
                or now - self.update_time >= expiration_seconds)
