"""The fixed resource axis and the class enums of the device tensors.

Own copy of the parts of `koordinator_tpu/api/extension.py` that the
port reads (the port imports nothing of the JAX package): QoS classes
(apis/extension/qos.go), priority classes (apis/extension/priority.go)
with their parsers and value bands, the static resource axis
`ResourceKind`, the aux device kinds, the label selector and the node
metadata keys of the colocation strategy.
"""

from __future__ import annotations

import enum
from typing import Mapping, Optional


class QoSClass(enum.IntEnum):
    """Koordinator QoS classes (apis/extension/qos.go:23-28)."""

    NONE = 0
    SYSTEM = 1
    LSE = 2
    LSR = 3
    LS = 4
    BE = 5

    @classmethod
    def parse(cls, s: str) -> "QoSClass":
        try:
            return cls[s.upper()] if s else cls.NONE
        except KeyError:
            return cls.NONE


class PriorityClass(enum.IntEnum):
    """Koordinator priority classes (apis/extension/priority.go:29-35)."""

    NONE = 0
    FREE = 1
    BATCH = 2
    MID = 3
    PROD = 4

    @classmethod
    def parse(cls, s: str) -> "PriorityClass":
        key = s.replace("koord-", "").upper() if s else ""
        try:
            return cls[key] if key else cls.NONE
        except KeyError:
            return cls.NONE


# Priority value bands (apis/extension/priority.go:38-48): class -> (min, max).
PRIORITY_BANDS: Mapping[PriorityClass, tuple] = {
    PriorityClass.PROD: (9000, 9999),
    PriorityClass.MID: (7000, 7999),
    PriorityClass.BATCH: (5000, 5999),
    PriorityClass.FREE: (3000, 3999),
}


def priority_class_of(priority: Optional[int], label: str = "",
                      priority_class_name: str = "") -> PriorityClass:
    """A pod's PriorityClass (apis/extension/priority.go:73-103): the
    `koordinator.sh/priority-class` label first, then a koord-*
    PriorityClassName, then the band of the numeric priority."""
    if label:
        parsed = PriorityClass.parse(label)
        if parsed is not PriorityClass.NONE:
            return parsed
    if priority_class_name and priority_class_name.startswith("koord-"):
        parsed = PriorityClass.parse(priority_class_name)
        if parsed is not PriorityClass.NONE:
            return parsed
    if priority is None:
        return PriorityClass.NONE
    for cls, (lo, hi) in PRIORITY_BANDS.items():
        if lo <= priority <= hi:
            return cls
    return PriorityClass.NONE


def selector_matches(selector: Mapping[str, str],
                     labels: Mapping[str, str]) -> bool:
    """Exact-match label selector; an empty selector matches everything
    (matchLabels-only util.GetFastLabelSelector)."""
    return all(labels.get(k) == v for k, v in selector.items())


class ResourceKind(enum.IntEnum):
    """The static resource axis R of every tensor: cpu/memory, the
    batch-/mid-tier overcommit resources and the device resources.
    CPU-like dims in millicores, memory-like dims in MiB."""

    CPU = 0
    MEMORY = 1
    BATCH_CPU = 2
    BATCH_MEMORY = 3
    MID_CPU = 4
    MID_MEMORY = 5
    GPU_CORE = 6
    GPU_MEMORY = 7
    EPHEMERAL_STORAGE = 8
    RDMA = 9
    FPGA = 10


NUM_RESOURCES = len(ResourceKind)

# aux device pools (DeviceState.aux_free axis 1), in pool order, and the
# ResourceKind column that carries each pool's request
AUX_RDMA = 0
AUX_FPGA = 1
NUM_AUX_TYPES = 2
AUX_KINDS = (int(ResourceKind.RDMA), int(ResourceKind.FPGA))

# topology-manager policy codes of a node (apis/extension/numa_aware.go
# :138-145; NodeState.numa_policy)
NUMA_POLICY_NONE = 0
NUMA_POLICY_BEST_EFFORT = 1
NUMA_POLICY_RESTRICTED = 2
NUMA_POLICY_SINGLE_NUMA_NODE = 3

# node metadata of the colocation strategy (sloconfig/colocation_config.go)
NODE_DOMAIN_PREFIX = "node.koordinator.sh"
ANNOTATION_NODE_COLOCATION_STRATEGY = (NODE_DOMAIN_PREFIX
                                       + "/colocation-strategy")
LABEL_CPU_RECLAIM_RATIO = NODE_DOMAIN_PREFIX + "/cpu-reclaim-ratio"
LABEL_MEMORY_RECLAIM_RATIO = NODE_DOMAIN_PREFIX + "/memory-reclaim-ratio"
