"""The fixed resource axis and the class enums of the device tensors.

Own copy of the parts of `koordinator_tpu/api/extension.py` that the
port reads (the port imports nothing of the JAX package): QoS classes
(apis/extension/qos.go), priority classes (apis/extension/priority.go),
the static resource axis `ResourceKind`, and the aux device kinds.
"""

from __future__ import annotations

import enum


class QoSClass(enum.IntEnum):
    """Koordinator QoS classes (apis/extension/qos.go:23-28)."""

    NONE = 0
    SYSTEM = 1
    LSE = 2
    LSR = 3
    LS = 4
    BE = 5


class PriorityClass(enum.IntEnum):
    """Koordinator priority classes (apis/extension/priority.go:29-35)."""

    NONE = 0
    FREE = 1
    BATCH = 2
    MID = 3
    PROD = 4


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
