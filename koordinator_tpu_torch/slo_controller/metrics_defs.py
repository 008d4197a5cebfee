"""slo-controller metric series (pkg/slo-controller/metrics/: common.go,
metrics.go, node_resource.go).

Own copy of `koordinator_tpu/slo_controller/metrics_defs.py`; the family
names come from the port's registry (`metrics/registry.py`).

The names are the reference's on purpose: the port serves the same
series. They register into the port's own process registry
(`koordinator_tpu_torch.metrics.global_registry`), never into the
reference's, so the two catalogs cannot collide in one registry; the
metric-registry analyzer's duplicate check (MN001) sees one repository
as one process and is disabled for this file alone (below).
"""

# koordlint: disable-file=MN001

from __future__ import annotations

from koordinator_tpu_torch.metrics import Registry, global_registry
from koordinator_tpu_torch.metrics.registry import (
    SLO_NODE_EXTENDED_RESOURCE_ALLOCATABLE,
    SLO_NODE_RESOURCE_RECONCILE_COUNT,
    SLO_NODE_RESOURCE_RUN_PLUGIN_STATUS,
    SLO_NODEMETRIC_RECONCILE_COUNT,
    SLO_NODEMETRIC_SPEC_PARSE_COUNT,
    SLO_NODESLO_RECONCILE_COUNT,
    SLO_NODESLO_SPEC_PARSE_COUNT,
)


class SloControllerMetrics:
    def __init__(self, registry: Registry = None):
        r = registry if registry is not None else global_registry()
        self.nodemetric_reconcile_count = r.counter(
            SLO_NODEMETRIC_RECONCILE_COUNT,
            "NodeMetric reconciliations by status",
            labels=("status",))
        self.nodemetric_spec_parse_count = r.counter(
            SLO_NODEMETRIC_SPEC_PARSE_COUNT,
            "NodeMetric collect-policy config parses by status",
            labels=("status",))
        self.nodeslo_reconcile_count = r.counter(
            SLO_NODESLO_RECONCILE_COUNT,
            "NodeSLO reconciliations by status", labels=("status",))
        self.nodeslo_spec_parse_count = r.counter(
            SLO_NODESLO_SPEC_PARSE_COUNT,
            "NodeSLO strategy config parses by status", labels=("status",))
        self.node_resource_reconcile_count = r.counter(
            SLO_NODE_RESOURCE_RECONCILE_COUNT,
            "Node batch/mid resource reconciliations by status",
            labels=("status",))
        self.node_resource_run_plugin_status = r.counter(
            SLO_NODE_RESOURCE_RUN_PLUGIN_STATUS,
            "Resource-calculate plugin runs by plugin and status",
            labels=("plugin", "status"))
        self.node_extended_resource_allocatable = r.gauge(
            SLO_NODE_EXTENDED_RESOURCE_ALLOCATABLE,
            "Extended (batch/mid) allocatable the controller computed",
            labels=("node", "resource", "unit"))
