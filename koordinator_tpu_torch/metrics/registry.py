"""The metric family names of the port's catalogs, one constant each.

Own copy of the slo-controller part of
`koordinator_tpu/metrics/registry.py` (pkg/slo-controller/metrics/):
the catalogs (`*/metrics_defs.py`) import these constants instead of
spelling names inline, so a renamed series cannot drift from its
dashboards. The names are the reference's: the port serves the same
series.
"""

from __future__ import annotations

# --- slo-controller (pkg/slo-controller/metrics/) ---
SLO_NODEMETRIC_RECONCILE_COUNT = "slo_controller_nodemetric_reconcile_count"
SLO_NODEMETRIC_SPEC_PARSE_COUNT = \
    "slo_controller_nodemetric_spec_parse_count"
SLO_NODESLO_RECONCILE_COUNT = "slo_controller_nodeslo_reconcile_count"
SLO_NODESLO_SPEC_PARSE_COUNT = "slo_controller_nodeslo_spec_parse_count"
SLO_NODE_RESOURCE_RECONCILE_COUNT = \
    "slo_controller_node_resource_reconcile_count"
SLO_NODE_RESOURCE_RUN_PLUGIN_STATUS = \
    "slo_controller_node_resource_run_plugin_status"
SLO_NODE_EXTENDED_RESOURCE_ALLOCATABLE = \
    "slo_controller_node_extended_resource_allocatable_internal"
