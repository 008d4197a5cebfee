"""Colocation strategy config: the dynamic `slo-controller-config` ConfigMap
schema and its per-node-selector merge semantics.

Own copy of `koordinator_tpu/slo_controller/config.py`.

Capability parity with apis/configuration/slo_controller_config.go
(ColocationCfg / ColocationStrategy) + pkg/util/sloconfig defaults and the
per-nodeSelector strategy merge in nodeslo/resource_strategy.go: the cluster
config carries a cluster-wide strategy plus an ordered list of node-selector
overrides; the first matching override (merged over the cluster strategy)
wins for a node.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict, List, Optional

from koordinator_tpu_torch.api.extension import (
    ANNOTATION_NODE_COLOCATION_STRATEGY,
    LABEL_CPU_RECLAIM_RATIO,
    LABEL_MEMORY_RECLAIM_RATIO,
    selector_matches,
)
from koordinator_tpu_torch.utils.naming import camel_to_snake


class CalculatePolicy(enum.Enum):
    """Batch allocatable calculation policy (apis/configuration
    slo_controller_config.go CalculatePolicy)."""

    USAGE = "usage"
    REQUEST = "request"
    MAX_USAGE_REQUEST = "maxUsageRequest"


@dataclasses.dataclass
class ColocationStrategy:
    """Per-(cluster|node-group) overcommit strategy.

    Field parity with configuration.ColocationStrategy; defaults from
    pkg/util/sloconfig/colocation_config.go (DefaultColocationStrategy).
    """

    enable: bool = False
    metric_aggregate_duration_seconds: float = 300.0
    metric_report_interval_seconds: float = 60.0
    # percent of node capacity reclaimable for batch tier
    cpu_reclaim_threshold_percent: float = 60.0
    memory_reclaim_threshold_percent: float = 65.0
    # mid-tier caps as percent of node allocatable
    mid_cpu_threshold_percent: float = 10.0
    mid_memory_threshold_percent: float = 10.0
    # skip node update when relative diff below this
    resource_diff_threshold: float = 0.1
    # reset batch resources when NodeMetric is stale for this long
    degrade_time_minutes: float = 15.0
    update_time_threshold_seconds: float = 300.0
    cpu_calculate_policy: CalculatePolicy = CalculatePolicy.USAGE
    memory_calculate_policy: CalculatePolicy = CalculatePolicy.USAGE
    # node reservation percent applied to capacity before reclaim
    # (getNodeReservation: reserveRatio = (100-thresholdPercent)/100)

    def merged(self, override: "ColocationStrategyOverride") -> "ColocationStrategy":
        out = dataclasses.replace(self)
        for k, v in override.fields.items():
            if not hasattr(out, k):
                raise KeyError(f"unknown strategy field {k!r}")
            setattr(out, k, v)
        return out


@dataclasses.dataclass
class ColocationStrategyOverride:
    """NodeColocationCfg: a node-label selector plus partial strategy."""

    node_selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    fields: Dict[str, object] = dataclasses.field(default_factory=dict)

    def matches(self, node_labels: Dict[str, str]) -> bool:
        return selector_matches(self.node_selector, node_labels)


@dataclasses.dataclass
class ColocationConfig:
    """slo-controller-config `colocation-config` entry (ColocationCfg)."""

    cluster_strategy: ColocationStrategy = dataclasses.field(
        default_factory=ColocationStrategy)
    node_overrides: List[ColocationStrategyOverride] = dataclasses.field(
        default_factory=list)

    def strategy_for(self, node_labels: Dict[str, str],
                     node_annotations: Optional[Dict[str, str]] = None
                     ) -> ColocationStrategy:
        """Per-node strategy resolution (sloconfig/colocation_config.go
        GetNodeColocationStrategy:102-155), precedence low to high:
        cluster strategy -> first matching node-selector override ->
        node annotation JSON partial -> reclaim-ratio labels. Illegal
        node metadata is ignored, never fatal (":142-154")."""
        out = self.cluster_strategy
        for ov in self.node_overrides:
            if ov.matches(node_labels):
                out = self.cluster_strategy.merged(ov)
                break
        anns = node_annotations or {}
        raw = anns.get(ANNOTATION_NODE_COLOCATION_STRATEGY)
        if raw:
            try:
                data = json.loads(raw)
            except ValueError:
                data = None  # illegal annotation ignored, never fatal
            if isinstance(data, dict):
                fields = {}
                for k, v in data.items():
                    snake = camel_to_snake(k)
                    coerced = self._coerce(snake, v)
                    if coerced is not None:
                        fields[snake] = coerced
                out = out.merged(ColocationStrategyOverride(fields=fields))
        out = dataclasses.replace(out)
        for label, attr in ((LABEL_CPU_RECLAIM_RATIO,
                             "cpu_reclaim_threshold_percent"),
                            (LABEL_MEMORY_RECLAIM_RATIO,
                             "memory_reclaim_threshold_percent")):
            raw = node_labels.get(label)
            if raw is None:
                continue
            try:
                ratio = float(raw)
            except ValueError:
                continue
            # the same [0,100]-percent invariant the ConfigMap webhook
            # enforces; an oversized ratio would overcommit the node
            if 0.0 <= ratio <= 1.0:
                setattr(out, attr, ratio * 100.0)
        return out

    @staticmethod
    def _coerce(field: str, value: object) -> Optional[object]:
        """Annotation values must land with the field's DECLARED type —
        the ConfigMap path coerces through the webhook validator; untyped
        node metadata must not sneak a str into arithmetic or a bogus
        policy into the kernel lowering. Dispatching on the declared type
        (not the current value's runtime type, which a prior int-valued
        override could have polluted) keeps valid values accepted.
        None = drop the field."""
        declared = _STRATEGY_FIELD_TYPES.get(field)
        if declared is None:
            return None  # unknown field
        if declared == "CalculatePolicy":
            try:
                return CalculatePolicy(value)
            except ValueError:
                return None
        if declared == "bool":
            return value if isinstance(value, bool) else None
        if declared == "float":
            return (float(value)
                    if isinstance(value, (int, float))
                    and not isinstance(value, bool) else None)
        # unhandled declared kinds reject rather than admit untyped data —
        # a future field must get an explicit branch here to be overridable
        return None


# declared field types (annotation strings under `from __future__ import
# annotations`) — the authority _coerce dispatches on
_STRATEGY_FIELD_TYPES: Dict[str, str] = {
    f.name: str(f.type) for f in dataclasses.fields(ColocationStrategy)}


def validate_colocation_config(cfg: ColocationConfig) -> List[str]:
    """ConfigMap-webhook-style validation (pkg/webhook/cm +
    sloconfig/colocation_validator.go). Returns a list of problems."""
    problems = []

    def check(s: ColocationStrategy, where: str):
        if not 0 <= s.cpu_reclaim_threshold_percent <= 100:
            problems.append(f"{where}: cpuReclaimThresholdPercent out of [0,100]")
        if not 0 <= s.memory_reclaim_threshold_percent <= 100:
            problems.append(f"{where}: memoryReclaimThresholdPercent out of [0,100]")
        if not 0 <= s.mid_cpu_threshold_percent <= 100:
            problems.append(f"{where}: midCPUThresholdPercent out of [0,100]")
        if not 0 <= s.mid_memory_threshold_percent <= 100:
            problems.append(f"{where}: midMemoryThresholdPercent out of [0,100]")
        if not 0 <= s.resource_diff_threshold <= 1:
            problems.append(f"{where}: resourceDiffThreshold out of [0,1]")
        if s.degrade_time_minutes <= 0:
            problems.append(f"{where}: degradeTimeMinutes must be positive")
        if s.metric_report_interval_seconds <= 0:
            problems.append(f"{where}: metricReportIntervalSeconds must be positive")

    check(cfg.cluster_strategy, "cluster")
    for i, ov in enumerate(cfg.node_overrides):
        if not ov.node_selector:
            problems.append(f"nodeOverride[{i}]: empty node selector")
        try:
            merged = cfg.cluster_strategy.merged(ov)
        except KeyError as e:
            problems.append(f"nodeOverride[{i}]: {e}")
            continue
        check(merged, f"nodeOverride[{i}]")
    return problems
