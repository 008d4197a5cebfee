"""Field-name conventions of the JSON-config surfaces: own copy of
`koordinator_tpu/utils/naming.py`."""

from __future__ import annotations

import re

_SNAKE_RE = re.compile(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")


def camel_to_snake(key: str) -> str:
    """cpuEvictBEUsageThresholdPercent -> cpu_evict_be_usage_threshold_
    percent: acronym runs (BE, CPU) stay one segment — a per-character
    split would mangle them into b_e."""
    return _SNAKE_RE.sub("_", key).lower()
