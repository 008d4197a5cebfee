"""A small Prometheus-style registry: counters and gauges with labels,
and their text exposition.

Own copy of the parts of `koordinator_tpu/metrics/__init__.py` that the
port's catalogs use (the reference's per-component registries,
pkg/slo-controller/metrics/). The process-wide registry of the port is
`global_registry()`; a component may take a private `Registry`.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from koordinator_tpu_torch.utils.sync import guarded_by

__all__ = ["Counter", "Gauge", "Registry", "global_registry"]


def _validate_labels(names: Sequence[str],
                     values: Sequence[str]) -> Tuple[str, ...]:
    if len(names) != len(values):
        raise ValueError(f"expected labels {list(names)}, got {list(values)}")
    return tuple(str(v) for v in values)


@guarded_by(
    _children="_lock",
    name="publish-once",
    help="publish-once",
    label_names="publish-once",
)
class _Metric:
    """Base: a named family of label-keyed children."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str = "",
                 labels: Sequence[str] = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(labels)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], float] = {}

    def labels(self, *values: str) -> "_Bound":
        return _Bound(self, _validate_labels(self.label_names, values))

    def _set(self, key: Tuple[str, ...], value: float) -> None:
        with self._lock:
            self._children[key] = value

    def _add(self, key: Tuple[str, ...], delta: float) -> None:
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + delta

    def value(self, *values: str) -> float:
        key = _validate_labels(self.label_names, values)
        with self._lock:
            return self._children.get(key, 0.0)

    def samples(self) -> List[Tuple[str, Tuple[Tuple[str, str], ...], float]]:
        with self._lock:
            return [(self.name, tuple(zip(self.label_names, key)), v)
                    for key, v in sorted(self._children.items())]

    def clear(self) -> None:
        with self._lock:
            self._children.clear()


class _Bound:
    """A metric bound to one label vector."""

    def __init__(self, metric: "_Metric", key: Tuple[str, ...]):
        self._m = metric
        self._key = key

    def inc(self, delta: float = 1.0) -> None:
        if delta < 0:
            raise ValueError("counters only go up")
        self._m._add(self._key, delta)

    def add(self, delta: float) -> None:
        self._m._add(self._key, delta)

    def set(self, value: float) -> None:
        self._m._set(self._key, value)

    def get(self) -> float:
        with self._m._lock:
            return self._m._children.get(self._key, 0.0)


class Counter(_Metric):
    kind = "counter"

    def inc(self, delta: float = 1.0) -> None:
        if self.label_names:
            raise ValueError(f"{self.name} needs labels()")
        if delta < 0:
            raise ValueError("counters only go up")
        self._add((), delta)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float) -> None:
        if self.label_names:
            raise ValueError(f"{self.name} needs labels()")
        self._set((), value)

    def add(self, delta: float) -> None:
        if self.label_names:
            raise ValueError(f"{self.name} needs labels()")
        self._add((), delta)


@guarded_by(_metrics="_lock", prefix="publish-once")
class Registry:
    """A named collection of metric families with text exposition."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric) or \
                        existing.label_names != metric.label_names:
                    raise ValueError(
                        f"metric {metric.name} re-registered with a "
                        f"different shape")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help_text: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter(self._full(name), help_text, labels))  # type: ignore[return-value]

    def gauge(self, name: str, help_text: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(self._full(name), help_text, labels))  # type: ignore[return-value]

    def _full(self, name: str) -> str:
        return f"{self.prefix}_{name}" if self.prefix else name

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(self._full(name))

    def families(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def expose(self) -> str:
        """Prometheus text format (the /metrics payload)."""
        lines: List[str] = []
        for m in self.families():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for name, label_pairs, value in m.samples():
                if label_pairs:
                    body = ",".join(f'{k}="{_escape(v)}"'
                                    for k, v in label_pairs)
                    lines.append(f"{name}{{{body}}} {_fmt(value)}")
                else:
                    lines.append(f"{name} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every family (test isolation)."""
        for m in self.families():
            m.clear()


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_GLOBAL = Registry()


def global_registry() -> Registry:
    """The port's process-wide registry, which every catalog registers
    into unless given a private one."""
    return _GLOBAL
