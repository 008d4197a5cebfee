"""Descheduling framework: plugin protocol, eviction limiting, cycle loop.

The port's copy of `koordinator_tpu/descheduler/framework.py`
(pkg/descheduler/{descheduler.go,framework/,profile/}): profiles of
Deschedule/Balance plugins run every descheduling interval; an
EvictionLimiter caps evictions per cycle / node / namespace; evictors
are pluggable. The eviction metrics (`RecordingEvictor`'s `stats`)
belong to the observability work still to port: the argument is kept
and must be None.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Protocol, Sequence

from koordinator_tpu_torch.api import types as api


class Evictor(Protocol):
    def evict(self, pod: api.Pod, reason: str) -> bool:
        """Request eviction; False = refused (limit/filters)."""


@dataclasses.dataclass
class Eviction:
    pod: api.Pod
    reason: str
    node_name: str


class EvictionLimiter:
    """Caps evictions per descheduling cycle, per node, and per namespace
    (descheduler.go evictionLimiter semantics). None = unlimited."""

    def __init__(self, max_per_cycle: Optional[int] = None,
                 max_per_node: Optional[int] = None,
                 max_per_namespace: Optional[int] = None):
        self.max_per_cycle = max_per_cycle
        self.max_per_node = max_per_node
        self.max_per_namespace = max_per_namespace
        self.reset()

    def reset(self) -> None:
        self._total = 0
        self._per_node: Dict[str, int] = {}
        self._per_ns: Dict[str, int] = {}

    def allow(self, pod: api.Pod) -> bool:
        if (self.max_per_cycle is not None
                and self._total >= self.max_per_cycle):
            return False
        node = pod.node_name
        ns = pod.meta.namespace
        if (self.max_per_node is not None
                and self._per_node.get(node, 0) >= self.max_per_node):
            return False
        if (self.max_per_namespace is not None
                and self._per_ns.get(ns, 0) >= self.max_per_namespace):
            return False
        return True

    def record(self, pod: api.Pod) -> None:
        self._total += 1
        node = pod.node_name
        self._per_node[node] = self._per_node.get(node, 0) + 1
        ns = pod.meta.namespace
        self._per_ns[ns] = self._per_ns.get(ns, 0) + 1


class RecordingEvictor:
    """Test/dry-run evictor honoring an EvictionLimiter."""

    def __init__(self, limiter: Optional[EvictionLimiter] = None,
                 stats=None, strategy: str = ""):
        if stats is not None:
            raise NotImplementedError(
                "RecordingEvictor: eviction metrics (stats) are not ported "
                "yet; pass stats=None")
        self.limiter = limiter or EvictionLimiter()
        self.evictions: List[Eviction] = []
        self.stats = stats
        self.strategy = strategy

    def evict(self, pod: api.Pod, reason: str) -> bool:
        if not self.limiter.allow(pod):
            return False
        self.limiter.record(pod)
        self.evictions.append(Eviction(pod, reason, pod.node_name))
        return True


class DeschedulePlugin(Protocol):
    name: str

    def deschedule(self, nodes: Sequence[api.Node]) -> None: ...


class BalancePlugin(Protocol):
    name: str

    def balance(self, nodes: Sequence[api.Node]) -> None: ...


class CycleRunner:
    """descheduler.go Run loop: every interval, run each profile's
    Deschedule plugins then Balance plugins.

    Per-cycle eviction caps live in the EvictionLimiters the EVICTORS
    hold; pass every limiter that should reset at cycle start in
    `limiters` (e.g. `[evictor.limiter]` for a RecordingEvictor)."""

    def __init__(self, deschedule_plugins: Sequence[DeschedulePlugin] = (),
                 balance_plugins: Sequence[BalancePlugin] = (),
                 limiters: Sequence[EvictionLimiter] = (),
                 descheduling_interval_seconds: float = 120.0):
        self.deschedule_plugins = list(deschedule_plugins)
        self.balance_plugins = list(balance_plugins)
        self.limiters = list(limiters)
        self.interval = descheduling_interval_seconds

    def run_once(self, nodes: Sequence[api.Node]) -> None:
        for limiter in self.limiters:
            limiter.reset()
        for plugin in self.deschedule_plugins:
            plugin.deschedule(nodes)
        for plugin in self.balance_plugins:
            plugin.balance(nodes)

    def run(self, get_nodes: Callable[[], Sequence[api.Node]],
            stop: Callable[[], bool],
            sleep: Callable[[float], None] = time.sleep) -> None:
        while not stop():
            self.run_once(get_nodes())
            sleep(self.interval)
