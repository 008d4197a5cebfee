"""Carry state between the reference and the port as numpy arrays.

`from_reference(struct_name, {field: np.ndarray})` builds a port struct
from the arrays of the JAX package's struct of the same name (nested
structs as nested mappings), and `to_numpy(struct)` gives them back.
The two packages never meet in one import: a caller that holds both
flattens the reference's struct to numpy and hands it over.
`api_from_reference(obj)` carries the reference's typed host objects
(`Node`, `Pod`, `NodeMetric`, `PodMetricInfo` and what they hold) into
the port's `api.types` by their attributes, so that both packages'
descheduler plans the same cluster. Leaf dtypes
must match `schema.STRUCT_SPECS` exactly; a mismatch raises instead of
casting, so a silently widened column cannot slip through.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.api import types as api
from koordinator_tpu_torch.api.extension import PriorityClass, ResourceKind
from koordinator_tpu_torch.snapshot import schema


def _struct_class(name: str) -> type:
    if name == "ScheduleResult":
        from koordinator_tpu_torch.scheduler.core import ScheduleResult
        return ScheduleResult
    cls = getattr(schema, name, None)
    if name not in schema.STRUCT_SPECS or cls is None:
        raise KeyError(f"unknown struct {name!r}")
    return cls


def _leaf(name: str, field: str, spec: str, value, device) -> torch.Tensor:
    want = schema.spec_dtype(spec)
    arr = np.array(value, copy=True)
    got = torch.from_numpy(arr)
    if got.dtype != want:
        raise TypeError(f"{name}.{field}: expected {want} for spec {spec!r}, "
                        f"got numpy {arr.dtype}")
    ndim = spec.count(",") + 1 if "[]" not in spec else 0
    if got.dim() != ndim:
        raise ValueError(f"{name}.{field}: spec {spec!r} has {ndim} dims, "
                         f"array has shape {tuple(arr.shape)}")
    return got.to(device)


def from_reference(struct_name: str, fields: Mapping[str, Any],
                   device="cuda"):
    """A port struct from the reference's arrays. `fields` maps every
    field of `schema.STRUCT_SPECS[struct_name]` to a numpy array (or a
    nested mapping for a nested struct); host-side switches of the
    struct (PodBatch.has_taints, ...) may ride along as plain values."""
    dev = resolve_device(device)
    specs = schema.STRUCT_SPECS[struct_name]
    cls = _struct_class(struct_name)
    missing = set(specs) - set(fields)
    if missing:
        raise KeyError(f"{struct_name}: missing fields {sorted(missing)}")
    kw: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name in specs:
            spec = specs[f.name]
            if spec in schema.STRUCT_SPECS:
                kw[f.name] = from_reference(spec, fields[f.name], dev)
            else:
                kw[f.name] = _leaf(struct_name, f.name, spec,
                                   fields[f.name], dev)
        elif f.name in fields:
            kw[f.name] = fields[f.name]
    return cls(**kw)


def to_numpy(struct) -> Dict[str, Any]:
    """{field: np.ndarray} of a port struct, nested structs as nested
    dicts, host-side switches as plain values."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(struct):
        v = getattr(struct, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        elif dataclasses.is_dataclass(v):
            out[f.name] = to_numpy(v)
        else:
            out[f.name] = v
    return out


_API_CLASSES = {cls.__name__: cls for cls in (
    api.ObjectMeta, api.Pod, api.Node, api.PodMetricInfo, api.NodeMetric)}
_RESOURCE_LISTS = ("requests", "allocatable", "usage", "node_usage")


def api_from_reference(obj):
    """The port's counterpart of a reference typed object, found by the
    object's class name and filled by attribute: the port class's
    fields that the object has (resource lists re-keyed to the port's
    ResourceKind, priority classes to its PriorityClass, nested objects
    carried in turn). Lists, tuples and dicts are carried element by
    element; anything else comes back as it is."""
    if isinstance(obj, dict):
        return {k: api_from_reference(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(api_from_reference(v) for v in obj)
    cls = _API_CLASSES.get(type(obj).__name__)
    if cls is None:
        return obj
    kw: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if not hasattr(obj, f.name):
            continue
        v = getattr(obj, f.name)
        if f.name in _RESOURCE_LISTS:
            v = {ResourceKind(int(k)): float(x) for k, x in v.items()}
        elif f.name == "priority_class":
            v = PriorityClass(int(v))
        elif f.name in ("labels", "annotations"):
            v = dict(v)
        else:
            v = api_from_reference(v)
        kw[f.name] = v
    return cls(**kw)
