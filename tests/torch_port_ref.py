"""Helpers of the tests that hold the PyTorch port (koordinator_tpu_torch)
against the JAX package: a JAX struct is flattened to numpy and handed
to the port's bridge, as the port's own users would carry state over."""

from __future__ import annotations

import dataclasses

import numpy as np

from koordinator_tpu_torch.bridge import from_reference


def numpy_tree(x) -> dict:
    """{field: np.ndarray} of a JAX-package struct, nested structs as
    nested dicts, host-side switches (bool/int/str) as they are."""
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = numpy_tree(v)
        elif isinstance(v, (bool, int, str)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def to_port(struct_name: str, x):
    """The port's twin of JAX struct `x`, on the host."""
    return from_reference(struct_name, numpy_tree(x), device="cpu")


def assert_trees_equal(got: dict, want: dict, path: str = "") -> None:
    """Leaf-by-leaf equality (dtype, shape and every value; NaN-free)."""
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_trees_equal(g, w, f"{path}.{k}")
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, \
                (f"{path}.{k}", g.dtype, w.dtype, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=f"{path}.{k}")
        else:
            assert g == w, (f"{path}.{k}", g, w)
