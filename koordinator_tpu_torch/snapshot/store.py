"""Versioned snapshot store: the device-resident snapshot, its deltas and
its checkpoints.

Counterpart of `koordinator_tpu/snapshot/store.py` (without the mesh
`sharding`, which is multi-GPU work). `publish` moves a host-built
snapshot to the store's device and opens a new delta epoch; between
publishes the store stays fresh with O(K) device-side deltas: `ingest`
replaces metric or topology rows (refusing a versioned delta at or
below the last applied version, with a typed reason), `forget` returns
the charges of failed binds, `update` applies any functional update.
`checkpoint` / `restore` persist the snapshot with its version and
delta watermark, atomically (tmp + os.replace) and checksummed, in the
reference's exact file format: the magic, a `<IQQQ` prefix (magic,
version, watermark, blob length), the crc32 of prefix and blob, then an
npz keyed by the dotted leaf names of STRUCT_SPECS, so that either
package restores the other's checkpoint.

Locking follows the reference (the `guarded_by` table): `_lock` guards
the snapshot, the versions and the rejection state; `_ck_lock`
serialises whole checkpoint writes (capture through os.replace) and
owns `checkpoints_written`.
"""

from __future__ import annotations

import io
import os
import struct
import threading
import zlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.snapshot import schema
from koordinator_tpu_torch.snapshot.schema import STRUCT_SPECS, ClusterSnapshot
from koordinator_tpu_torch.utils.sync import guarded_by

# checkpoint framing: magic, store version, applied delta watermark, npz
# byte length, then crc32 over the prefix and the npz bytes
_CK_MAGIC = 0x4B434B31  # "KCK1"
_CK_PREFIX = struct.Struct("<IQQQ")
_CK_CRC = struct.Struct("<I")
_CK_HEADER_SIZE = _CK_PREFIX.size + _CK_CRC.size


def _struct_leaves(name: str, obj,
                   prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    """(dotted key, host array) per registered leaf, in STRUCT_SPECS
    order: the serialisation cannot drop a field the table lists."""
    for fname, spec in STRUCT_SPECS[name].items():
        if spec in STRUCT_SPECS:
            yield from _struct_leaves(spec, getattr(obj, fname),
                                      prefix + fname + ".")
        else:
            yield prefix + fname, getattr(obj, fname).detach().cpu().numpy()


def _build_struct(name: str, arrays: Dict[str, np.ndarray],
                  prefix: str = ""):
    """The host struct of `_struct_leaves`' arrays; KeyError on a
    missing leaf, ValueError on a dtype other than the spec's."""
    fields = {}
    for fname, spec in STRUCT_SPECS[name].items():
        if spec in STRUCT_SPECS:
            fields[fname] = _build_struct(spec, arrays, prefix + fname + ".")
            continue
        got = torch.from_numpy(np.array(arrays[prefix + fname]))
        if got.dtype != schema.spec_dtype(spec):
            raise ValueError(f"{prefix}{fname}: {got.dtype} for {spec!r}")
        fields[fname] = got
    return getattr(schema, name)(**fields)


@guarded_by(
    _current="_lock",
    _version="_lock",
    _applied_delta_version="_lock",
    _last_delta_rejection="_lock",
    delta_rejections="_lock",
    _last_checkpoint_version="_lock",
    checkpoints_written="_ck_lock",
    device="publish-once",
    checkpoint_path="publish-once",
    checkpoint_every="publish-once",
    crash_hook="publish-once",
)
class SnapshotStore:
    """Holds the current device-resident ClusterSnapshot.

    - `publish(snapshot)` moves a host snapshot to the store's device and
      makes it the next version;
    - `current()` returns the freshest version;
    - `update(fn)`, `ingest(delta)`, `forget(pods, result, mask)` apply
      functional device-side updates as the next version.
    """

    def __init__(self, device="cuda", checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 1,
                 crash_hook: Optional[Callable[[str], None]] = None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._current: Optional[ClusterSnapshot] = None
        self._version = 0
        # the delta replay guard: the highest source_version applied
        # since the last publish (a publish opens a new delta epoch)
        self._applied_delta_version = 0
        self._last_delta_rejection = None
        self.delta_rejections = 0
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self.crash_hook = crash_hook  # the kill-injection seam
        self._last_checkpoint_version = 0
        self.checkpoints_written = 0
        self._ck_lock = threading.Lock()

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def applied_delta_version(self) -> int:
        with self._lock:
            return self._applied_delta_version

    @property
    def last_checkpoint_version(self) -> int:
        """Store version of the last durable checkpoint (0 = none)."""
        with self._lock:
            return self._last_checkpoint_version

    def take_delta_rejection(self):
        """Pop the last ingest's DeltaRejectReason (None if it
        applied)."""
        with self._lock:
            reason = self._last_delta_rejection
            self._last_delta_rejection = None
            return reason

    def publish(self, snapshot: ClusterSnapshot) -> ClusterSnapshot:
        """Move a snapshot to the store's device (asynchronous where the
        copy allows) and make it current; opens a new delta epoch."""
        on_device = snapshot.to(self.device)
        with self._lock:
            self._version += 1
            self._current = on_device
            self._applied_delta_version = 0
            self._last_delta_rejection = None
        return on_device

    def current(self) -> ClusterSnapshot:
        with self._lock:
            if self._current is None:
                raise RuntimeError("no snapshot published yet")
            return self._current

    def update(self, fn: Callable[[ClusterSnapshot], ClusterSnapshot]
               ) -> ClusterSnapshot:
        """Apply a functional device-side update (e.g. the post-commit
        snapshot) and make the result the next version."""
        with self._lock:
            if self._current is None:
                raise RuntimeError("no snapshot published yet")
            self._current = fn(self._current)
            self._version += 1
            return self._current

    def ingest(self, delta) -> ClusterSnapshot:
        """Apply a NodeMetricDelta or NodeTopologyDelta on the device.
        A versioned delta at or below the last applied version no-ops
        (snapshot and store version untouched) and leaves its typed
        reason for `take_delta_rejection`; an unversioned delta always
        applies."""
        from koordinator_tpu_torch.snapshot.delta import (
            DeltaRejectReason,
            NodeTopologyDelta,
            apply_metric_delta,
            apply_topology_delta,
            delta_version,
        )

        ver = delta_version(delta)
        apply = (apply_topology_delta if isinstance(delta, NodeTopologyDelta)
                 else apply_metric_delta)
        with self._lock:
            if self._current is None:
                raise RuntimeError("no snapshot published yet")
            if ver is not None:
                if ver <= self._applied_delta_version:
                    self._last_delta_rejection = (
                        DeltaRejectReason.DUPLICATE_VERSION
                        if ver == self._applied_delta_version
                        else DeltaRejectReason.STALE_VERSION)
                    self.delta_rejections += 1
                    return self._current
                self._applied_delta_version = ver
            self._last_delta_rejection = None
            self._current = apply(self._current, delta)
            self._version += 1
            return self._current

    # --- restart recovery: periodic checkpoints --------------------------

    def maybe_checkpoint(self) -> bool:
        """Checkpoint when a path is set and `checkpoint_every` versions
        have landed since the last one; call it outside commit locks."""
        if self.checkpoint_path is None:
            return False
        with self._lock:
            due = (self._current is not None
                   and self._version - self._last_checkpoint_version
                   >= self.checkpoint_every)
        if not due:
            return False
        self.checkpoint()
        return True

    def checkpoint(self, path: Optional[str] = None) -> str:
        """Write the current snapshot, version and delta watermark,
        checksummed and atomic (tmp file + os.replace): a crash mid-write
        leaves the previous checkpoint whole."""
        path = path or self.checkpoint_path
        if path is None:
            raise ValueError("no checkpoint path configured")
        with self._ck_lock:
            with self._lock:
                snap = self._current
                version = self._version
                delta_v = self._applied_delta_version
            if snap is None:
                raise RuntimeError("no snapshot published yet")
            # the device-to-host copy and the encode run outside _lock
            buf = io.BytesIO()
            np.savez(buf, **dict(_struct_leaves("ClusterSnapshot", snap)))
            blob = buf.getvalue()
            prefix = _CK_PREFIX.pack(_CK_MAGIC, version, delta_v, len(blob))
            crc = zlib.crc32(blob, zlib.crc32(prefix)) & 0xFFFFFFFF
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(prefix + _CK_CRC.pack(crc))
                f.write(blob[:len(blob) // 2])
                f.flush()
                if self.crash_hook is not None:
                    self.crash_hook("mid_checkpoint")  # a kill here = torn
                f.write(blob[len(blob) // 2:])
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            with self._lock:
                self._last_checkpoint_version = version
            self.checkpoints_written += 1
        return path

    def restore(self, path: Optional[str] = None) -> bool:
        """Rehydrate the snapshot, version and delta watermark from the
        last checkpoint. False, with no state touched, when there is no
        readable checkpoint: missing, torn, corrupt, or of another field
        set."""
        path = path or self.checkpoint_path
        if path is None or not os.path.exists(path):
            return False
        try:
            with open(path, "rb") as f:
                header = f.read(_CK_HEADER_SIZE)
                prefix = header[:_CK_PREFIX.size]
                magic, version, delta_v, blob_len = _CK_PREFIX.unpack(prefix)
                (crc,) = _CK_CRC.unpack(header[_CK_PREFIX.size:])
                if magic != _CK_MAGIC:
                    return False
                blob = f.read(blob_len)
            if len(blob) != blob_len or \
                    zlib.crc32(blob, zlib.crc32(prefix)) & 0xFFFFFFFF != crc:
                return False
            arrays = dict(np.load(io.BytesIO(blob)))
            snap = _build_struct("ClusterSnapshot", arrays)
        except (OSError, ValueError, KeyError, TypeError, struct.error):
            return False
        on_device = snap.to(self.device)
        with self._lock:
            self._current = on_device
            self._version = int(version)
            self._applied_delta_version = int(delta_v)
            self._last_checkpoint_version = int(version)
            self._last_delta_rejection = None
        return True

    def forget(self, pods, result, mask) -> ClusterSnapshot:
        """Un-assume failed binds: the masked pods' charges go back to
        the snapshot on the device (`delta.forget_pods`)."""
        from koordinator_tpu_torch.snapshot.delta import forget_pods

        return self.update(lambda s: forget_pods(s, pods, result, mask))
