"""Declared guarded-by tables for concurrent state: the port's copy of
`koordinator_tpu/utils/sync.py`'s `guarded_by`.

`@guarded_by(attr="guard", ...)` declares, per class, which lock guards
each mutable attribute, as a literal table that the repository's race
lint (`tools/lint`, race-guard) reads from the source. A guard is the
name of a lock attribute of the instance, "publish-once" (set before
threads start, never rebound), "confined" (one thread only),
"racy-monitor" (unsynchronised monitoring state) or
"external:Owner.lock". The decorator validates the table, records it
and returns the class untouched.
"""

from __future__ import annotations

import re
from typing import Dict

# dotted class name -> {attr: guard}, filled at import time
GUARDED_BY: Dict[str, Dict[str, str]] = {}

GUARD_VOCAB = ("publish-once", "confined", "racy-monitor")

_IDENT = re.compile(r"^[A-Za-z_]\w*$")
_EXTERNAL = re.compile(r"^external:[A-Za-z_]\w*(\.[A-Za-z_]\w*)+$")


def _validate(owner: str, table: Dict[str, str]) -> None:
    if not table:
        raise ValueError(f"guarded_by on {owner}: empty contract")
    for attr, guard in table.items():
        if not _IDENT.match(attr):
            raise ValueError(f"guarded_by on {owner}: field name {attr!r} "
                             "is not an identifier")
        if not isinstance(guard, str):
            raise ValueError(f"guarded_by on {owner}: guard for {attr!r} "
                             "must be a literal string")
        if guard in GUARD_VOCAB or _IDENT.match(guard) or \
                _EXTERNAL.match(guard):
            continue
        raise ValueError(f"guarded_by on {owner}: guard {guard!r} for "
                         f"{attr!r} is neither a lock attribute name, "
                         f"an external guard nor one of {GUARD_VOCAB}")


def guarded_by(**table: str):
    """Class decorator: validate and record the class's contract."""

    def deco(cls: type) -> type:
        key = f"{cls.__module__}.{cls.__name__}"
        _validate(key, table)
        if key in GUARDED_BY:
            raise ValueError(f"duplicate guarded_by contract {key}")
        GUARDED_BY[key] = dict(table)
        return cls

    return deco
