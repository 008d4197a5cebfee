"""K8 topology_prefix_gate: the in-step same-domain prefix gates of pod
topology spread, inter-pod anti-affinity and inter-pod affinity, in one
launch a step.

Kernel: `csrc/topology_prefix.cu`. Replaces the in-step blocks of
koordinator_tpu/scheduler/core.py schedule_batch (:776-884, with
singleton domain classes: one group column at a time). There each
family builds a [P, P] same-domain mask a class and multiplies it into
the (pod x group) charges; here each group column counts, for every
gated pod, the earlier-ranked charging pods of its domain.

A family is one of the tables `PrefixFamily` describes. For each group
g of a family and every trying pod p with a domain (dom_x[g, choice[p]]
>= 0):

  occ(p, g) = base(g, p) + #{q trying, charging g, same segment as p,
                             rank[q] < rank[p]}

and a gated pod fails the step when occ breaks the family's rule:

| kind | charges | gated | segment | base | fails when |
| --- | --- | --- | --- | --- | --- |
| CAP (spread) | `charge` bits | `gate` bits | the domain | counts[g, dom] | fl(occ + 1) > lim[g] |
| OCCUPY (anti a/b) | `charge` bits | `gate` bits | the domain | counts[g, dom] | occ >= 0.5 |
| OPENER (affinity) | openers | openers | the group | sum of counts[g] | occ >= 0.5 |

An opener of an affinity group is a trying pod that carries g (`gate`
bit) and chose a domain of g that holds no member yet (counts[g, dom] <
0.5). For CAP, lim[g] = fl(fl(max_skew[g] + min_c[g]) + EPS) with the
round-start minimum (a soft group's skew is +inf, so it never fails).
The result is True where no group of any family fails the pod (pods
that do not try pass). The charges are 0/1 and the counts whole
numbers below 2^24, so every sum is exact in any order.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import TOOLCHAIN, check

MAX_GROUPS = 32     # groups a family: one bit a group in a pod's word
MAX_FAMILIES = 4
CAP, OCCUPY, OPENER = 0, 1, 2

# per (device, stream): the launch's merge tallies, int64, zero between
# launches (the block that completes a tally zeroes it)
_TALLIES: Dict[Tuple[torch.device, int], torch.Tensor] = {}
# ctypes array types by length (a new type a call costs host time)
_PTRS: Dict[int, type] = {}
_DIMS: Dict[int, type] = {}


@dataclasses.dataclass
class PrefixFamily:
    """One family's group columns: `dom_x` i32[G, X] each group's domain
    of every extended column (-1 = no domain), `counts` f32[G, D] the
    carried counts the base reads, `charge` and `gate` i32[P] each pod's
    bit words over the G groups (bit g: charges / is gated by group g;
    OPENER reads only `gate`, its carried groups), `lim` f32[G] (CAP
    only) and `kind` (CAP, OCCUPY or OPENER)."""
    dom_x: torch.Tensor
    counts: torch.Tensor
    charge: torch.Tensor
    gate: torch.Tensor
    kind: int
    lim: Optional[torch.Tensor] = None


def _bit(words: torch.Tensor, g: int) -> torch.Tensor:
    return ((words >> g) & 1) != 0


def topology_prefix_gate_plain(choice: torch.Tensor, trying: torch.Tensor,
                               rank: torch.Tensor,
                               families: Sequence[PrefixFamily]
                               ) -> torch.Tensor:
    """bool[P]: the gates of the module docstring, one group at a time,
    as the reference's per-class loops run them with singleton classes
    (the same-domain mask and the earlier mask as [P, P] matrices)."""
    p = choice.shape[0]
    ok = torch.ones((p,), dtype=torch.bool, device=choice.device)
    earlier = rank[None, :] < rank[:, None]
    for fam in families:
        x = fam.dom_x.shape[1]
        c = choice.clamp(0, x - 1).long()
        for g in range(fam.dom_x.shape[0]):
            dom = fam.dom_x[g, c]
            has = dom >= 0
            at = fam.counts[g, dom.clamp_min(0).long()]
            if fam.kind == OPENER:
                boot = trying & _bit(fam.gate, g) & has & (at < 0.5)
                before = earlier.to(torch.float32) @ boot.to(torch.float32)
                ok &= ~boot | (fam.counts[g].sum() + before < 0.5)
                continue
            same = (dom[:, None] == dom[None, :]) & earlier
            contrib = trying & _bit(fam.charge, g) & has
            gated = trying & _bit(fam.gate, g) & has
            occ = at + same.to(torch.float32) @ contrib.to(torch.float32)
            fits = (occ + 1.0 <= fam.lim[g]) if fam.kind == CAP else occ < 0.5
            ok &= ~gated | fits
    return ok


def _array(types: Dict[int, type], ctype, values):
    """A ctypes array of `values`, its type made once a length."""
    n = len(values)
    if n not in types:
        types[n] = ctype * n
    return types[n](*values)


@functools.lru_cache(maxsize=None)
def _tally_count(p: int) -> int:
    fn = TOOLCHAIN.function("topology_prefix", "koord_topology_prefix_tallies",
                            [ctypes.c_int])
    fn.restype = ctypes.c_longlong
    return fn(p)


def _tallies(dev: torch.device, stream: int, p: int) -> torch.Tensor:
    """The (device, stream)'s merge tallies, grown (zeroed) when a launch
    of p pods needs more than it holds."""
    need = _tally_count(p)
    t = _TALLIES.get((dev, stream))
    if t is None or t.shape[0] < need:
        t = torch.zeros((max(need, 512),), dtype=torch.int64, device=dev)
        _TALLIES[(dev, stream)] = t
    return t


def topology_prefix_gate(choice: torch.Tensor, trying: torch.Tensor,
                         rank: torch.Tensor,
                         families: Sequence[PrefixFamily]) -> torch.Tensor:
    """The gate of `topology_prefix_gate_plain`: the kernel for CUDA
    tensors (one launch, one block a group column and tile of gated
    pods), the plain version for CPU tensors. choice: i32[P] each pod's
    extended column (any value where the pod does not try); trying:
    bool[P]; rank: i32[P] (any values: a tie is not earlier); 1 to 4
    families whose dom_x share the column count X; any P and G <= 32 on
    the card.

    On the card the launch's blocks merge their columns' verdicts by
    atomic tallies of six pods, kept for the (device, stream) and zeroed
    by the launch itself, as K1's split merge keeps its tickets: a call
    allocates only its output."""
    p = choice.shape[0]
    dev = choice.device
    if not 0 < len(families) <= MAX_FAMILIES:
        raise ValueError(f"topology_prefix_gate: {len(families)} families, "
                         f"expected 1 to {MAX_FAMILIES}")
    _launch.check_tensor("choice", choice, torch.int32, (p,), dev)
    _launch.check_tensor("trying", trying, torch.bool, (p,), dev)
    _launch.check_tensor("rank", rank, torch.int32, (p,), dev)
    x = families[0].dom_x.shape[1]
    for i, fam in enumerate(families):
        g, d = fam.counts.shape
        _launch.check_tensor(f"dom_x[{i}]", fam.dom_x, torch.int32, (g, x),
                             dev)
        _launch.check_tensor(f"counts[{i}]", fam.counts, torch.float32,
                             (g, d), dev)
        _launch.check_tensor(f"charge[{i}]", fam.charge, torch.int32, (p,),
                             dev)
        _launch.check_tensor(f"gate[{i}]", fam.gate, torch.int32, (p,), dev)
        if fam.kind not in (CAP, OCCUPY, OPENER):
            raise ValueError(f"topology_prefix_gate: kind {fam.kind}")
        if fam.kind == CAP:
            if fam.lim is None:
                raise ValueError("topology_prefix_gate: a CAP family needs lim")
            _launch.check_tensor(f"lim[{i}]", fam.lim, torch.float32, (g,),
                                 dev)
        if not 0 < g <= MAX_GROUPS or d <= 0 or x <= 0:
            raise ValueError(f"topology_prefix_gate: family {i} has G={g}, "
                             f"D={d}, X={x} (1 <= G <= {MAX_GROUPS})")
    if dev.type == "cpu":
        return topology_prefix_gate_plain(choice, trying, rank, families)
    if dev.type != "cuda":
        raise ValueError(f"topology_prefix_gate: unsupported device {dev}")
    out = torch.empty((p,), dtype=torch.bool, device=dev)
    if p == 0:
        return out
    stream = _launch.stream(dev)
    tallies = _tallies(dev, stream.value or 0, p)
    ptrs = []
    dims = [p, x, len(families)]
    for fam in families:
        ptrs += [fam.dom_x.data_ptr(), fam.counts.data_ptr(),
                 fam.charge.data_ptr(), fam.gate.data_ptr(),
                 fam.lim.data_ptr() if fam.lim is not None else None]
        dims += [fam.counts.shape[0], fam.counts.shape[1], fam.kind]
    ptrs += [choice.data_ptr(), trying.data_ptr(), rank.data_ptr(),
             tallies.data_ptr(), out.data_ptr()]
    fn = TOOLCHAIN.function("topology_prefix", "koord_topology_prefix_gate",
                            [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p])
    rc = fn(_array(_PTRS, ctypes.c_void_p, ptrs),
            _array(_DIMS, ctypes.c_int, dims), stream)
    check(rc, "topology_prefix_gate")
    topology_prefix_gate.launches += 1
    return out


topology_prefix_gate.launches = 0


def launch_floor(p: int, columns: int, device) -> None:
    """Launch an empty kernel on the grid and block a K8 launch of p pods
    over `columns` group columns takes: the floor K8's device time is
    read against. Not counted in `launches`."""
    dev = torch.device(device)
    fn = TOOLCHAIN.function("topology_prefix", "koord_topology_prefix_floor",
                            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    check(fn(p, columns, _launch.stream(dev)), "topology_prefix floor")
