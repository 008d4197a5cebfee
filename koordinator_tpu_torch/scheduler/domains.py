"""The (group x topology domain) machinery of pod topology spread,
inter-pod anti-affinity and inter-pod affinity: domain maps, counts,
their charges and the per-round maps.

Counterpart of koordinator_tpu/scheduler/core.py domain_machinery
(:456-481), charge_domain_counts and charge_all_counts (:1331-1390), the
round gates (:587-675) and the spread penalty (:705-712), with singleton
domain classes (every group its own: the reference's classes batch its
per-group matvecs bit-identically) and, under the topo_prefix packing
contract, for the batch's first rows only. The maps are plain
torch over [G, N + V] and [P, G], once a round; no [P, N] tensor is
built. What they feed: kernel K1 (`score_topk`) takes a round's gates as
bit words (`TopoTerms`), kernel K8 (`topology_prefix_gate`) the in-step
prefix gates (`PrefixFamily`), and kernel K3 (`ordered_scatter_add`)
charges the counts.

A family's groups are at most 32 (one bit each in a pod's word).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from koordinator_tpu_torch.kernels.scatter import (
    ordered_scatter_add,
    ordered_scatter_add_many,
)
from koordinator_tpu_torch.kernels.score_topk import TOPO_FAMILIES, TopoTerms
from koordinator_tpu_torch.kernels.topology_prefix import (
    CAP,
    MAX_GROUPS,
    OCCUPY,
    OPENER,
    PrefixFamily,
)
from koordinator_tpu_torch.scheduler.batching import EPS, MAX_NODE_SCORE
from koordinator_tpu_torch.snapshot.schema import PodBatch

# the carried counts, in this order wherever a tuple of them travels
# (core.py:1331-1335), and each one's (domain field, member field)
COUNT_FIELDS = ("spread_count0", "anti_count0", "anti_carrier_count0",
                "aff_count0")
_COUNT_RULE = (("spread_domain", "spread_member"),
               ("anti_domain", "anti_member"),
               ("anti_domain", "anti_carrier"),
               ("aff_domain", "aff_member"))


def domain_map_x(dom: torch.Tensor, slot_node: torch.Tensor) -> torch.Tensor:
    """i32[G, N + V]: the domain map extended by the V slot columns, each
    taking its host node's domain (a slot off any node, -1, reads node
    0's, as the reference clamps it; core.py:465-468)."""
    if not slot_node.shape[0]:
        return dom.contiguous()
    return torch.cat([dom, dom[:, slot_node.clamp_min(0).long()]],
                     dim=1).contiguous()


def charge_group(count0: torch.Tensor, dom: torch.Tensor,
                 member: torch.Tensor, assignment: torch.Tensor) -> tuple:
    """The K3 group (target, idx, rows) of `charge_domain_counts`: its
    [G * D, 1] table, a level a group, rows of 1.0."""
    g_n, d_n = count0.shape
    ok = member & (assignment >= 0)[:, None]                 # [P, G]
    dom_pg = dom.T[assignment.clamp_min(0).long()]           # [P, G]
    ok = ok & (dom_pg >= 0)
    g_idx = torch.arange(g_n, dtype=torch.int32, device=dom.device)
    seg = torch.where(ok, g_idx[None, :] * d_n + dom_pg, g_n * d_n)
    ones = torch.ones((member.shape[0], 1), dtype=torch.float32,
                      device=dom.device)
    return (count0.reshape(g_n * d_n, 1), seg.T.to(torch.int32).contiguous(),
            ones)


def charge_domain_counts(count0: torch.Tensor, dom: torch.Tensor,
                         member: torch.Tensor,
                         assignment: torch.Tensor) -> torch.Tensor:
    """f32[G, D]: count0 plus one at (g, dom[g, assignment[p]]) for every
    placed row p (assignment >= 0) that is a member of g; non-members,
    unplaced rows and keyless columns (-1) drop out (core.py:1361). One
    ordered scatter through K3, a level a group: each entry's adds are
    all 1.0, so any order of them gives the reference's bits."""
    return ordered_scatter_add(
        *charge_group(count0, dom, member, assignment)).view(count0.shape)


def charge_all_counts(counts: Sequence[torch.Tensor], batch: PodBatch,
                      assignment: torch.Tensor) -> tuple:
    """The counts (COUNT_FIELDS order) with a batch's placements charged
    (core.py:1342): the cross-batch analogue of rebuilding count0 from
    running and assumed pods. `assignment` is node-level (a slot's
    consumer on its host node) and final (after the gang rollback). One
    grouped K3 call for the four tables."""
    outs = ordered_scatter_add_many([
        charge_group(c, getattr(batch, dom), getattr(batch, mem), assignment)
        for c, (dom, mem) in zip(counts, _COUNT_RULE)])
    return tuple(o.view(c.shape) for o, c in zip(outs, counts))


def batch_counts(pods: PodBatch) -> tuple:
    """The batch's count0 fields, in COUNT_FIELDS order."""
    return tuple(getattr(pods, f) for f in COUNT_FIELDS)


def pack_bits(bits: torch.Tensor, dim: int) -> torch.Tensor:
    """i32: `bits` (bool, at most 32 along `dim`) as one word, bit g the
    g-th entry along `dim`, which goes."""
    g = bits.shape[dim]
    if g > MAX_GROUPS:
        raise ValueError(f"{g} groups in a family, above {MAX_GROUPS}")
    shape = [1] * bits.dim()
    shape[dim] = g
    shifts = torch.arange(g, dtype=torch.int64,
                          device=bits.device).view(shape)
    words = (bits.to(torch.int64) << shifts).sum(dim=dim)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32).contiguous()


def _at(counts: torch.Tensor, dom_x: torch.Tensor) -> torch.Tensor:
    """f32[G, N + V]: the count of each column's domain, 0 where keyless."""
    got = torch.gather(counts, 1, dom_x.clamp_min(0).long())
    return torch.where(dom_x >= 0, got, 0.0)


@dataclasses.dataclass
class BatchTopology:
    """A batch's topology families, fixed for the batch: the slot-
    extended domain maps and the pods' bit words (None where the batch
    has no such family)."""
    spread_dom: Optional[torch.Tensor]   # i32[Sg, N + V]
    spread_member: Optional[torch.Tensor]   # i32[P]
    spread_carrier: Optional[torch.Tensor]  # i32[P]
    spread_skew: Optional[torch.Tensor]  # f32[Sg]
    spread_dvalid: Optional[torch.Tensor]  # bool[Sg, Ds]
    anti_dom: Optional[torch.Tensor]     # i32[Ag, N + V]
    anti_member: Optional[torch.Tensor]  # i32[P]
    anti_carrier: Optional[torch.Tensor]  # i32[P]
    aff_dom: Optional[torch.Tensor]      # i32[Fg, N + V]
    aff_carrier: Optional[torch.Tensor]  # i32[P]
    aff_self: Optional[torch.Tensor]     # bool[P, Fg] members that carry
    # the step commit's operands, one row a (count table, group) of the
    # present families: each row's domain map row, its members (the
    # carriers for the anti-affinity carrier counts), its offset g * D
    # in its table and its table's drop index G * D; and each table's
    # (count index, first row, end row)
    commit_dom: Optional[torch.Tensor] = None    # i32[R, N + V]
    commit_bits: Optional[torch.Tensor] = None   # bool[R, rows]
    commit_off: Optional[torch.Tensor] = None    # i32[R, 1]
    commit_drop: Optional[torch.Tensor] = None   # i32[R, 1]
    commit_tables: Tuple[Tuple[int, int, int], ...] = ()

    def families(self) -> List[Tuple[int, torch.Tensor]]:
        """(count index, domain map) of each carried count, COUNT_FIELDS
        order, present families only."""
        out = []
        if self.spread_dom is not None:
            out.append((0, self.spread_dom))
        if self.anti_dom is not None:
            out += [(1, self.anti_dom), (2, self.anti_dom)]
        if self.aff_dom is not None:
            out.append((3, self.aff_dom))
        return out


def batch_topology(pods: PodBatch, slot_node: torch.Tensor,
                   n_nodes: int, rows: Optional[int] = None
                   ) -> Optional[BatchTopology]:
    """The batch's families (`pods.has_spread` / `has_anti` / `has_aff`),
    or None where it has none. With `rows` (the topo_prefix packing
    contract, core.py:456-481) only the batch's first rows pods take
    part: the pods beyond get zero words (no gate, no penalty, no
    charge) and the step commits read the first rows only. Raises where
    a domain map is not one column a node or a family has more than 32
    groups."""
    if not (pods.has_spread or pods.has_anti or pods.has_aff):
        return None
    p = pods.num_pods
    rows = p if rows is None else rows
    in_rows = (torch.arange(p, device=pods.valid.device) < rows)[:, None]

    def bits(name):
        """A [P, G] membership field, False beyond the rows."""
        return getattr(pods, name) & in_rows

    kw = {f.name: None for f in dataclasses.fields(BatchTopology)}

    def dom(name):
        d = getattr(pods, name)
        if d.shape[1] != n_nodes:
            raise ValueError(f"{name}: {d.shape[1]} columns for "
                             f"{n_nodes} nodes")
        return domain_map_x(d, slot_node)

    if pods.has_spread:
        kw.update(spread_dom=dom("spread_domain"),
                  spread_member=pack_bits(bits("spread_member"), 1),
                  spread_carrier=pack_bits(bits("spread_carrier"), 1),
                  spread_skew=pods.spread_max_skew,
                  spread_dvalid=pods.spread_dvalid)
    if pods.has_anti:
        kw.update(anti_dom=dom("anti_domain"),
                  anti_member=pack_bits(bits("anti_member"), 1),
                  anti_carrier=pack_bits(bits("anti_carrier"), 1))
    if pods.has_aff:
        kw.update(aff_dom=dom("aff_domain"),
                  aff_carrier=pack_bits(bits("aff_carrier"), 1),
                  aff_self=bits("aff_member") & pods.aff_carrier)
    topo = BatchTopology(**kw)
    maps, members, off, drop, tables, r0 = [], [], [], [], [], 0
    for i, dom_x in topo.families():
        g_n, d_n = getattr(pods, COUNT_FIELDS[i]).shape
        g_idx = torch.arange(g_n, dtype=torch.int32, device=dom_x.device)
        maps.append(dom_x)
        members.append(getattr(pods, _COUNT_RULE[i][1])[:rows].T)
        off.append(g_idx * d_n)
        drop.append(torch.full_like(g_idx, g_n * d_n))
        tables.append((i, r0, r0 + g_n))
        r0 += g_n
    topo.commit_dom = torch.cat(maps).contiguous()
    topo.commit_bits = torch.cat(members).contiguous()
    topo.commit_off = torch.cat(off)[:, None]
    topo.commit_drop = torch.cat(drop)[:, None]
    topo.commit_tables = tuple(tables)
    return topo


def spread_maps(counts: torch.Tensor, dvalid: torch.Tensor,
                dom_x: torch.Tensor, max_skew: torch.Tensor):
    """(min_c f32[Sg], ok_map bool[Sg, N + V], penalty_map f32[Sg, N + V])
    of a round (core.py:587-625, :607-617): each group's least count over
    its eligible domains (0 where it has none), the columns where one
    more pod keeps the skew (every column for a soft group, whose skew
    is +inf; keyless columns fail a hard group), and each column's
    penalty, its domain's count over the group's largest (at least 1)
    times MAX_NODE_SCORE (0 where keyless)."""
    min_c = torch.where(dvalid, counts, torch.inf).amin(dim=1)
    min_c = torch.where(torch.isfinite(min_c), min_c, 0.0)
    cnt_at = _at(counts, dom_x)
    soft = ~torch.isfinite(max_skew)
    ok_map = soft[:, None] | ((dom_x >= 0) & (
        cnt_at + 1.0 - min_c[:, None] <= max_skew[:, None] + EPS))
    group_max = counts.amax(dim=1)
    penalty = torch.where(
        dom_x >= 0,
        cnt_at / torch.clamp_min(group_max[:, None], 1.0) * MAX_NODE_SCORE,
        0.0)
    return min_c, ok_map, penalty


def occupancy_map(counts: torch.Tensor, dom_x: torch.Tensor) -> torch.Tensor:
    """bool[G, N + V]: columns whose domain holds a count (core.py:631-
    650: anti-affinity's occ_a over member counts, occ_b over carrier
    counts); keyless columns hold none."""
    return _at(counts, dom_x) > 0.5


def affinity_maps(counts: torch.Tensor, dom_x: torch.Tensor):
    """(total f32[Fg], bad_nonboot bool[Fg, N + V], bad_boot bool[Fg,
    N + V]) of a round (core.py:651-675): each group's count over all
    domains, the columns a carrier of a populated group may not take
    (keyless, or no member in the domain) and those an opener may not
    (keyless). The counts are whole numbers, so the total is exact in
    any order."""
    bad_boot = dom_x < 0
    return counts.sum(dim=1), bad_boot | (_at(counts, dom_x) <= 0.5), bad_boot


def round_terms(topo: BatchTopology, counts: Sequence[torch.Tensor],
                active: torch.Tensor) -> Tuple[TopoTerms, Optional[torch.Tensor]]:
    """(K1's TopoTerms, the spread groups' in-step limits f32[Sg] or
    None) of a round, from the carried counts (COUNT_FIELDS order) and
    the round's active pods. A family the batch lacks contributes zero
    words; the penalty map is there only with spread groups. The limit
    of group g is fl(fl(max_skew[g] + min_c[g]) + EPS), min_c at the
    round's start (core.py:800-806)."""
    p = active.shape[0]
    x = topo.families()[0][1].shape[1]
    dev = active.device
    zero_p = torch.zeros((p,), dtype=torch.int32, device=dev)
    zero_x = torch.zeros((x,), dtype=torch.int32, device=dev)
    pod_words = [zero_p] * TOPO_FAMILIES
    col_words = [zero_x] * TOPO_FAMILIES
    penalty = lim = None
    if topo.spread_dom is not None:
        min_c, ok_map, penalty = spread_maps(
            counts[0], topo.spread_dvalid, topo.spread_dom, topo.spread_skew)
        pod_words[0] = topo.spread_carrier
        col_words[0] = pack_bits(~ok_map, 0)
        lim = (topo.spread_skew + min_c) + EPS
    if topo.anti_dom is not None:
        pod_words[1], pod_words[2] = topo.anti_carrier, topo.anti_member
        col_words[1] = pack_bits(occupancy_map(counts[1], topo.anti_dom), 0)
        col_words[2] = pack_bits(occupancy_map(counts[2], topo.anti_dom), 0)
    if topo.aff_dom is not None:
        total, bad_nonboot, bad_boot = affinity_maps(counts[3], topo.aff_dom)
        boot = active[:, None] & topo.aff_self & (total < 0.5)[None, :]
        pod_words[3] = topo.aff_carrier & ~pack_bits(boot, 1)
        pod_words[4] = pack_bits(boot, 1)
        col_words[3] = pack_bits(bad_nonboot, 0)
        col_words[4] = pack_bits(bad_boot, 0)
    terms = TopoTerms(pod_words=torch.stack(pod_words, dim=1).contiguous(),
                      col_words=torch.stack(col_words).contiguous(),
                      penalty=penalty)
    return terms, lim


def step_families(topo: BatchTopology, counts: Sequence[torch.Tensor],
                  lim: Optional[torch.Tensor],
                  rows: Optional[int] = None) -> List[PrefixFamily]:
    """K8's families for a step over the carried counts, for the batch's
    first `rows` pods (all where None): spread (members charge, carriers
    are gated, capped at `lim`), anti-affinity in both directions
    (members charge and carriers are gated over member counts; carriers
    charge and members are gated over carrier counts), and affinity's
    openers."""
    def w(words):
        return words if rows is None else words[:rows]

    fams = []
    if topo.spread_dom is not None:
        fams.append(PrefixFamily(topo.spread_dom, counts[0],
                                 w(topo.spread_member),
                                 w(topo.spread_carrier), CAP, lim))
    if topo.anti_dom is not None:
        fams += [PrefixFamily(topo.anti_dom, counts[1], w(topo.anti_member),
                              w(topo.anti_carrier), OCCUPY),
                 PrefixFamily(topo.anti_dom, counts[2], w(topo.anti_carrier),
                              w(topo.anti_member), OCCUPY)]
    if topo.aff_dom is not None:
        fams.append(PrefixFamily(topo.aff_dom, counts[3], w(topo.aff_carrier),
                                 w(topo.aff_carrier), OPENER))
    return fams


def commit_count_groups(topo: BatchTopology, counts: Sequence[torch.Tensor],
                        accept: torch.Tensor, choice: torch.Tensor):
    """(groups, finish): the K3 groups that charge this step's accepted
    pods into the carried counts, one a count table, and the function
    that turns their outputs into the counts (`commit_counts`), so that
    the scheduler's step runs them with its other commits in one call."""
    x = topo.commit_dom.shape[1]
    dom = topo.commit_dom[:, choice.clamp(0, x - 1)]          # [R, P]
    ok = topo.commit_bits & accept[None, :] & (dom >= 0)
    idx = torch.where(ok, topo.commit_off + dom, topo.commit_drop)
    ones = torch.ones((accept.shape[0], 1), dtype=torch.float32,
                      device=accept.device)
    tables = topo.commit_tables
    groups = [(counts[i].reshape(-1, 1), idx[r0:r1], ones)
              for i, r0, r1 in tables]

    def finish(outs):
        out = list(counts)
        for (i, _, _), o in zip(tables, outs):
            out[i] = o.view(counts[i].shape)
        return tuple(out)

    return groups, finish


def commit_counts(topo: BatchTopology, counts: Sequence[torch.Tensor],
                  accept: torch.Tensor, choice: torch.Tensor) -> tuple:
    """The carried counts with this step's accepted pods charged: each
    accepted member (carrier, for the anti-affinity carrier counts) of
    group g at dom_x[g, choice] (an extended column: a slot's consumer
    on its host's domain). `accept` and `choice` are the first rows of
    the batch that `batch_topology` took (core.py:479: the in-batch
    counts charge `member[:pc]`). The indices of every table come from
    one gather over the batch's commit rows; then one grouped K3 call."""
    groups, finish = commit_count_groups(topo, counts, accept, choice)
    return finish(ordered_scatter_add_many(groups))
