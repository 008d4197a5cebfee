"""Pod topology spread, inter-pod anti-affinity and affinity in the port
against the JAX package: the round maps and K1's factored gate and
spread penalty (scheduler/domains.py, kernels/score_topk.py's plain
version), K8's plain version (kernels/topology_prefix.py), the count
charges, and schedule_batch on the reference's topology scenarios
(tests/test_scheduler_core.py, tests/test_bench_mesh.py), each built
with the reference's SnapshotBuilder and carried across the bridge.

The reference computes the round gates and the in-step prefix gates
inside schedule_batch; the helpers below restate those lines
(core.py:456-481, :587-675, :705-712, :776-884, singleton domain
classes) in JAX on the same numpy inputs.

Tolerances: none, but for the spread penalty of pods carrying three or
more spread groups, where the sum's order differs (rtol 1e-6)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.api.extension import ResourceKind as RK
from koordinator_tpu.api.types import (
    Node,
    NodeMetric,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    Taint,
    Toleration,
)
from koordinator_tpu.api.types import TopologySpreadConstraint as TSC
from koordinator_tpu.scheduler import core as jcore
from koordinator_tpu.scheduler.plugins import reservation as jresv
from koordinator_tpu.scheduler.plugins.loadaware import LoadAwareConfig as JCfg
from koordinator_tpu.snapshot.builder import SnapshotBuilder
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch.bridge import to_numpy
from koordinator_tpu_torch.kernels.score_topk import (
    score_topk,
    spread_penalty,
    topo_blocked,
)
from koordinator_tpu_torch.kernels.topology_prefix import (
    CAP,
    OCCUPY,
    OPENER,
    PrefixFamily,
    topology_prefix_gate,
)
from koordinator_tpu_torch.scheduler import core, domains
from koordinator_tpu_torch.scheduler.batching import EPS, rank_by_priority
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.utils import synthetic

from test_torch_reservation import (
    FIT_DIMS,
    SCORE_DIMS,
    assert_results_equal,
    k1_slot_inputs,
)
from torch_port_ref import assert_trees_equal, numpy_tree, to_port
from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)

NOW = 1_700_000_000.0
TOPO_FIELDS = ("spread_id", "spread_carrier", "spread_member",
               "spread_max_skew", "spread_domain", "spread_count0",
               "spread_dvalid", "anti_id", "anti_member", "anti_carrier",
               "anti_domain", "anti_count0", "anti_carrier_count0", "aff_id",
               "aff_carrier", "aff_member", "aff_domain", "aff_count0")


# --- the workload's topology groups ----------------------------------------


@pytest.mark.parametrize("nodes,pods,seed", [(300, 1200, 0), (10_000, 2000, 1),
                                             (40, 2000, 5)])
def test_full_gate_pods_topology_equal_reference(nodes, pods, seed):
    """The port's full_gate_pods keeps the reference's spread,
    anti-affinity and affinity draws: every topology field array-equal,
    the switches on."""
    want = numpy_tree(jsyn.full_gate_pods(pods, nodes, seed=seed))
    got = to_numpy(synthetic.full_gate_pods(pods, nodes, seed=seed,
                                            device="cpu"))
    assert_trees_equal({f: got[f] for f in TOPO_FIELDS},
                       {f: want[f] for f in TOPO_FIELDS})
    assert got["has_spread"] and got["has_anti"] and got["has_aff"]
    assert want["spread_member"].any() and want["anti_carrier"].any()
    assert want["aff_carrier"].any()


# --- the round maps and K1's factored gate ----------------------------------


def _topology_case(seed, n_nodes=120, p=600, v=16, wide_spread=False):
    """Full-gate pods with their topology fields edited so that every
    branch bites: random whole-number count0 (some domains ineligible),
    soft spread groups, keyless columns, members that do not carry and
    carriers that do not match, and pods matching several groups;
    `wide_spread` lets some pods carry three or more spread groups.
    Also a random extended placement (slots included), the active rows,
    and the slots' host nodes (some off any node)."""
    rng = np.random.default_rng(seed)
    pods = jsyn.full_gate_pods(p, n_nodes, seed=seed + 1)
    f32 = np.float32

    def edit_bits(x, flip):
        x = np.asarray(x).copy()
        return x ^ (rng.uniform(size=x.shape) < flip)

    def keyless(d, share=0.1):
        d = np.asarray(d).copy()
        d[rng.uniform(size=d.shape) < share] = -1
        return d

    s_carrier = edit_bits(pods.spread_carrier, 0.02)
    over = s_carrier.sum(axis=1) > 2   # at most two unless wide_spread
    s_carrier[over] = np.asarray(pods.spread_carrier)[over]
    if wide_spread:
        rows = rng.uniform(size=p) < 0.2
        s_carrier[rows] |= rng.uniform(
            size=(int(rows.sum()), s_carrier.shape[1])) < 0.3
    skew = np.asarray(pods.spread_max_skew).copy()
    skew[[1, 9]] = np.inf                       # ScheduleAnyway groups
    skew[[0, 2]] = 1.0                          # tight hard groups
    s_count0 = rng.integers(0, 4, np.asarray(pods.spread_count0).shape)
    dvalid = np.asarray(pods.spread_dvalid) & (
        rng.uniform(size=s_count0.shape) < 0.9)
    a_count0 = rng.integers(0, 2, np.asarray(pods.anti_count0).shape)
    a_count0[rng.uniform(size=a_count0.shape) < 0.8] = 0
    c_count0 = a_count0 * (rng.uniform(size=a_count0.shape) < 0.5)
    f_count0 = np.zeros(np.asarray(pods.aff_count0).shape, np.int64)
    f_count0[::2, 3] = 2                        # even groups populated
    pods = pods.replace(
        spread_carrier=s_carrier,
        spread_member=edit_bits(pods.spread_member, 0.02),
        spread_max_skew=skew.astype(f32),
        spread_domain=keyless(pods.spread_domain),
        spread_count0=s_count0.astype(f32), spread_dvalid=dvalid,
        anti_member=edit_bits(pods.anti_member, 0.01),
        anti_carrier=edit_bits(pods.anti_carrier, 0.01),
        anti_domain=keyless(pods.anti_domain),
        anti_count0=a_count0.astype(f32),
        anti_carrier_count0=c_count0.astype(f32),
        aff_member=edit_bits(pods.aff_member, 0.01),
        aff_carrier=edit_bits(pods.aff_carrier, 0.01),
        aff_domain=keyless(pods.aff_domain),
        aff_count0=f_count0.astype(f32))
    slot_node = rng.integers(-1, n_nodes, v).astype(np.int32)
    placed = np.where(rng.uniform(size=p) < 0.3,
                      rng.integers(0, n_nodes + v, p), -1).astype(np.int32)
    active = (placed < 0) & (rng.uniform(size=p) < 0.9)
    return jax.tree_util.tree_map(jnp.asarray, pods), slot_node, placed, \
        active


def _ext(d, slot_node):
    """core.py:465-468: slot columns take their host node's domain."""
    if not slot_node.shape[0]:
        return d
    return jnp.concatenate([d, d[:, jnp.maximum(slot_node, 0)]], 1)


def reference_counts(pods, slot_node, placed):
    """The reference's in-batch counts (domain_machinery's counts_flat):
    count0 plus the placed members through the slot-extended maps."""
    sn = jnp.asarray(slot_node)
    pl = jnp.asarray(placed)
    return tuple(
        jcore.charge_domain_counts(getattr(pods, c), _ext(getattr(pods, d), sn),
                                   getattr(pods, m), pl)
        for c, (d, m) in zip(jcore.COUNT_FIELDS,
                             (("spread_domain", "spread_member"),
                              ("anti_domain", "anti_member"),
                              ("anti_domain", "anti_carrier"),
                              ("aff_domain", "aff_member"))))


def reference_round_gates(pods, slot_node, placed, active):
    """(blocked bool[P, N + V], spread penalty f32[P, N + V], min_c) of
    a round: core.py:587-675 and :705-712, full width."""
    sn = jnp.asarray(slot_node)
    active = jnp.asarray(active)
    counts, counts_an, carr, counts_af = reference_counts(pods, slot_node,
                                                          placed)
    sx = _ext(pods.spread_domain, sn)
    ax = _ext(pods.anti_domain, sn)
    fx = _ext(pods.aff_domain, sn)
    spread_soft = ~jnp.isfinite(pods.spread_max_skew)
    min_c = jnp.min(jnp.where(pods.spread_dvalid, counts, jnp.inf), axis=1)
    min_c = jnp.where(jnp.isfinite(min_c), min_c, 0.0)
    cnt_at = jnp.where(sx >= 0, jnp.take_along_axis(
        counts, jnp.maximum(sx, 0), axis=1), 0.0)
    ok_map = (spread_soft[:, None]
              | ((sx >= 0) & (cnt_at + 1.0 - min_c[:, None]
                              <= pods.spread_max_skew[:, None] + EPS)))
    spread_carrier_f = pods.spread_carrier.astype(jnp.float32)
    blocks = [(spread_carrier_f @ (~ok_map).astype(jnp.float32)) > 0.5]
    group_max = jnp.max(counts, axis=1)
    penalty_map = jnp.where(
        sx >= 0, cnt_at / jnp.maximum(group_max[:, None], 1.0) * 100.0, 0.0)
    penalty = spread_carrier_f @ penalty_map
    occ_a = (jnp.where(ax >= 0, jnp.take_along_axis(
        counts_an, jnp.maximum(ax, 0), axis=1), 0.0) > 0.5)
    blocks.append((pods.anti_carrier.astype(jnp.float32)
                   @ occ_a.astype(jnp.float32)) > 0.5)
    occ_b = (jnp.where(ax >= 0, jnp.take_along_axis(
        carr, jnp.maximum(ax, 0), axis=1), 0.0) > 0.5)
    blocks.append((pods.anti_member.astype(jnp.float32)
                   @ occ_b.astype(jnp.float32)) > 0.5)
    total_af = jnp.sum(counts_af, axis=1)
    cc_map = jnp.where(fx >= 0, jnp.take_along_axis(
        counts_af, jnp.maximum(fx, 0), axis=1), 0.0)
    boot_pg = (active[:, None] & pods.aff_member & pods.aff_carrier
               & (total_af < 0.5)[None, :])
    bad_nonboot = ((fx < 0) | (cc_map <= 0.5)).astype(jnp.float32)
    bad_boot = (fx < 0).astype(jnp.float32)
    blocks.append((
        (pods.aff_carrier & ~boot_pg).astype(jnp.float32) @ bad_nonboot
        + boot_pg.astype(jnp.float32) @ bad_boot) > 0.5)
    blocked = functools.reduce(jnp.logical_or, blocks)
    return np.asarray(blocked), np.asarray(penalty), np.asarray(min_c)


def port_counts(tpods, slot_node, placed):
    """The port's in-batch counts: count0 plus the placed members
    through the slot-extended maps (domains.charge_domain_counts)."""
    sn = torch.from_numpy(np.array(slot_node))
    return tuple(
        domains.charge_domain_counts(
            c, domains.domain_map_x(getattr(tpods, d), sn),
            getattr(tpods, m), torch.from_numpy(np.array(placed)))
        for c, (d, m) in zip(domains.batch_counts(tpods),
                             domains._COUNT_RULE))


def port_round(pods, slot_node, placed, active, n_nodes):
    """The port's round: its counts, then domains.round_terms."""
    tpods = to_port("PodBatch", pods)
    topo = domains.batch_topology(tpods, torch.from_numpy(slot_node),
                                  n_nodes)
    counts = port_counts(tpods, slot_node, placed)
    terms, lim = domains.round_terms(topo, counts,
                                     torch.from_numpy(np.array(active)))
    return topo, counts, terms, lim


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_maps_and_factored_gate_equal_reference(seed):
    """K1's factored topology gate, expanded, equals the reference's
    blocked matrix over the node and slot columns; the spread penalty
    (at most two carried groups a pod) is bit-equal; the in-step limits
    are fl(fl(max_skew + min_c) + EPS)."""
    pods, slot_node, placed, active = _topology_case(seed)
    n = pods.spread_domain.shape[1]
    blocked, penalty, min_c = reference_round_gates(pods, slot_node, placed,
                                                    active)
    _, _, terms, lim = port_round(pods, slot_node, placed, active, n)
    got = topo_blocked(terms).numpy()
    np.testing.assert_array_equal(got, blocked)
    assert 0 < blocked.sum() < blocked.size
    assert blocked[:, n:].any() and (~blocked[:, n:]).any()
    assert (np.asarray(pods.spread_carrier).sum(axis=1) <= 2).all()
    pen = spread_penalty(terms, blocked.shape[1]).numpy()
    assert pen.tobytes() == penalty.tobytes() and penalty.any()
    want_lim = (np.asarray(pods.spread_max_skew) + min_c) + np.float32(EPS)
    assert lim.numpy().tobytes() == want_lim.astype(np.float32).tobytes()


def test_spread_penalty_of_three_or_more_groups():
    """Pods carrying three or more spread groups: the ascending-order
    sum against the reference's f32 matmul, within rtol 1e-6 (the
    orders differ); the gate is still exact."""
    pods, slot_node, placed, active = _topology_case(5, wide_spread=True)
    n = pods.spread_domain.shape[1]
    blocked, penalty, _ = reference_round_gates(pods, slot_node, placed,
                                                active)
    _, _, terms, _ = port_round(pods, slot_node, placed, active, n)
    np.testing.assert_array_equal(topo_blocked(terms).numpy(), blocked)
    wide = np.asarray(pods.spread_carrier).sum(axis=1) >= 3
    assert wide.sum() > 10
    pen = spread_penalty(terms, blocked.shape[1]).numpy()
    np.testing.assert_allclose(pen, penalty, rtol=1e-6, atol=0)
    narrow = ~wide
    assert pen[narrow].tobytes() == penalty[narrow].tobytes()


def test_pack_bits_refuses_more_than_32_groups():
    with pytest.raises(ValueError, match="32"):
        domains.pack_bits(torch.zeros((4, 33), dtype=torch.bool), 1)
    words = domains.pack_bits(torch.ones((2, 32), dtype=torch.bool), 1)
    assert words.dtype == torch.int32 and int(words[0]) == -1


# --- K1 with the topology term -----------------------------------------------


@functools.partial(jax.jit, static_argnames=("k", "tie_break"))
def reference_select_topo(nodes, pods, cfg, ext_static, taint_penalty,
                          row_ok, requested, ext_alloc, blocked, addend,
                          topo_blocked_, spread_pen, *, k, tie_break):
    """The round prologue of core.py schedule_batch over N + V columns
    with the topology gates and the spread penalty (core.py:565-742)."""
    from koordinator_tpu.scheduler.plugins import loadaware as jla
    fd = list(FIT_DIMS)
    p = pods.requests.shape[0]
    n = nodes.allocatable.shape[0]
    n_ext = ext_alloc.shape[0]
    fit = jnp.all(pods.requests[:, None, fd] + requested[None][..., fd]
                  <= ext_alloc[None][..., fd] + EPS, axis=-1)
    feasible = fit & ext_static & row_ok[:, None]
    feasible &= ~jnp.concatenate([jnp.zeros((n,), bool), blocked])[None, :]
    feasible &= ~topo_blocked_
    scores = jla.score_matrix(nodes, pods, cfg, SCORE_DIMS) + addend
    if taint_penalty is not None:
        scores = jnp.maximum(scores - taint_penalty, 0.0)
    if spread_pen is not None:
        scores = jnp.maximum(scores - spread_pen[:, :n], 0.0)
    scores = jnp.concatenate(
        [scores, jnp.full((p, n_ext - n), 3.0 * 100.0 + 1.0)], axis=1)
    if tie_break:
        pi = jnp.arange(p, dtype=jnp.uint32)[:, None]
        ni = jnp.arange(n_ext, dtype=jnp.uint32)[None, :]
        h = (pi * jnp.uint32(2654435761) + ni * jnp.uint32(40503)) & 1023
        scores = scores + h.astype(jnp.float32) * (0.49 / 1024.0)
    masked = jnp.where(feasible, scores, -1.0)
    val, idx = jax.lax.top_k(masked, k)
    return val, idx.astype(jnp.int32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k,tie_break", [(8, True), (32, False), (32, True)])
@pytest.mark.parametrize("variant", ["all", "no_spread", "no_taints"])
def test_k1_topology_term_equal_reference(seed, k, tie_break, variant):
    """K1's plain version with the factored topology gate and the spread
    penalty (with the taint term, an addend and the slot columns)
    against the reference's masked lax.top_k: indices exactly, values
    bit for bit. "no_spread" drops the spread family (no penalty, no
    floor); "no_taints" drops the taint term (the floor still applies
    to every row)."""
    from test_torch_reservation import _slot_case
    ref, port = k1_slot_inputs(seed, taints=variant != "no_taints")
    pods = ref["pods"]
    n = ref["nodes"].allocatable.shape[0]
    p = pods.requests.shape[0]
    slot_node = np.array(_slot_case(seed)[0].reservations.node)
    v = slot_node.shape[0]
    rng = np.random.default_rng(seed + 50)
    placed = np.where(rng.uniform(size=p) < 0.3, rng.integers(0, n + v, p),
                      -1).astype(np.int32)
    active = np.asarray(ref["row_ok"])
    spread = pods
    if variant == "no_spread":
        pods = pods.replace(has_spread=False)
        spread = pods.replace(spread_carrier=jnp.zeros_like(
            pods.spread_carrier))
    blocked, penalty, _ = reference_round_gates(spread, slot_node, placed,
                                                active)
    _, _, terms, _ = port_round(pods, slot_node, placed, active, n)
    want = reference_select_topo(
        **dict(ref, pods=pods), topo_blocked_=jnp.asarray(blocked),
        spread_pen=None if variant == "no_spread" else jnp.asarray(penalty),
        k=k, tie_break=tie_break)
    got = score_topk(**port, topo=terms, k=k, tie_break=tie_break)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    assert (terms.penalty is None) == (variant == "no_spread")
    assert blocked[active].any() and (got[1].numpy() >= n).any()


# --- K8: the in-step prefix gates --------------------------------------------


def reference_step_gates(pods, slot_node, counts, min_c, choice_eff, trying,
                         rank):
    """accept after the in-step topology gates of one commit step,
    starting from all True: core.py:776-884 at full width with
    singleton domain classes, for the families the batch has."""
    sn = jnp.asarray(slot_node)
    sx = _ext(pods.spread_domain, sn)
    ax = _ext(pods.anti_domain, sn)
    fx = _ext(pods.aff_domain, sn)
    n_ext = sx.shape[1]
    rank = jnp.asarray(rank)
    earlier_pc = rank[None, :] < rank[:, None]
    trying_pc = jnp.asarray(trying)
    choice_pc = jnp.clip(jnp.asarray(choice_eff), 0, n_ext - 1)
    accept_pc = jnp.ones(trying_pc.shape, bool)
    counts_s_now, counts_an_now, carr_now, counts_af_now = counts
    if pods.has_spread:
        spread_soft = ~jnp.isfinite(pods.spread_max_skew)
        for g in range(sx.shape[0]):
            ci_ = np.asarray([g], dtype=np.int32)
            dom_g = sx[ci_[0], choice_pc]
            has_dom = (dom_g >= 0)[:, None]
            same_d = dom_g[:, None] == dom_g[None, :]
            e_mask = (same_d & earlier_pc).astype(jnp.float32)
            dom_c = jnp.maximum(dom_g, 0)
            contrib = (trying_pc[:, None] & pods.spread_member[:, ci_]
                       & has_dom).astype(jnp.float32)
            gated = (trying_pc[:, None] & pods.spread_carrier[:, ci_]
                     & has_dom & ~spread_soft[ci_][None, :])
            occ = counts_s_now[ci_][:, dom_c].T + e_mask @ contrib
            limit_c = (pods.spread_max_skew[ci_] + min_c[ci_])[None, :]
            accept_pc &= jnp.all(~gated | (occ + 1.0 <= limit_c + EPS),
                                 axis=1)
    if pods.has_anti:
        for g in range(ax.shape[0]):
            ci_ = np.asarray([g], dtype=np.int32)
            dom_g = ax[ci_[0], choice_pc]
            has_dom = (dom_g >= 0)[:, None]
            same_d = dom_g[:, None] == dom_g[None, :]
            e_mask = (same_d & earlier_pc).astype(jnp.float32)
            dom_c = jnp.maximum(dom_g, 0)
            member_c = pods.anti_member[:, ci_]
            carrier_c = pods.anti_carrier[:, ci_]
            contrib_a = (trying_pc[:, None] & member_c
                         & has_dom).astype(jnp.float32)
            gated_a = trying_pc[:, None] & carrier_c & has_dom
            occ_a = counts_an_now[ci_][:, dom_c].T + e_mask @ contrib_a
            accept_pc &= jnp.all((occ_a < 0.5) | ~gated_a, axis=1)
            contrib_b = (trying_pc[:, None] & carrier_c
                         & has_dom).astype(jnp.float32)
            gated_b = trying_pc[:, None] & member_c & has_dom
            occ_b_g = carr_now[ci_][:, dom_c].T + e_mask @ contrib_b
            accept_pc &= jnp.all((occ_b_g < 0.5) | ~gated_b, axis=1)
    if pods.has_aff:
        total_now = jnp.sum(counts_af_now, axis=1)
        e_full = earlier_pc.astype(jnp.float32)
        for g in range(fx.shape[0]):
            ci_ = np.asarray([g], dtype=np.int32)
            dom_g = fx[ci_[0], choice_pc]
            cc_now = counts_af_now[ci_][:, jnp.maximum(dom_g, 0)].T
            boot_try = (trying_pc[:, None] & pods.aff_carrier[:, ci_]
                        & (dom_g >= 0)[:, None] & (cc_now < 0.5))
            openers_before = e_full @ boot_try.astype(jnp.float32)
            accept_pc &= jnp.all(
                ~boot_try | (total_now[ci_][None, :] + openers_before < 0.5),
                axis=1)
    return np.asarray(accept_pc)


def _wide_affinity(pods, width=10_000):
    """The pods with their affinity domains spread over a count table of
    `width` domains (domain d of node n becomes d * k + n mod k), the
    populated groups' counts moved with them."""
    dom = np.asarray(pods.aff_domain)
    count0 = np.asarray(pods.aff_count0)
    k = width // count0.shape[1]
    node = np.arange(dom.shape[1])[None, :]
    wide = np.where(dom >= 0, dom * k + node % k, -1).astype(np.int32)
    c = np.zeros((count0.shape[0], width), np.float32)
    c[:, ::k][:, :count0.shape[1]] = count0
    return pods.replace(aff_domain=jnp.asarray(wide), aff_count0=jnp.asarray(c))


def _step_case(seed, families, edit=None):
    """A step over _topology_case's pods: counts at the round's start
    (its placement) and now (a few more placed since), each pod's
    extended choice (several on one column, some on slots), the trying
    pods and a priority order with ties broken by index. `edit`:
    "crowded" makes 95 % of the pods carry and match spread group 3 and
    puts 60 % on two columns (segments of more than 64 charging pods),
    "wide_opener" spreads the affinity domains over 10 000
    (`_wide_affinity`), "p33" takes the first 33 pods."""
    pods, slot_node, placed0, active = _topology_case(seed)
    if edit == "wide_opener":
        pods = _wide_affinity(pods)
    if edit == "crowded":    # most pods carry and match spread group 3
        many = np.random.default_rng(seed + 7).uniform(
            size=placed0.shape[0]) < 0.95
        pods = pods.replace(**{
            f: jnp.asarray(np.asarray(getattr(pods, f)).copy())
            .at[:, 3].set(jnp.asarray(many))
            for f in ("spread_member", "spread_carrier")})
    if edit == "p33":
        pods = jsyn.slice_batch(pods, 0, 33)
        placed0, active = placed0[:33], active[:33]
    pods = pods.replace(**{f"has_{f}": f in families
                           for f in ("spread", "anti", "aff")})
    rng = np.random.default_rng(seed + 100)
    p = placed0.shape[0]
    n = pods.spread_domain.shape[1]
    v = slot_node.shape[0]
    more = (placed0 < 0) & (rng.uniform(size=p) < 0.2)
    placed1 = np.where(more, rng.integers(0, n + v, p), placed0).astype(
        np.int32)
    choice = rng.integers(0, n + v, p)
    hot = rng.uniform(size=p) < 0.3          # crowd a few columns
    choice = np.where(hot, rng.integers(0, 6, p), choice)
    if edit == "crowded":
        choice = np.where(rng.uniform(size=p) < 0.6,
                          rng.integers(0, 2, p), choice)
    trying = active & (placed1 < 0) & (rng.uniform(size=p) < 0.9)
    choice_eff = np.where(trying, choice, n + v).astype(np.int32)
    prio = rng.integers(0, 5, p).astype(np.int32)
    return pods, slot_node, placed0, placed1, active, choice_eff, trying, \
        prio


def _max_segment_chargers(choice, trying, families):
    """The most charging pods any group column of `families` puts in one
    segment (OPENER columns: its openers)."""
    most = 0
    for fam in families:
        c = choice.clamp(0, fam.dom_x.shape[1] - 1).long()
        for g in range(fam.dom_x.shape[0]):
            dom = fam.dom_x[g, c]
            words = fam.gate if fam.kind == OPENER else fam.charge
            charge = trying & (dom >= 0) & (((words >> g) & 1) != 0)
            if charge.any():
                most = max(most, int(torch.bincount(dom[charge]).max()))
    return most


# seeds, and seed 0 edited: "crowded" and "wide_opener" (`_step_case`),
# "reversed" (ranks in the reverse of index order), "p33" (33 pods)
@pytest.mark.parametrize("seed", [0, 1, 2, "crowded", "reversed",
                                  "wide_opener", "p33"])
@pytest.mark.parametrize("families", [("spread", "anti", "aff"), ("spread",),
                                      ("anti",), ("aff",)], ids="+".join)
def test_k8_prefix_gates_equal_reference(seed, families):
    """K8's plain version against the reference's in-step loops:
    members that do not carry and carriers that do not match, keyless
    columns, soft spread groups, pods in several groups, slot columns,
    the round-start minimum against counts that moved since, and
    affinity openers of empty groups beside carriers of populated
    ones; then segments of more than 64 charging pods, reversed ranks,
    an opener column over 10 000 domains and P = 33."""
    edit = seed if isinstance(seed, str) else None
    pods, slot_node, placed0, placed1, active, choice_eff, trying, prio = \
        _step_case(0 if edit else seed, families, edit)
    n = pods.spread_domain.shape[1]
    _, _, min_c = reference_round_gates(pods, slot_node, placed0, active)
    tpods = to_port("PodBatch", pods)
    rank = rank_by_priority(tpods.replace(priority=torch.from_numpy(prio)))
    if edit == "reversed":
        rank = torch.arange(rank.shape[0] - 1, -1, -1, dtype=torch.int32)
    want = reference_step_gates(
        pods, slot_node, reference_counts(pods, slot_node, placed1),
        jnp.asarray(min_c), choice_eff, trying, rank.numpy())
    topo, _, _, lim = port_round(pods, slot_node, placed0, active, n)
    counts = port_counts(tpods, slot_node, placed1)
    fams = domains.step_families(topo, counts, lim)
    choice_t, trying_t = torch.from_numpy(choice_eff), torch.from_numpy(trying)
    got = topology_prefix_gate(choice_t, trying_t, rank, fams).numpy()
    np.testing.assert_array_equal(got, want)
    if edit == "crowded" and "spread" in families:
        assert _max_segment_chargers(choice_t, trying_t, fams) > 64
    if edit == "wide_opener" and "aff" in families:
        assert fams[-1].kind == OPENER and fams[-1].counts.shape[1] == 10_000
    if edit != "p33":   # 33 pods are too few to make every family bite
        assert (~want & trying).any() and (want & trying).any()
    assert want[~trying].all()


def test_k8_single_family_kinds():
    """Each kind on a hand-made case: a spread cap of one over a domain
    two earlier members already take, an anti-affinity domain an
    earlier member charges, and one opener a group a step."""
    dom = torch.tensor([[0, 0, 1, -1]], dtype=torch.int32)
    choice = torch.tensor([0, 1, 2, 3, 1], dtype=torch.int32)
    trying = torch.tensor([True, True, True, True, True])
    rank = torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32)
    ones = torch.full((5,), 1, dtype=torch.int32)
    counts = torch.zeros((1, 2))
    cap = PrefixFamily(dom, counts, ones, ones, CAP,
                       torch.tensor([2.0 + EPS]))
    got = topology_prefix_gate(choice, trying, rank, [cap])
    # domain 0 takes rows 0 and 1; row 4 is the third: 2 + 1 > 2.5
    assert got.tolist() == [True, True, True, True, False]
    occ = PrefixFamily(dom, counts, ones, ones, OCCUPY)
    got = topology_prefix_gate(choice, trying, rank, [occ])
    assert got.tolist() == [True, False, True, True, False]
    opener = PrefixFamily(dom, counts, ones, ones, OPENER)
    got = topology_prefix_gate(choice, trying, rank, [opener])
    # the keyless row opens nothing; every other is an opener: one wins
    assert got.tolist() == [True, False, False, True, False]
    got = topology_prefix_gate(choice, trying, rank, [
        PrefixFamily(dom, torch.tensor([[1.0, 0.0]]), ones, ones, OPENER)])
    # a populated group has no openers of its populated domain; an
    # empty domain's try is an opener that the total refuses
    assert got.tolist() == [True, True, False, True, True]
    with pytest.raises(ValueError, match="lim"):
        topology_prefix_gate(choice, trying, rank, [
            PrefixFamily(dom, counts, ones, ones, CAP)])
    with pytest.raises(ValueError, match="families"):
        topology_prefix_gate(choice, trying, rank, [])


# --- the counts ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("whole", [True, False], ids=["whole", "fractional"])
def test_charge_counts_equal_reference(seed, whole):
    """charge_domain_counts and charge_all_counts against the
    reference's: unplaced rows, non-members and keyless columns drop
    out; bit-equal also from fractional counts (each entry's adds are
    all 1.0, so the order of the scatter does not show)."""
    pods, _, _, _ = _topology_case(seed)
    rng = np.random.default_rng(seed + 7)
    n = pods.spread_domain.shape[1]
    assign = np.where(rng.uniform(size=pods.spread_member.shape[0]) < 0.6,
                      rng.integers(0, n, pods.spread_member.shape[0]),
                      -1).astype(np.int32)
    counts = tuple(np.array(getattr(pods, f)) for f in jcore.COUNT_FIELDS)
    if not whole:
        counts = tuple((c + rng.uniform(0, 1, c.shape) * 0.37).astype(
            np.float32) for c in counts)
    want = jcore.charge_all_counts(tuple(map(jnp.asarray, counts)), pods,
                                   jnp.asarray(assign))
    got = domains.charge_all_counts(tuple(map(torch.from_numpy, counts)),
                                    to_port("PodBatch", pods),
                                    torch.from_numpy(assign))
    for w, g in zip(want, got):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    assert any(not np.array_equal(np.asarray(w), c)
               for w, c in zip(want, counts))


@pytest.mark.parametrize("seed", [0, 1])
def test_commit_counts_equal_reference_recount(seed):
    """The in-step commit (one ordered scatter a count table) onto the
    counts of a placement equals the reference's recount from the
    placement with the step's accepted pods added, slot columns on their
    host's domains."""
    pods, slot_node, placed0, _ = _topology_case(seed)
    rng = np.random.default_rng(seed + 11)
    p = placed0.shape[0]
    n = pods.spread_domain.shape[1]
    v = slot_node.shape[0]
    choice = rng.integers(0, n + v, p).astype(np.int32)
    accept = (placed0 < 0) & (rng.uniform(size=p) < 0.4)
    placed1 = np.where(accept, choice, placed0).astype(np.int32)
    tpods = to_port("PodBatch", pods)
    topo = domains.batch_topology(tpods, torch.from_numpy(slot_node), n)
    got = domains.commit_counts(topo, port_counts(tpods, slot_node, placed0),
                                torch.from_numpy(accept),
                                torch.from_numpy(choice))
    want = reference_counts(pods, slot_node, placed1)
    for w, g in zip(want, got):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


# --- schedule_batch on the reference's scenarios -------------------------------


def _nodes(b, specs):
    """Add nodes (name, labels, cpu, taints) with fresh empty metrics."""
    for name, labels, cpu, *taints in specs:
        b.add_node(Node(meta=ObjectMeta(name=name, labels=labels),
                        allocatable={RK.CPU: cpu, RK.MEMORY: 65536},
                        taints=list(taints[0]) if taints else []))
        b.set_node_metric(NodeMetric(node_name=name, update_time=NOW,
                                     node_usage={}))
    return b


def _zone_cluster(zones=("z1", "z2", "z3"), cpu=64000.0):
    return _nodes(SnapshotBuilder(max_nodes=len(zones)),
                  [(f"n{i}", {"zone": z}, cpu) for i, z in enumerate(zones)])


def _pod(name, labels=None, prio=9000, cpu=100.0, **kw):
    return Pod(meta=ObjectMeta(name=name, namespace="d", labels=labels or {}),
               priority=prio, requests={RK.CPU: cpu}, **kw)


def _running(name, labels, node, **kw):
    return Pod(meta=ObjectMeta(name=name, namespace="d", labels=labels),
               requests={RK.CPU: 100.0}, phase="Running", node_name=node,
               **kw)


WEB = {"app": "web"}


def _sc_spread_hard():
    b = _nodes(SnapshotBuilder(max_nodes=4),
               [(f"n{i}", {"zone": z} if z else {}, 64000)
                for i, z in enumerate(("z1", "z1", "z2", None))])
    b.add_running_pod(_running("r0", WEB, "n0"))
    tsc = TSC(max_skew=1, topology_key="zone", label_selector=WEB)
    return b, [_pod(f"w{j}", WEB, spread_constraints=[tsc])
               for j in range(3)], 4


def _sc_spread_impossible():
    b = _nodes(SnapshotBuilder(max_nodes=2),
               [("n0", {"zone": "z1"}, 8000), ("n1", {"zone": "z2"}, 200)])
    tsc = TSC(max_skew=1, topology_key="zone", label_selector=WEB)
    return b, [_pod(f"w{j}", WEB, cpu=500.0, spread_constraints=[tsc])
               for j in range(4)], 6


def _sc_spread_unreachable_min():
    b = _nodes(SnapshotBuilder(max_nodes=3),
               [(f"n{i}", {"zone": z, "pool": "gpu" if z == "z3" else "cpu"},
                 64000) for i, z in enumerate(("z1", "z2", "z3"))])
    tsc = TSC(max_skew=1, topology_key="zone", label_selector=WEB)
    return b, [_pod(f"w{j}", WEB, node_selector={"pool": "cpu"},
                    spread_constraints=[tsc]) for j in range(4)], 6


def _sc_schedule_anyway():
    b = _nodes(SnapshotBuilder(max_nodes=3),
               [(f"n{i}", {"zone": z} if z else {}, 64000)
                for i, z in enumerate(("z1", "z1", None))])
    soft = TSC(max_skew=1, topology_key="zone",
               when_unsatisfiable="ScheduleAnyway", label_selector=WEB)
    return b, [_pod(f"w{j}", WEB, spread_constraints=[soft])
               for j in range(4)], 5


def _sc_schedule_anyway_prefers_empty():
    b, pods, _ = _sc_schedule_anyway()
    b.add_running_pod(_running("r", WEB, "n0"))
    return b, pods[:1], 4


def _anti(sel, key="zone"):
    return PodAffinityTerm(topology_key=key, label_selector=sel, anti=True)


def _sc_anti_mutual():
    term = _anti({"app": "etcd"})
    return _zone_cluster(), [_pod(f"e{j}", {"app": "etcd"},
                                  pod_affinity=[term]) for j in range(4)], 5


def _sc_anti_multi_term():
    b = _nodes(SnapshotBuilder(max_nodes=4),
               [(f"n{i}", {"zone": z, "rack": r}, 64000) for i, (z, r) in
                enumerate([("z1", "r1"), ("z1", "r2"), ("z2", "r1"),
                           ("z2", "r2")])])
    b.add_running_pod(_running("db", {"app": "db"}, "n0"))
    b.add_running_pod(_running("cache", {"app": "cache"}, "n2"))
    terms = [_anti({"app": "db"}), _anti({"app": "cache"}, "rack")]
    return b, [_pod("p", pod_affinity=terms)], 4


def _sc_anti_overload():
    terms = [_anti({"app": f"a{t}"}, f"k{t}") for t in range(12)]
    return _zone_cluster(), [_pod("monster", pod_affinity=terms),
                             _pod("normal")], 2


def _sc_anti_other_app():
    b = _zone_cluster()
    b.add_running_pod(_running("noisy", {"app": "noisy"}, "n0"))
    term = _anti({"app": "noisy"})
    return b, [_pod(f"q{j}", {"app": "quiet"}, pod_affinity=[term])
               for j in range(3)], 4


def _sc_anti_heterogeneous():
    term = _anti({"app": "etcd"})
    pods = [_pod("w0", WEB, prio=9500, pod_affinity=[term])]
    pods += [_pod(f"e{j}", {"app": "etcd"}, pod_affinity=[term])
             for j in range(3)]
    return _zone_cluster(), pods, 5


def _sc_anti_same_batch_non_member():
    term = _anti({"app": "noisy"})
    pods = [_pod("noisy", {"app": "noisy"}, prio=9500)]
    pods += [_pod(f"q{j}", {"app": "quiet"}, pod_affinity=[term])
             for j in range(2)]
    return _zone_cluster(), pods, 5


def _sc_existing_anti_binds_incoming():
    b = _zone_cluster()
    b.add_running_pod(_running("etcd-0", {"app": "etcd"}, "n0",
                               pod_affinity=[_anti(WEB)]))
    return b, [_pod("web-0", WEB)], 4


def _sc_anti_keyless_admit():
    b = _nodes(SnapshotBuilder(max_nodes=2),
               [("z", {"zone": "z1"}, 300.0), ("keyless", {}, 64000)])
    term = _anti({"app": "e"})
    return b, [_pod(f"e{j}", {"app": "e"}, cpu=200.0, pod_affinity=[term])
               for j in range(2)], 4


def _sc_same_batch_carrier():
    term = _anti({"app": "noisy"})
    return _zone_cluster(zones=("z1",)), [
        _pod("quiet", {"app": "quiet"}, prio=9500, pod_affinity=[term]),
        _pod("noisy", {"app": "noisy"})], 4


def _sc_carrier_domains_only():
    b = _zone_cluster(zones=("z1", "z2"))
    b.add_running_pod(_running("etcd", {"app": "etcd"}, "n0",
                               pod_affinity=[_anti(WEB)]))
    b.add_running_pod(_running("web-old", WEB, "n1"))
    return b, [_pod("web-new", WEB)], 4


def _sc_irrelevant_anti_terms():
    b = _zone_cluster()
    for i in range(12):
        b.add_running_pod(_running(f"svc{i}", {"app": f"svc{i}"}, "n0",
                                   pod_affinity=[_anti({"app": f"svc{i}"})]))
    return b, [_pod("plain", WEB)], 4


def _sc_single_domain_cap():
    b = _nodes(SnapshotBuilder(max_nodes=2, max_spread_domains=1),
               [(f"n{i}", {"zone": "z1"}, 64000) for i in range(2)])
    term = _anti({"app": "e"})
    return b, [_pod(f"e{j}", {"app": "e"}, pod_affinity=[term])
               for j in range(2)], 3


def _sc_affinity_bootstrap():
    term = PodAffinityTerm(topology_key="zone",
                           label_selector={"group": "batch-job"})
    return _zone_cluster(), [_pod(f"m{j}", {"group": "batch-job"},
                                  pod_affinity=[term]) for j in range(4)], 6


def _sc_affinity_follows():
    b = _zone_cluster()
    b.add_running_pod(_running("db", {"app": "db"}, "n1"))
    term = PodAffinityTerm(topology_key="zone", label_selector={"app": "db"})
    return b, [_pod("web", WEB, pod_affinity=[term])], 4


def _sc_affinity_stuck_member():
    term = PodAffinityTerm(topology_key="zone", label_selector={"g": "job"})
    pods = [_pod("huge", {"g": "job"}, prio=9500, cpu=99000.0,
                 pod_affinity=[term])]
    pods += [_pod(f"s{j}", {"g": "job"}, cpu=500.0, pod_affinity=[term])
             for j in range(2)]
    return _zone_cluster(cpu=4000.0), pods, 5


SCENARIOS = {
    "spread_hard": _sc_spread_hard,
    "spread_impossible_skew": _sc_spread_impossible,
    "spread_unreachable_min": _sc_spread_unreachable_min,
    "schedule_anyway": _sc_schedule_anyway,
    "schedule_anyway_prefers_empty": _sc_schedule_anyway_prefers_empty,
    "anti_mutual": _sc_anti_mutual,
    "anti_multi_term": _sc_anti_multi_term,
    "anti_overload": _sc_anti_overload,
    "anti_other_app": _sc_anti_other_app,
    "anti_heterogeneous": _sc_anti_heterogeneous,
    "anti_same_batch_non_member": _sc_anti_same_batch_non_member,
    "anti_existing_binds_incoming": _sc_existing_anti_binds_incoming,
    "anti_keyless_admit": _sc_anti_keyless_admit,
    "anti_same_batch_carrier": _sc_same_batch_carrier,
    "anti_carrier_domains_only": _sc_carrier_domains_only,
    "anti_irrelevant_terms": _sc_irrelevant_anti_terms,
    "anti_single_domain_cap": _sc_single_domain_cap,
    "affinity_bootstrap": _sc_affinity_bootstrap,
    "affinity_follows": _sc_affinity_follows,
    "affinity_stuck_member": _sc_affinity_stuck_member,
}


def _expect(name, a):
    """The placements the reference's own tests assert."""
    if name == "spread_hard":
        assert (a >= 0).all() and (a != 3).all()
        z1 = int(np.isin(a, [0, 1]).sum()) + 1
        assert abs(z1 - int((a == 2).sum())) <= 1
    elif name == "spread_impossible_skew":
        assert (a == 0).sum() == 1 and (a == -1).sum() == 3
    elif name == "spread_unreachable_min":
        assert sorted(((a == 0).sum(), (a == 1).sum())) == [2, 2]
    elif name == "schedule_anyway":
        assert (a >= 0).all()
    elif name == "schedule_anyway_prefers_empty":
        assert a[0] == 2
    elif name == "anti_mutual":
        placed = a[a >= 0]
        assert len(placed) == 3 == len(set(placed.tolist()))
    elif name == "anti_multi_term":
        assert a[0] == 3
    elif name == "anti_overload":
        assert a[0] == -1 and a[1] >= 0
    elif name == "anti_other_app":
        assert (a >= 0).all() and (a != 0).all()
    elif name == "anti_heterogeneous":
        etcd = a[1:]
        placed = etcd[etcd >= 0]
        assert a[0] >= 0 and len(placed) == 2 == len(set(placed.tolist()))
        assert (placed != a[0]).all()
    elif name == "anti_same_batch_non_member":
        assert (a >= 0).all() and (a[1:] != a[0]).all()
    elif name == "anti_existing_binds_incoming":
        assert a[0] in (1, 2)
    elif name == "anti_keyless_admit":
        assert (a >= 0).all()
    elif name == "anti_same_batch_carrier":
        assert a.tolist() == [0, -1]
    elif name == "anti_carrier_domains_only":
        assert a[0] == 1
    elif name == "anti_irrelevant_terms":
        assert a[0] >= 0
    elif name == "anti_single_domain_cap":
        assert (a >= 0).sum() == 1
    elif name == "affinity_bootstrap":
        assert (a >= 0).all() and len(set(a.tolist())) == 1
    elif name == "affinity_follows":
        assert a[0] == 1
    elif name == "affinity_stuck_member":
        assert a[0] == -1 and (a[1:] >= 0).all() and a[1] == a[2]


def _both(snap, batch, **kw):
    want = jcore.schedule_batch(snap, batch, JCfg.make(), **kw)
    got = core.schedule_batch(to_port("ClusterSnapshot", snap),
                              to_port("PodBatch", batch),
                              LoadAwareConfig.make(device="cpu"), **kw)
    return want, got


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_topology_scenarios_equal_reference(name):
    """Each scenario of tests/test_scheduler_core.py through both
    packages with the reference's defaults (NUMA and DeviceShare on,
    the scenario's rounds): every result field and the post-batch
    snapshot equal, and the placements the reference's test asserts."""
    b, pods, rounds = SCENARIOS[name]()
    snap, ctx = b.build(now=NOW)
    want, got = _both(snap, b.build_pod_batch(pods, ctx), num_rounds=rounds)
    assert_results_equal(want, got)
    _expect(name, got.assignment.numpy())


def test_spread_counts_across_batches_equal_reference():
    """A second batch built after the first's assume sees it in its
    spread counts and spreads to the other zone, in both packages."""
    tsc = TSC(max_skew=1, topology_key="zone", label_selector=WEB)

    def builder():
        return _nodes(SnapshotBuilder(max_nodes=2),
                      [("n0", {"zone": "z1"}, 64000),
                       ("n1", {"zone": "z2"}, 64000)])

    member = [_pod(f"w{j}", WEB, spread_constraints=[tsc]) for j in range(2)]
    b = builder()
    snap, ctx = b.build(now=NOW)
    want1, got1 = _both(snap, b.build_pod_batch(member[:1], ctx))
    assert_results_equal(want1, got1)
    first = int(got1.assignment[0])
    b2 = builder()
    b2.add_assigned(member[0], f"n{first}", timestamp=NOW)
    snap2, ctx2 = b2.build(now=NOW)
    batch2 = b2.build_pod_batch(member[1:], ctx2)
    assert np.asarray(batch2.spread_count0).sum() == 1.0
    want2, got2 = _both(snap2, batch2)
    assert_results_equal(want2, got2)
    assert 0 <= int(got2.assignment[0]) != first


def test_anti_affinity_across_chunks_equal_reference():
    """tests/test_bench_mesh.py's cross-chunk rule: carriers of one anti
    group in two chunks land in four distinct zones when each chunk's
    count0 are the counts charged so far; the port's charges and
    placements equal the reference's chunk by chunk."""
    n_nodes, n_zones = 16, 4
    jsnap = jsyn.synthetic_cluster(n_nodes, seed=0)
    zone_of_node = (np.arange(n_nodes) % n_zones).astype(np.int32)

    def carriers(num):
        return jsyn.synthetic_pods(num, seed=3, prod_frac=1.0).replace(
            anti_id=np.zeros((num,), np.int32),
            anti_member=np.ones((num, 1), bool),
            anti_carrier=np.ones((num, 1), bool),
            anti_domain=zone_of_node[None, :].copy(),
            anti_count0=np.zeros((1, n_zones), np.float32),
            anti_carrier_count0=np.zeros((1, n_zones), np.float32),
            has_anti=True)

    kw = dict(num_rounds=2, k_choices=4, enable_numa=False)
    jcounts = (jnp.zeros((1, n_zones)), jnp.zeros((1, n_zones)))
    tsnap = to_port("ClusterSnapshot", jsnap)
    tcounts = (torch.zeros((1, n_zones)), torch.zeros((1, n_zones)))
    zones = []
    for _ in range(2):
        batch = carriers(2).replace(anti_count0=jcounts[0],
                                    anti_carrier_count0=jcounts[1])
        want = jcore.schedule_batch(jsnap, batch, JCfg.make(), **kw)
        tbatch = to_port("PodBatch", carriers(2)).replace(
            anti_count0=tcounts[0], anti_carrier_count0=tcounts[1])
        got = core.schedule_batch(tsnap, tbatch,
                                  LoadAwareConfig.make(device="cpu"), **kw)
        assert_results_equal(want, got)
        jsnap, tsnap = want.snapshot, got.snapshot
        jcounts = (
            jcore.charge_domain_counts(jcounts[0], batch.anti_domain,
                                       batch.anti_member, want.assignment),
            jcore.charge_domain_counts(jcounts[1], batch.anti_domain,
                                       batch.anti_carrier, want.assignment))
        tcounts = (
            domains.charge_domain_counts(tcounts[0], tbatch.anti_domain,
                                         tbatch.anti_member, got.assignment),
            domains.charge_domain_counts(tcounts[1], tbatch.anti_domain,
                                         tbatch.anti_carrier,
                                         got.assignment))
        for w, g in zip(jcounts, tcounts):
            assert g.numpy().tobytes() == np.asarray(w).tobytes()
        zones.extend(zone_of_node[got.assignment.numpy()].tolist())
    assert len(set(zones)) == 4 and float(tcounts[0].sum()) == 4.0


def _chunk1(make_nodes, pods, running=()):
    """Feed `pods` one a batch in priority order through both packages,
    rebuilding the builder so every assume feeds the next batch's
    counts; each batch's results equal. Returns the assignment."""
    order = sorted(range(len(pods)),
                   key=lambda i: (-(pods[i].priority or 0), i))
    assigned, got = [], np.full((len(pods),), -1, np.int64)
    for i in order:
        b = _nodes(SnapshotBuilder(max_nodes=len(make_nodes)), make_nodes)
        for p, node_name in running:
            b.add_running_pod(p)
        for p, node_name in assigned:
            b.add_assigned(p, node_name, timestamp=NOW)
        snap, ctx = b.build(now=NOW)
        want, res = _both(snap, b.build_pod_batch([pods[i]], ctx),
                          num_rounds=2)
        assert_results_equal(want, res)
        got[i] = int(res.assignment[0])
        if got[i] >= 0:
            assigned.append((pods[i], f"n{got[i]}"))
    return got


def test_chunk1_multi_spread_affinity_equal_reference():
    """Chunk-1 feeding with zone + hostname spread carried together,
    two-term affinity toward running pods and two-term self-affinity:
    every batch equal to the reference's; the two-term pods land in the
    intersection zone."""
    zones = ["z0", "z0", "z1", "z1", "z2", "z2"]
    racks = ["r0", "r1", "r0", "r1", "r0", "r1"]
    nodes = [(f"n{i}", {"zone": z, "rack": r, "host": f"n{i}"},
              8000.0 + i * 4000.0)
             for i, (z, r) in enumerate(zip(zones, racks))]
    spread = [TSC(max_skew=1, topology_key=key, label_selector=WEB)
              for key in ("zone", "host")]
    aff = [PodAffinityTerm(topology_key="zone", label_selector=sel)
           for sel in ({"tier": "db"}, {"app": "cache"})]
    duo = [PodAffinityTerm(topology_key=key, label_selector={"app": "duo"})
           for key in ("zone", "rack")]
    running = [(_running("db0", {"tier": "db"}, "n0"), "n0"),
               (_running("db1", {"tier": "db"}, "n2"), "n2"),
               (_running("cache0", {"app": "cache"}, "n3"), "n3")]
    pods = []
    for j in range(14):
        kw = dict(prio=9000 + (14 - j) * 13, cpu=650.0 + j * 37.0)
        if j % 4 in (0, 1):
            pods.append(_pod(f"w{j}", WEB, spread_constraints=spread, **kw))
        elif j % 4 == 2:
            pods.append(_pod(f"s{j}", {"app": "svc"}, pod_affinity=aff,
                             **kw))
        else:
            pods.append(_pod(f"d{j}", {"app": "duo"}, pod_affinity=duo,
                             **kw))
    got = _chunk1(nodes, pods, running)
    svc = [got[j] for j in range(14) if j % 4 == 2 and got[j] >= 0]
    assert svc and all(zones[a] == "z1" for a in svc)
    assert (got >= 0).sum() > 7


def test_chunk1_taints_spread_anti_equal_reference():
    """Chunk-1 feeding with a tainted node, zone spread, single- and
    two-term anti-affinity: every batch equal to the reference's."""
    zones = ["z0", "z0", "z1", "z1", "z2", "z2"]
    racks = ["r0", "r1", "r0", "r1", "r0", "r1"]
    ded = [Taint(key="ded", value="x", effect="NoSchedule")]
    nodes = [(f"n{i}", {"zone": z, "rack": r}, 8000.0 + i * 4000.0,
              ded if i == 1 else [])
             for i, (z, r) in enumerate(zip(zones, racks))]
    spread = TSC(max_skew=1, topology_key="zone", label_selector=WEB)
    anti = _anti({"app": "kv"})
    anti2 = _anti(WEB, "rack")
    tol = [Toleration(key="ded", value="x", effect="NoSchedule")]
    pods = []
    for j in range(12):
        kw = dict(prio=9000 + (12 - j) * 13, cpu=700.0 + j * 31.0)
        kind = j % 4
        if kind == 0:
            pods.append(_pod(f"w{j}", WEB, spread_constraints=[spread],
                             tolerations=tol if j % 8 else [], **kw))
        elif kind == 1:
            pods.append(_pod(f"k{j}", {"app": "kv"}, pod_affinity=[anti],
                             **kw))
        elif kind == 2:
            pods.append(_pod(f"m{j}", {"app": "kv"},
                             pod_affinity=[anti, anti2], **kw))
        else:
            pods.append(_pod(f"p{j}", {"app": "plain"}, tolerations=tol,
                             **kw))
    got = _chunk1(nodes, pods)
    kv = [got[j] for j in range(12) if j % 4 in (1, 2) and got[j] >= 0]
    assert len({zones[a] for a in kv}) == len(kv) > 0
