"""The port's DeviceShare plugin (scheduler/plugins/deviceshare.py) and
the plain versions of kernels K6 (`device_pair_terms`) and K7
(`gpu_instance_pick`) against the JAX package's deviceshare module and
the GPU block of its schedule_batch (core.py:962-1016).

Inputs are made with numpy from a seed: nodes with odd per-GPU memory,
invalid instances and instances of zone -1, partly used instances;
pods with memory-specified requests of odd MiB, ratio-only requests,
ratios 100 does not divide and multi-GPU ratios. Tolerances: none;
integer and bool outputs exactly, floats bit for bit."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.api.extension import ResourceKind as RK
from koordinator_tpu.scheduler.batching import segment_prefix_ok as jgate
from koordinator_tpu.scheduler.plugins import deviceshare as jds
from koordinator_tpu.utils import synthetic as jsyn
from koordinator_tpu_torch.kernels.device_terms import device_pair_terms
from koordinator_tpu_torch.kernels.gpu_instances import gpu_instance_pick
from koordinator_tpu_torch.scheduler.batching import (
    EPS,
    segment_prefix_chain,
)
from koordinator_tpu_torch.scheduler.plugins import deviceshare

from torch_port_ref import to_port
from torch_port_ref import one_torch_thread  # noqa: F401 (autouse)

SEEDS = [0, 1, 2]
STRATEGIES = ["least", "most"]
# (seed, instances a node): 8 GPUs in 3 and in 7 MIG slices (fault C8's
# widths: past one 32-bit word a node)
WIDE = [(0, 24), (1, 56)]
WIDE_IDS = [f"seed{s}-I{i}" for s, i in WIDE]


def device_case(seed, n=40, i=8):
    """The JAX package's DeviceState: about 70 % GPU nodes with i
    instances, a third of them with an odd per-GPU memory, about 10 % of
    the instances invalid and 10 % of zone -1, the free of each instance
    an integer share of its total (half of them untouched)."""
    rng = np.random.default_rng(seed + 50)
    dev = jsyn.synthetic_cluster(n, seed=seed, gpu_node_frac=0.7,
                                 gpus_per_node=i).devices
    total = np.array(dev.gpu_total)
    total[::3, 1] = np.where(total[::3, 1] > 0, 40007.0, 0.0)
    full = np.broadcast_to(total[:, None, :], (n, i, 3))
    free = np.floor(full * rng.uniform(0, 1, (n, i, 1)))
    untouched = rng.uniform(size=(n, i)) < 0.5
    free[untouched] = full[untouched]
    valid = np.array(dev.gpu_valid) & (rng.uniform(size=(n, i)) < 0.9)
    numa = np.array(dev.gpu_numa)
    numa[rng.uniform(size=(n, i)) < 0.1] = -1
    return dev.replace(gpu_total=jnp.asarray(total),
                       gpu_free=jnp.asarray(free.astype(np.float32)),
                       gpu_valid=jnp.asarray(valid),
                       gpu_numa=jnp.asarray(numa))


def pod_case(seed, p=200):
    """The JAX package's PodBatch: 60 % GPU pods (ratios 50..400), a
    quarter of all pods asking for GPU memory in odd MiB, some for a
    ratio 100 does not divide (150, 250, 333) or a larger multiple (300,
    800), some with an odd core request, a few with an RDMA request."""
    rng = np.random.default_rng(seed + 60)
    pods = jsyn.synthetic_pods(p, seed=seed, gpu_pod_frac=0.6)
    req = np.array(pods.requests)
    ratio = np.array(pods.gpu_ratio)
    mem = rng.uniform(size=p) < 0.25
    req[mem, int(RK.GPU_MEMORY)] = rng.integers(1, 90_000, int(mem.sum()))
    odd = rng.uniform(size=p) < 0.15
    ratio[odd] = rng.choice([150.0, 250.0, 300.0, 333.0, 800.0],
                            int(odd.sum()))
    req[rng.uniform(size=p) < 0.1, int(RK.GPU_CORE)] = 37.0
    req[rng.uniform(size=p) < 0.05, int(RK.RDMA)] = 1.0
    return pods.replace(requests=jnp.asarray(req),
                        gpu_ratio=jnp.asarray(ratio.astype(np.float32)))


# GPU requests (core, memory MiB, memory ratio) of every weight sum and
# instance count K6 branches on: core only (w 1), ratio only and memory
# only (w 2), core and ratio (w 3), ratios 200, 300 and 800 (count 2, 3,
# 8), 150 (not a multiple: count 1)
K6_REQUESTS = np.array([[37, 0, 0], [0, 0, 50], [0, 30_000, 0], [50, 0, 50],
                        [200, 0, 200], [300, 0, 300], [800, 0, 800],
                        [0, 0, 150]], np.float32)


def with_kind(seed, dev, pods, kind):
    """The state of one case K6's design branches on (csrc/
    device_terms.cu): "no-gpu-pod" (no pod asks for a GPU),
    "every-gpu-pod" (every pod asks, K6_REQUESTS in turn),
    "two-memories-and-none" (nodes of 80 GB and 40 GB per GPU and nodes
    without a GPU in turn, so that every span of 32 nodes mixes them;
    half the pods ask, K6_REQUESTS in turn); else as it is."""
    rng = np.random.default_rng(seed + 80)
    p = pods.requests.shape[0]
    req, ratio = np.array(pods.requests), np.array(pods.gpu_ratio)
    table = K6_REQUESTS[np.arange(p) % len(K6_REQUESTS)]
    if kind == "two-memories-and-none":
        table = np.where((rng.uniform(size=p) < 0.5)[:, None], table, 0.0)
        n, i = dev.gpu_free.shape[:2]
        mem = np.array([81_920.0, 40_960.0, 0.0], np.float32)[np.arange(n)
                                                             % 3]
        hundred = np.where(mem > 0, 100.0, 0.0)
        total = np.stack([hundred, mem, hundred], axis=1).astype(np.float32)
        full = np.broadcast_to(total[:, None, :], (n, i, 3))
        free = np.floor(full * rng.uniform(0, 1, (n, i, 1)))
        untouched = rng.uniform(size=(n, i)) < 0.5
        free[untouched] = full[untouched]
        dev = dev.replace(
            gpu_total=jnp.asarray(total),
            gpu_free=jnp.asarray(free.astype(np.float32)),
            gpu_valid=jnp.asarray((mem > 0)[:, None]
                                  & (rng.uniform(size=(n, i)) < 0.9)))
    elif kind == "no-gpu-pod":
        table = np.zeros_like(table)
    elif kind != "every-gpu-pod":
        return dev, pods
    req[:, int(RK.GPU_CORE)] = table[:, 0]
    req[:, int(RK.GPU_MEMORY)] = table[:, 1]
    ratio = table[:, 2]
    return dev, pods.replace(requests=jnp.asarray(req),
                             gpu_ratio=jnp.asarray(ratio))


@functools.lru_cache(maxsize=None)
def _case(seed, i=8, kind="plain"):
    dev, pods = with_kind(seed, device_case(seed, i=i), pod_case(seed), kind)
    tdev, tpods = to_port("DeviceState", dev), to_port("PodBatch", pods)
    return dev, pods, tdev, tpods, deviceshare.gpu_request(tpods.requests,
                                                           tpods.gpu_ratio)


def _same(got, want, name=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype)
    assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("seed", SEEDS)
def test_per_instance_at_equal_reference(seed):
    """Count and per-instance request at each pod's node, node indices
    out of range (-1 and N: clamped) included."""
    dev, pods, tdev, _, gpu_req = _case(seed)
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, 42, pods.requests.shape[0]).astype(np.int32)
    want = jax.jit(jds.per_instance_at)(dev, pods, idx)
    got = deviceshare.per_instance_at(tdev, gpu_req, torch.from_numpy(idx))
    for g, w, name in zip(got, want, ("count", "per_inst")):
        _same(g, w, name)
    count = np.asarray(want[0])
    assert (count == 0).any() and (count == 1).any() and (count > 1).any()
    # memory-specified requests on nodes of odd per-GPU memory
    assert (np.asarray(want[1])[:, 2] % 1 == 0).all()


def test_per_instance_scenarios_of_the_reference():
    """The per-instance cases of tests/test_deviceshare.py: shared,
    multi-GPU, memory-specified, a ratio 100 does not divide."""
    dev = to_port("DeviceState", jsyn.synthetic_cluster(
        1, gpu_node_frac=1.0, gpus_per_node=4,
        gpu_memory_mib=1000.0).devices)
    cases = (((50, 0, 50), 1, [50, 500, 50]),
             ((400, 0, 400), 4, [100, 1000, 100]),
             ((50, 250, 0), 1, [50, 250, 25]),
             ((0, 0, 150), 1, [0, 150 * 10, 150]))
    for req, count, per in cases:
        c, pi = deviceshare.per_instance_at(
            dev, torch.tensor([req], dtype=torch.float32),
            torch.zeros(1, dtype=torch.int32))
        assert int(c[0]) == count and pi[0].tolist() == per


@pytest.mark.parametrize("seed", SEEDS)
def test_prefilter_and_k6_gate_equal_reference(seed):
    """The [P, N] prefilter (an RDMA request on a snapshot without aux
    pools passes nowhere), and K6's gate, its GPU part (the pods' aux
    requests left to the factored device term), ANDed into a given pair
    mask."""
    dev, pods, tdev, tpods, gpu_req = _case(seed)
    want = np.asarray(jax.jit(jds.prefilter)(dev, pods))
    _same(deviceshare.prefilter(tdev, tpods), want)
    no_aux = np.array(pods.requests)
    no_aux[:, int(RK.RDMA)] = 0.0
    want_gpu = np.asarray(jax.jit(jds.prefilter)(
        dev, pods.replace(requests=jnp.asarray(no_aux))))
    ok, _ = device_pair_terms(gpu_req, tdev, "least")
    _same(ok, want_gpu)
    mask = torch.from_numpy(np.random.default_rng(seed).uniform(
        size=want.shape) < 0.7)
    ok2, _ = device_pair_terms(gpu_req, tdev, "least", pair_ok=mask)
    _same(ok2, want_gpu & mask.numpy())
    assert not want_gpu.all() and want_gpu.any() and not np.array_equal(
        want, want_gpu)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", SEEDS)
def test_score_matrix_and_k6_score_equal_reference(seed, strategy):
    dev, pods, tdev, tpods, gpu_req = _case(seed)
    want = np.asarray(jax.jit(jds.score_matrix, static_argnums=2)(
        dev, pods, strategy))
    _same(deviceshare.score_matrix(tdev, tpods, strategy), want)
    _, score = device_pair_terms(gpu_req, tdev, strategy)
    _same(score, want)
    gpu = np.asarray(jds.has_gpu_request(pods))
    assert (want[~gpu] == 0).all() and (want[gpu] > 0).any()
    assert ((want[gpu] % 1) != 0).any()   # fractional scores


# (seed, instances a node, kind): fault C8's widths, then the cases K6's
# design branches on (`with_kind`; "prefix-of-mask": the first half of
# the pods ANDed into a mask of all of them)
K6_CASES = [(s, i, "plain") for s, i in WIDE] + [
    (0, 8, "no-gpu-pod"), (1, 8, "every-gpu-pod"),
    (2, 8, "two-memories-and-none"), (0, 8, "prefix-of-mask")]
K6_IDS = WIDE_IDS + [f"seed{s}-I{i}-{k}" for s, i, k in K6_CASES[len(WIDE):]]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed,i,kind", K6_CASES, ids=K6_IDS)
def test_k6_at_mig_widths_equals_reference(seed, i, kind, strategy):
    """K6's gate (its GPU part, ANDed into a pair mask) and its pool
    score at 24 and 56 instances a node, and at 8 in the cases its
    design branches on, against the reference's prefilter and score
    matrix; the mask's rows beyond a prefix stay as they are."""
    dev, pods, tdev, _, gpu_req = _case(seed, i, kind)
    no_aux = np.array(pods.requests)
    no_aux[:, int(RK.RDMA)] = 0.0
    want_gpu = np.asarray(jax.jit(jds.prefilter)(
        dev, pods.replace(requests=jnp.asarray(no_aux))))
    want_score = np.asarray(jax.jit(jds.score_matrix, static_argnums=2)(
        dev, pods, strategy))
    mask = torch.from_numpy(np.random.default_rng(seed).uniform(
        size=want_gpu.shape) < 0.7)
    rows = gpu_req.shape[0] // 2 if kind == "prefix-of-mask" else None
    ok, score = device_pair_terms(gpu_req[:rows], tdev, strategy,
                                  pair_ok=mask)
    want_ok = mask.numpy().copy()
    want_ok[:rows] &= want_gpu[:rows]
    _same(ok, want_ok, "pair_ok")
    _same(score, want_score[:rows], "pair_score")
    gpu = np.asarray(jds.has_gpu_request(pods))
    if kind == "no-gpu-pod":
        assert want_gpu.all() and not want_score.any() and not gpu.any()
    else:
        assert not want_gpu.all() and want_gpu.any()
    if kind in ("every-gpu-pod", "two-memories-and-none"):
        count, _ = jax.jit(jds.per_instance_at)(
            dev, pods, np.zeros(gpu.shape[0], np.int32))
        assert (np.asarray(count) > 1).any() and ((want_score > 0)
                                                  & (want_score < 100)).any()


def _step_inputs(seed, dev, p):
    """One inner step's chosen nodes (half on 6 popular nodes, a few out
    of range), an affinity over two zones, engaged pods, and an
    exclude mask."""
    rng = np.random.default_rng(seed + 70)
    n = dev.gpu_total.shape[0]
    i = dev.gpu_free.shape[1]
    choice = np.where(rng.uniform(size=p) < 0.5, rng.integers(0, 6, p),
                      rng.integers(0, n + 1, p)).astype(np.int32)
    zone_mask = rng.uniform(size=(p, 2)) < 0.6
    engaged = rng.uniform(size=p) < 0.5
    exclude = rng.uniform(size=(p, i)) < 0.15
    return choice, zone_mask, engaged, exclude


@pytest.mark.parametrize("n_zones", [1, 2, 4])
@pytest.mark.parametrize("seed", SEEDS)
def test_gpu_zone_counts_equal_reference(seed, n_zones):
    dev, pods, tdev, _, gpu_req = _case(seed)
    choice, *_ = _step_inputs(seed, dev, pods.requests.shape[0])
    _, per = jds.per_instance_at(dev, pods, choice)
    want = jax.jit(jds.gpu_zone_counts, static_argnums=4)(
        dev.gpu_free, dev, choice, per, n_zones)
    _, tper = deviceshare.per_instance_at(tdev, gpu_req,
                                          torch.from_numpy(choice))
    got = deviceshare.gpu_zone_counts(tdev.gpu_free, tdev,
                                      torch.from_numpy(choice), tper, n_zones)
    _same(got, want)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", SEEDS)
def test_choose_gpu_instance_equal_reference(seed, strategy):
    """Shared pods on their chosen node: engaged pods (restricted to
    their affinity, zone -1 outside it) and pods not engaged; ties
    (untouched instances) go to the first index."""
    dev, pods, tdev, _, gpu_req = _case(seed)
    p = pods.requests.shape[0]
    choice, zone_mask, engaged, _ = _step_inputs(seed, dev, p)
    count, per = jds.per_instance_at(dev, pods, choice)
    shared = np.asarray(count) == 1
    want = jax.jit(jds.choose_gpu_instance, static_argnums=7)(
        dev.gpu_free, dev, choice, per, shared, zone_mask, engaged, strategy)
    t = [torch.from_numpy(x) for x in (choice, shared, zone_mask, engaged)]
    _, tper = deviceshare.per_instance_at(tdev, gpu_req, t[0])
    got = deviceshare.choose_gpu_instance(tdev.gpu_free, tdev, t[0], tper,
                                          t[1], t[2], t[3], strategy)
    for g, w, name in zip(got, want, ("inst", "ok")):
        _same(g, w, name)
    ok, inst = np.asarray(want[1]), np.asarray(want[0])
    assert (~ok).any() and (inst[shared & ok] > 0).any()


@pytest.mark.parametrize("seed", SEEDS)
def test_full_fit_instances_equal_reference(seed):
    """Multi-GPU pods' whole instances with an exclude mask and without,
    engaged and not."""
    dev, pods, tdev, _, gpu_req = _case(seed)
    p = pods.requests.shape[0]
    choice, zone_mask, engaged, exclude = _step_inputs(seed, dev, p)
    count, per = jds.per_instance_at(dev, pods, choice)
    t = [torch.from_numpy(x) for x in (choice, zone_mask, engaged, exclude)]
    tcount, tper = deviceshare.per_instance_at(tdev, gpu_req, t[0])
    for excl, texcl in ((exclude, t[3]), (None, None)):
        want = jax.jit(jds.full_fit_instances)(
            dev.gpu_free, dev, choice, per, count, zone_mask, engaged, excl)
        got = deviceshare.full_fit_instances(tdev.gpu_free, tdev, t[0], tper,
                                             tcount, t[1], t[2], texcl)
        for g, w, name in zip(got, want, ("take", "enough")):
            _same(g, w, name)
    multi = np.asarray(count) > 1
    enough = np.asarray(want[1])
    assert enough[multi].any() and (~enough[multi]).any()


@functools.partial(jax.jit, static_argnames=("strategy", "numa"))
def reference_gpu_block(gpu_free, devices, pods, choice_eff, accept, rank,
                        affinity, engaged, *, strategy, numa):
    """The GPU instance gates of the reference's inner step
    (core.py:898-906, :962-1016) and the take they commit (:1085-1090),
    restated for one call without slots or prefixes: (accept, take)."""
    n, n_inst = devices.gpu_valid.shape
    earlier = rank[None, :] < rank[:, None]
    g_count, g_per = jds.per_instance_at(devices, pods, choice_eff)
    shared, multi = g_count == 1, g_count > 1
    if numa:
        zone_mask, dev_engaged = affinity, engaged
    else:
        zone_mask = jnp.ones((choice_eff.shape[0], 1), bool)
        dev_engaged = jnp.zeros_like(engaged)
    inst, inst_ok = jds.choose_gpu_instance(
        gpu_free, devices, choice_eff, g_per, shared, zone_mask, dev_engaged,
        strategy)
    acc = accept & (~shared | inst_ok)
    gseg = jnp.where(acc & shared, choice_eff * n_inst + inst, n * n_inst)
    flat = gpu_free.reshape(-1, 3)
    acc &= jgate(gseg, earlier, g_per * (acc & shared)[:, None],
                 jnp.zeros_like(flat), flat, n * n_inst)
    took_shared = acc & shared
    taken = jnp.zeros((n * n_inst + 1,), bool).at[
        jnp.where(took_shared, choice_eff * n_inst + inst, n * n_inst)].set(
            True)[:-1]
    nc = jnp.clip(choice_eff, 0, n - 1)
    take, enough = jds.full_fit_instances(
        gpu_free, devices, choice_eff, g_per, g_count, zone_mask,
        dev_engaged, exclude=taken.reshape(n, n_inst)[nc])
    same_node = choice_eff[:, None] == choice_eff[None, :]
    first_multi = ~jnp.any(earlier & same_node & (multi & acc)[None, :],
                           axis=-1)
    acc = jnp.where(multi, acc & first_multi & enough, acc)
    onehot = jnp.arange(n_inst)[None, :] == inst[:, None]
    return acc, ((onehot & (acc & shared)[:, None])
                 | (take & (acc & multi)[:, None]))


def _k7_step_equals_reference(seed, strategy, numa, i=8):
    """K7's two launches around the K2 gate (plain versions) against the
    reference's GPU block on `_case(seed, i)`; returns (choose result,
    take result, the admitted pods, the reference's accept)."""
    dev, pods, tdev, _, gpu_req = _case(seed, i)
    p = pods.requests.shape[0]
    n, n_inst = dev.gpu_valid.shape
    choice, zone_mask, engaged, _ = _step_inputs(seed, dev, p)
    rng = np.random.default_rng(seed + 80)
    accept = (rng.uniform(size=p) < 0.8) & (choice < n)
    rank = rng.permutation(p).astype(np.int32)
    want = reference_gpu_block(dev.gpu_free, dev, pods, choice, accept, rank,
                               zone_mask, engaged & accept, strategy=strategy,
                               numa=numa)
    t = {k: torch.from_numpy(v) for k, v in dict(
        choice=choice, accept=accept, rank=rank, zone=zone_mask,
        engaged=engaged & accept).items()}
    zone = (t["zone"], t["engaged"]) if numa else (None, None)
    pick = gpu_instance_pick(t["choice"], t["accept"], gpu_req, tdev, *zone,
                             strategy)
    gate_base = torch.zeros((n * n_inst, 3))
    one_pod = torch.zeros((n, 3))
    one_pod[:, 0] = 1.0
    alive = segment_prefix_chain(
        pick.seg, t["rank"], pick.req, pick.gate_active,
        [(gate_base, tdev.gpu_free.view(n * n_inst, 3), n * n_inst),
         (gate_base[:n], one_pod, n)], EPS)
    fin = gpu_instance_pick(t["choice"], alive, gpu_req, tdev, *zone,
                            strategy, chosen=pick)
    _same(fin.accept, want[0], "accept")
    _same(fin.take, want[1], "take")
    return pick, fin, accept, np.asarray(want[0])


@pytest.mark.parametrize("numa", [True, False], ids=["numa", "no-numa"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", SEEDS)
def test_k7_step_equals_reference_gpu_block(seed, strategy, numa):
    """K7's two launches around the K2 gate (plain versions) against the
    reference's GPU block: contended nodes (shared pods competing for an
    instance, several multi-GPU pods on one node), pods the earlier
    gates rejected and pods without a choice (index N)."""
    pick, _, accept, acc = _k7_step_equals_reference(seed, strategy, numa)
    count = pick.count.numpy()
    # shared pods lost to the instance gate and multi-GPU pods to the
    # one-a-node rule or to too few instances; some of both took
    assert (accept & ~acc & (count == 1)).any()
    assert (accept & ~acc & (count > 1)).any()
    assert (acc & (count > 1)).any() and (acc & (count == 1)).any()


@pytest.mark.parametrize("numa", [True, False], ids=["numa", "no-numa"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed,i", WIDE, ids=WIDE_IDS)
def test_k7_step_at_mig_widths_equals_reference_gpu_block(seed, i, strategy,
                                                          numa):
    """The same step at 24 and 56 instances a node: shared pods choosing
    ("most": the least free core that fits) instances past the 32nd,
    and the one-a-node rule still biting."""
    pick, _, accept, acc = _k7_step_equals_reference(seed, strategy, numa, i)
    count = pick.count.numpy()
    assert (acc & (count > 1)).any() and (acc & (count == 1)).any()
    assert (accept & ~acc & (count > 1)).any()
    if i > 32 and strategy == "most":
        assert (pick.inst.numpy()[acc & (count == 1)] >= 32).any()


def test_wrappers_check_their_inputs():
    dev, pods, tdev, _, gpu_req = _case(0)
    p = gpu_req.shape[0]
    choice = torch.zeros(p, dtype=torch.int32)
    active = torch.ones(p, dtype=torch.bool)
    with pytest.raises(ValueError, match="strategy"):
        device_pair_terms(gpu_req, tdev, "spread")
    with pytest.raises(TypeError, match="gpu_req"):
        device_pair_terms(gpu_req.double(), tdev, "least")
    with pytest.raises(ValueError, match="pair_ok"):
        device_pair_terms(gpu_req, tdev, "least",
                          pair_ok=torch.ones((p, 3), dtype=torch.bool))
    with pytest.raises(ValueError, match="go together"):
        gpu_instance_pick(choice, active, gpu_req, tdev,
                          torch.ones((p, 2), dtype=torch.bool), None, "least")
    with pytest.raises(TypeError, match="choice"):
        gpu_instance_pick(choice.long(), active, gpu_req, tdev, None, None,
                          "least")
    pick = gpu_instance_pick(choice, active, gpu_req, tdev, None, None,
                             "most")
    assert pick.seg.shape == (2, p) and pick.req.shape == (2, p, 3)
    with pytest.raises(ValueError, match="inst"):
        gpu_instance_pick(choice, active, gpu_req, tdev, None, None, "most",
                          chosen=pick._replace(inst=pick.inst[:1]))
