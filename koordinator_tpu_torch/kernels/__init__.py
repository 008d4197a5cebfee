"""The port's hand-written CUDA kernels: wrappers, plain versions and
launch counts.

Each kernel module holds a wrapper (checks device, dtype, shape and
contiguity, allocates its outputs, launches on the current stream and
adds one to its launch count), and beside it the plain PyTorch version
of the same function. A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict

def _wrappers():
    from koordinator_tpu_torch.kernels import (
        aux_instances,
        delta_rows,
        device_terms,
        guard,
        gpu_instances,
        lownodeload,
        node_overcommit,
        numa_terms,
        quota_runtime,
        scatter,
        score_topk,
        segment_prefix,
        stage1,
        topology,
        topology_prefix,
    )
    return {"score_topk": score_topk.score_topk,
            "segment_prefix_ok": segment_prefix.segment_prefix_chain,
            "order_switch": segment_prefix.exact_in_any_order,
            "ordered_scatter_add": scatter.ordered_scatter_add,
            "numa_pair_terms": numa_terms.numa_pair_terms,
            "topology_admit": topology.topology_admit,
            "device_pair_terms": device_terms.device_pair_terms,
            "gpu_instance_pick": gpu_instances.gpu_instance_pick,
            "topology_prefix_gate": topology_prefix.topology_prefix_gate,
            "stage1_mask": stage1.stage1_mask,
            "lnl_node_fit": lownodeload.lnl_node_fit,
            "lnl_eviction_order": lownodeload.lnl_eviction_order,
            "lnl_plan_prefix": lownodeload.lnl_plan_prefix,
            "lnl_plan_capped": lownodeload.lnl_plan_capped,
            "guard_nodes": guard.guard_nodes,
            "guard_pods": guard.guard_pods,
            "delta_rows": delta_rows.delta_rows,
            "aux_instance_pick": aux_instances.aux_instance_pick,
            "quota_runtime": quota_runtime.quota_runtime,
            "node_overcommit": node_overcommit.node_overcommit}


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
