// DeviceShare arithmetic shared by kernels K5 (topology_admit), K6
// (device_pair_terms) and K7 (gpu_instance_pick): a GPU pod's
// per-instance request on a node and the instance fit, as
// koordinator_tpu/scheduler/plugins/deviceshare.py _per_instance and its
// fit tests compute them.
//
// Exactness against the reference (bit for bit; the sources that
// include this build with -fmad=false): every rounding is named. The
// reference's compiler turns its divisions by the constant 100 into
// multiplications by float32(0.01) (`kPct`); the other divisions are
// IEEE divisions (__fdiv_rn), and floorf is exact.

#pragma once

#include <stdint.h>

namespace koord_dev {

constexpr float kPct = 0.01f;  // x / 100 as the reference rounds it
constexpr int kDims = 3;       // core, memory, ratio

struct PerInst {
  int count;     // instances the pod takes, 0 without a GPU request
  float v[kDims];  // the request per instance
};

// The pod's GPU request (core, memory, memory ratio) on a node whose
// per-GPU memory is total_mem (devicehandler_gpu.go:54-90): a memory
// request converts to a ratio of that memory; a ratio above 100 that
// 100 divides is ratio / 100 whole instances, the request split evenly.
__device__ __forceinline__ PerInst per_instance(float total_mem, float core,
                                                float mem, float ratio) {
  const bool gpu = core > 0.0f || mem > 0.0f || ratio > 0.0f;
  const bool mem_specified = mem > 0.0f;
  const float safe_total = fmaxf(total_mem, 1.0f);
  const float ratio_eff =
      mem_specified
          ? floorf(__fmul_rn(__fdiv_rn(mem, safe_total), 100.0f))
          : ratio;
  const float mem_eff =
      mem_specified ? mem : floorf(__fmul_rn(__fmul_rn(ratio, total_mem), kPct));
  const bool multi = ratio_eff > 100.0f && fmodf(ratio_eff, 100.0f) == 0.0f;
  const float count = multi ? __fmul_rn(ratio_eff, kPct) : 1.0f;
  const float g = gpu ? 1.0f : 0.0f;
  PerInst out;
  out.count = gpu ? (int)count : 0;
  out.v[0] = __fmul_rn(floorf(__fdiv_rn(core, count)), g);
  out.v[1] = __fmul_rn(floorf(__fdiv_rn(mem_eff, count)), g);
  out.v[2] = __fmul_rn(floorf(__fdiv_rn(ratio_eff, count)), g);
  return out;
}

// An instance's free covers the per-instance request on every dim.
__device__ __forceinline__ bool covers(const float* free3, const float* per,
                                       float eps) {
  return __fadd_rn(free3[0], eps) >= per[0] &&
         __fadd_rn(free3[1], eps) >= per[1] &&
         __fadd_rn(free3[2], eps) >= per[2];
}

}  // namespace koord_dev
