// The X-stencil cost's arithmetic, shared by cost_volume.cu (K1) and
// volume_build.cu (K4) so that both compute every cost with the same
// roundings:
//   e(y, x)   = alpha*|L(y,x) - R(y,x')| + (1-alpha)*|GL(y,x) - GR(y,x')|,
//               x' = x - d, or column 0 where x < d; one FMA, as XLA's CPU
//               backend computes it;
//   C(y,x,d)  = e(y,x) + e(y-1,x-1) + e(y-1,x+1) + e(y+1,x-1) + e(y+1,x+1),
//               neighbours edge-clamped, __fadd_rn in that (STENCIL) order;
//   the cast to the output type rounds to nearest.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

static __device__ __forceinline__ float e_term(const float* __restrict__ iml,
                                        const float* __restrict__ imr,
                                        const float* __restrict__ gl,
                                        const float* __restrict__ gr,
                                        int W, int y, int x, int d,
                                        float alpha, float beta) {
  const int xr = x >= d ? x - d : 0;
  const int i = y * W + x;
  const int j = y * W + xr;
  const float a = fabsf(__fsub_rn(iml[i], imr[j]));
  const float g = fabsf(__fsub_rn(gl[i], gr[j]));
  return __fmaf_rn(alpha, a, __fmul_rn(beta, g));
}

// The 5-tap sum of e-terms given in STENCIL order: centre, (-1,-1),
// (-1,+1), (+1,-1), (+1,+1).
static __device__ __forceinline__ float stencil_sum(float c, float mm, float mp, float pm, float pp) {
  float acc = c;
  acc = __fadd_rn(acc, mm);
  acc = __fadd_rn(acc, mp);
  acc = __fadd_rn(acc, pm);
  acc = __fadd_rn(acc, pp);
  return acc;
}

static __device__ __forceinline__ void store(float* out, long long t, float v) { out[t] = v; }

static __device__ __forceinline__ void store(__nv_bfloat16* out, long long t, float v) {
  out[t] = __float2bfloat16_rn(v);
}
