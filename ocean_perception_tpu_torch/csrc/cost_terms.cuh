// The X-stencil cost's arithmetic and its shared tile stage, shared by
// cost_volume.cu (K1) and volume_build.cu (K4) so that both compute every
// cost with the same roundings:
//   e(y, x)   = alpha*|L(y,x) - R(y,x')| + (1-alpha)*|GL(y,x) - GR(y,x')|,
//               x' = x - d, or column 0 where x < d; one FMA, as XLA's CPU
//               backend computes it;
//   C(y,x,d)  = e(y,x) + e(y-1,x-1) + e(y-1,x+1) + e(y+1,x-1) + e(y+1,x+1),
//               neighbours edge-clamped, __fadd_rn in that (STENCIL) order;
//   the cast to the output type rounds to nearest.
//
// The tile stage: a block that owns the pixels y0 .. y0+TY-1, x0 .. x0+TX-1
// and the disparities [d_lo, d_hi) stages in shared memory rows y0-1 ..
// y0+TY of L and GL at columns x0-1 .. x0+TX (each edge-clamped), and the
// same rows of R and GR at columns x0-d_hi .. x0+TX-d_lo (clamped, so a
// column left of 0 holds column 0). R(y, x - d) of a staged pixel column x
// and a disparity of the tile is then at staged column x - d - (x0 - d_hi),
// never below 0; where x - d < 0 the clamp put column 0 there, which is x'
// of the cost. An edge-clamped neighbour is the clamped pixel itself, so its
// e-term repeats that pixel's: column -1 and row -1 stage as column and row
// 0, so they give that pixel's e-term as they stand; a row below H - 1
// stages as row H - 1 and does too; a column right of W - 1 does not (its R
// is not clamped the same way), so r_index clamps the column first, and
// K1's row sweep carries column W - 1's e-terms instead.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

static __device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// One e-term from its four samples.
static __device__ __forceinline__ float e_value(float l, float r, float gl, float gr,
                                                float alpha, float beta) {
  return __fmaf_rn(alpha, fabsf(__fsub_rn(l, r)), __fmul_rn(beta, fabsf(__fsub_rn(gl, gr))));
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

// Eight costs as one 16-byte vector of bf16 at out (16-byte aligned).
static __device__ __forceinline__ void store8(__nv_bfloat16* out, const float* v) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1]));
    w[k] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(out) = u;
}

// Eight float32 costs as two 16-byte vectors at out (16-byte aligned).
static __device__ __forceinline__ void store8(float* out, const float* v) {
  reinterpret_cast<float4*>(out)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(out)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Let kernel take `bytes` of dynamic shared memory (above the default 48 KB),
// with the SM's unified memory split for the most shared memory, so that as
// many blocks fit an SM as their shared memory allows; once per device:
// `done` is the caller's static flag array, so a launch captured into a
// CUDA graph finds the attributes already set.
template <typename Kernel>
static cudaError_t allow_shared(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// Shared-memory images of one tile (see the header comment). rows = TY + 2,
// cols = TX + 2, rw = TX + (d_hi - d_lo) + 1.
struct CostTile {
  float* l;   // [rows][cols]
  float* gl;  // [rows][cols]
  float* r;   // [rows][rw]
  float* gr;  // [rows][rw]
  int rows, cols, rw;
  int x0, d_hi, W;

  // Floats of shared memory the four images take.
  static constexpr __host__ __device__ int floats(int TY, int TX, int dspan) {
    return 2 * (TY + 2) * (TX + 2) + 2 * (TY + 2) * (TX + dspan + 1);
  }

  // Carve the images from smem, then load them; the caller syncs after.
  __device__ void stage(float* smem, const float* __restrict__ iml, const float* __restrict__ imr,
                        const float* __restrict__ gl_, const float* __restrict__ gr_, int H,
                        int W_, int y0, int x0_, int TY, int TX, int d_lo, int d_hi_) {
    rows = TY + 2;
    cols = TX + 2;
    rw = TX + (d_hi_ - d_lo) + 1;
    x0 = x0_;
    d_hi = d_hi_;
    W = W_;
    l = smem;
    gl = l + rows * cols;
    r = gl + rows * cols;
    gr = r + rows * rw;
    const int tid = threadIdx.x, n = blockDim.x;
    for (int k = tid; k < rows * cols; k += n) {
      const int y = clampi(y0 - 1 + k / cols, 0, H - 1), x = clampi(x0 - 1 + k % cols, 0, W - 1);
      l[k] = iml[y * W + x];
      gl[k] = gl_[y * W + x];
    }
    for (int k = tid; k < rows * rw; k += n) {
      const int y = clampi(y0 - 1 + k / rw, 0, H - 1);
      const int x = clampi(x0 - d_hi + k % rw, 0, W - 1);
      r[k] = imr[y * W + x];
      gr[k] = gr_[y * W + x];
    }
  }

  // Index into r and gr of R(y, x), for staged row rr, staged column c
  // (pixel y0-1+rr, x0-1+c, both clamped): R(y, x - d) is at that index
  // minus d for every d in [d_lo, d_hi).
  __device__ __forceinline__ int r_index(int rr, int c) const {
    return rr * rw + clampi(x0 - 1 + c, 0, W - 1) - (x0 - d_hi);
  }

  // e-term of staged row rr, staged column c at disparity d.
  __device__ __forceinline__ float e(int rr, int c, int d, float alpha, float beta) const {
    const int i = rr * cols + c, k = r_index(rr, c) - d;
    return e_value(l[i], r[k], gl[i], gr[k], alpha, beta);
  }
};
