// Matching-cost volume for Hopper (sm_90a).
//
// Replaces: ocean_perception_tpu/ops/pallas/cost_volume.py::pallas_cost_volume
// (body _cost_kernel), with the border semantics of the path that production
// runs, ocean_perception_tpu/stereo/cost.py::cost_volume:
//   e(y, x)   = alpha*|L(y,x) - R(y,x')| + (1-alpha)*|GL(y,x) - GR(y,x')|,
//               x' = x - d, or column 0 where x < d;
//   C(y,x,d)  = e(y,x) + e(y-1,x-1) + e(y-1,x+1) + e(y+1,x-1) + e(y+1,x+1),
//               neighbours edge-clamped, summed in that (STENCIL) order in
//               float32, then cast to the output type.
// Every rounding is pinned with an intrinsic so that nvcc's default
// contraction cannot change a bit: the e-term is one FMA (what XLA's CPU
// backend computes), the taps are __fadd_rn, the cast is round-to-nearest.
//
// Bound: the (H, W, D) output. At 360x640x64 bf16 that is 29.5 MB written
// per frame; the four (H, W) float32 inputs (3.7 MB) stay in L2 and L1.
// Design: one thread per output element with d fastest, so a warp stores
// 32 consecutive elements (64 contiguous bytes in bf16) and its loads of the
// left image and gradient are broadcasts of one pixel.

#include "cost_terms.cuh"

namespace {

template <typename T>
__global__ void cost_volume_kernel(const float* __restrict__ iml,
                                   const float* __restrict__ imr,
                                   const float* __restrict__ gl,
                                   const float* __restrict__ gr,
                                   T* __restrict__ out, int H, int W, int D,
                                   float alpha, float beta) {
  const long long n = (long long)H * W * D;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n; t += stride) {
    const int d = (int)(t % D);
    const long long p = t / D;
    const int x = (int)(p % W);
    const int y = (int)(p / W);
    const int ym = max(y - 1, 0), yp = min(y + 1, H - 1);
    const int xm = max(x - 1, 0), xp = min(x + 1, W - 1);
    store(out, t, stencil_sum(e_term(iml, imr, gl, gr, W, y, x, d, alpha, beta),
                              e_term(iml, imr, gl, gr, W, ym, xm, d, alpha, beta),
                              e_term(iml, imr, gl, gr, W, ym, xp, d, alpha, beta),
                              e_term(iml, imr, gl, gr, W, yp, xm, d, alpha, beta),
                              e_term(iml, imr, gl, gr, W, yp, xp, d, alpha, beta)));
  }
}

int grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 32;  // grid-stride beyond a few waves
  return (int)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" int opt_cost_volume(const void* iml, const void* imr, const void* gl,
                               const void* gr, void* out, int H, int W, int D,
                               float alpha, float beta, int out_bf16, void* stream) {
  const long long n = (long long)H * W * D;
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = grid_for(n, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16) {
    cost_volume_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const float*)iml, (const float*)imr, (const float*)gl, (const float*)gr,
        (__nv_bfloat16*)out, H, W, D, alpha, beta);
  } else {
    cost_volume_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)iml, (const float*)imr, (const float*)gl, (const float*)gr,
        (float*)out, H, W, D, alpha, beta);
  }
  return (int)cudaGetLastError();
}
