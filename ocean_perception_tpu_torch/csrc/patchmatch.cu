// PatchMatch left-side match for Hopper (sm_90a): three kernels that together
// compute what one launch of the TPU's whole-frame kernel computes.
//
// Replaces: ocean_perception_tpu/ops/pallas/fused_patchmatch.py::
// pallas_patchmatch_fused (body _kernel) and its per-pass unit
// ocean_perception_tpu/ops/pallas/propagate.py::pallas_propagate_pass (body
// _prop_kernel). Semantics are those of stereo/patchmatch.py::_match_one_side:
//   per iteration: pm_refresh (foreground noise + cost-map refresh), then
//   pm_propagate R+ C+ R- C-; after the last iteration pm_mask_background.
//
// The TPU kernel kept two strip-layout copies of the volume resident in VMEM
// and moved between them with permutation matmuls. Here the volume stays in
// its one (H, W, D) layout in device memory (29.5 MB in bf16 at 360x640x64,
// which the 50 MB L2 holds) and every lookup is a plain indexed load.
//
// pm_propagate follows the reference CUDA design (patchmatch_gpu.cu:116-230):
// one thread per (strip, lane) walks its chunk + 2*halo positions in order.
// Unlike the reference, each thread reads the disparity and cost of every
// position from the PASS-START input buffers and writes only its own chunk,
// to separate output buffers. That is the snapshot semantics of the JAX
// scan (halo positions read the values from before the pass), and it leaves
// no race between neighbouring strips. Its bound is latency: each step's
// volume load depends on the previous step's result, so a pass costs about
// (chunk + 2*halo) dependent L2 round trips; 5,760 to 9,600 threads in flight
// at the production point hide part of it.
//
// All costs are compared as float32 (exact for bf16 values); lookups round
// half to even (rintf) like jnp.round; no floating-point operation here can
// be contracted, and the one product in pm_refresh is exact (power-of-two
// noise scales) and pinned with intrinsics anyway.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Index of the clamped disparity min(d, x - pr), rounded half to even and
// clipped to [0, D-1] (stereo/patchmatch.py _lookup_cost).
__device__ __forceinline__ int lookup_index(float d_eff, int D) {
  float r = rintf(d_eff);
  r = fminf(fmaxf(r, 0.f), (float)(D - 1));
  return (int)r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

template <typename T>
__global__ void pm_refresh_kernel(const T* __restrict__ C, const float* __restrict__ disp_in,
                                  const float* __restrict__ noise, float scale,
                                  float* __restrict__ disp_out, T* __restrict__ cost_out,
                                  int H, int W, int D, int pr) {
  const int n = H * W;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += gridDim.x * blockDim.x) {
    const int x = p % W;
    const float d = disp_in[p];
    const float mask = d > 0.f ? 1.f : 0.f;
    float v = __fmul_rn(__fadd_rn(d, __fmul_rn(noise[p], scale)), mask);
    v = fmaxf(v, 0.f);
    disp_out[p] = v;
    cost_out[p] = C[(long long)p * D + lookup_index(fminf(v, (float)(x - pr)), D)];
  }
}

template <typename T>
__global__ void pm_propagate_kernel(const T* __restrict__ C, const float* __restrict__ disp_in,
                                    const T* __restrict__ cost_in, float* __restrict__ disp_out,
                                    T* __restrict__ cost_out, int H, int W, int D, int axis,
                                    int forward, int chunks, int chunk, int halo, int pr) {
  // axis 1: rows pass, scan along x, lanes are rows; axis 0: scan along y.
  const int dim = axis == 1 ? W : H;
  const int N = axis == 1 ? H : W;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= chunks * N) return;
  const int lane = t % N;
  const int c = t / N;
  const int w = chunk + 2 * halo;
  const int start = c * chunk - halo;
  const int lo = max(start, pr);
  const int hi = min((c + 1) * chunk + halo, dim - pr - 1);
  const bool lane_ok = lane >= pr && lane <= N - pr - 1;

  // The front starts at the predecessor of the strip's first position.
  const int first = clampi(start + (forward ? 0 : w - 1), 0, dim - 1);
  const int pred = clampi(first + (forward ? -1 : 1), 0, dim - 1);
  float carry = disp_in[axis == 1 ? (long long)lane * W + pred : (long long)pred * W + lane];

  for (int s = 0; s < w; ++s) {
    const int j = forward ? s : w - 1 - s;
    const int u = start + j;
    const int pos = clampi(u, 0, dim - 1);
    const long long p = axis == 1 ? (long long)lane * W + pos : (long long)pos * W + lane;
    const float cand_d = fminf(carry, (float)((axis == 1 ? pos : lane) - pr));
    const T cand_c = C[p * D + lookup_index(cand_d, D)];
    const float cur_d = disp_in[p];
    const T cur_c = cost_in[p];
    const bool better = u >= lo && u < hi && lane_ok && to_f(cand_c) < to_f(cur_c);
    const float new_d = better ? cand_d : cur_d;
    carry = new_d;
    if (j >= halo && j < halo + chunk) {
      disp_out[p] = new_d;
      cost_out[p] = better ? cand_c : cur_c;
    }
  }
}

template <typename T>
__global__ void pm_mask_background_kernel(const T* __restrict__ C, const float* __restrict__ disp,
                                          float* __restrict__ out, int H, int W, int D, int pr,
                                          float improve) {
  const int n = H * W;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += gridDim.x * blockDim.x) {
    const int x = p % W;
    const int y = p / W;
    const float d = disp[p];
    const T* col = C + (long long)p * D;
    const float cost_d = to_f(col[lookup_index(fminf(d, (float)(x - pr)), D)]);
    const bool keep = cost_d < __fmul_rn(improve, to_f(col[0]));
    const bool interior = y >= pr && y <= H - pr - 1 && x >= pr && x <= W - pr - 1;
    out[p] = keep && interior ? d : 0.f;
  }
}

int grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 32;
  return (int)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" int opt_pm_refresh(const void* C, const void* disp_in, const void* noise, float scale,
                              void* disp_out, void* cost_out, int H, int W, int D, int pr,
                              int bf16, void* stream) {
  const int n = H * W;
  if (n == 0) return 0;
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    pm_refresh_kernel<__nv_bfloat16><<<grid_for(n, threads), threads, 0, s>>>(
        (const __nv_bfloat16*)C, (const float*)disp_in, (const float*)noise, scale,
        (float*)disp_out, (__nv_bfloat16*)cost_out, H, W, D, pr);
  } else {
    pm_refresh_kernel<float><<<grid_for(n, threads), threads, 0, s>>>(
        (const float*)C, (const float*)disp_in, (const float*)noise, scale,
        (float*)disp_out, (float*)cost_out, H, W, D, pr);
  }
  return (int)cudaGetLastError();
}

extern "C" int opt_pm_propagate(const void* C, const void* disp_in, const void* cost_in,
                                void* disp_out, void* cost_out, int H, int W, int D, int axis,
                                int forward, int chunks, int chunk, int halo, int pr, int bf16,
                                void* stream) {
  const int n = chunks * (axis == 1 ? H : W);
  if (n == 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    pm_propagate_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)C, (const float*)disp_in, (const __nv_bfloat16*)cost_in,
        (float*)disp_out, (__nv_bfloat16*)cost_out, H, W, D, axis, forward, chunks, chunk,
        halo, pr);
  } else {
    pm_propagate_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)C, (const float*)disp_in, (const float*)cost_in, (float*)disp_out,
        (float*)cost_out, H, W, D, axis, forward, chunks, chunk, halo, pr);
  }
  return (int)cudaGetLastError();
}

extern "C" int opt_pm_mask_background(const void* C, const void* disp, void* out, int H, int W,
                                      int D, int pr, float improve, int bf16, void* stream) {
  const int n = H * W;
  if (n == 0) return 0;
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    pm_mask_background_kernel<__nv_bfloat16><<<grid_for(n, threads), threads, 0, s>>>(
        (const __nv_bfloat16*)C, (const float*)disp, (float*)out, H, W, D, pr, improve);
  } else {
    pm_mask_background_kernel<float><<<grid_for(n, threads), threads, 0, s>>>(
        (const float*)C, (const float*)disp, (float*)out, H, W, D, pr, improve);
  }
  return (int)cudaGetLastError();
}
