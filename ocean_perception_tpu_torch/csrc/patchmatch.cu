// PatchMatch one-side match for Hopper (sm_90a): three kernels that together
// compute what one launch of the TPU's whole-frame kernel computes.
//
// Replaces: ocean_perception_tpu/ops/pallas/fused_patchmatch.py::
// pallas_patchmatch_fused (body _kernel), its prebuilt-volume entry
// pallas_patchmatch_fused_prebuilt, and its per-pass unit
// ocean_perception_tpu/ops/pallas/propagate.py::pallas_propagate_pass (body
// _prop_kernel). Semantics are those of stereo/patchmatch.py::_match_one_side:
//   per iteration: pm_refresh (foreground noise + cost-map refresh), then
//   pm_propagate R+ C+ R- C-; after the last iteration pm_mask_background.
//
// Each kernel reads the volume through an accessor, in one of two layouts:
//   Hwd:        C[y, x, d], the (H, W, D) volume of cost_volume.cu;
//   RowStrips:  V_row[i, c, d, y] with x = c*chunk + i (volume_build.cu);
//   ColStrips:  V_col[i, c, d, x] with y = c*chunk + i (volume_build.cu).
// The *_strip entry points read V_row in row passes (a warp's lanes are
// consecutive rows, so at equal d they read consecutive addresses) and V_col
// in column passes, the refresh and the mask (lanes are consecutive
// columns). The TPU kernel kept both strip layouts resident in VMEM and moved
// the front between them with permutation matmuls; here the (H, W) fronts
// stay in one layout in device memory and only the volume reads change.
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

// The three volume layouts. at(y, x, d) is the cost of disparity d at pixel
// (y, x); x is the column, y the row.
template <typename T>
struct Hwd {
  const T* C;
  int W, D;
  __device__ __forceinline__ T at(int y, int x, int d) const {
    return C[((long long)y * W + x) * D + d];
  }
};

template <typename T>
struct RowStrips {  // V_row (chunk, chunks, D, H), x = c*chunk + i
  const T* V;
  int H, D, chunk, chunks;
  __device__ __forceinline__ T at(int y, int x, int d) const {
    const int i = x % chunk, c = x / chunk;
    return V[((long long)(i * chunks + c) * D + d) * H + y];
  }
};

template <typename T>
struct ColStrips {  // V_col (chunk, chunks, D, W), y = c*chunk + i
  const T* V;
  int W, D, chunk, chunks;
  __device__ __forceinline__ T at(int y, int x, int d) const {
    const int i = y % chunk, c = y / chunk;
    return V[((long long)(i * chunks + c) * D + d) * W + x];
  }
};

template <typename T, typename Vol>
__global__ void pm_refresh_kernel(Vol vol, const float* __restrict__ disp_in,
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
    cost_out[p] = vol.at(p / W, x, lookup_index(fminf(v, (float)(x - pr)), D));
  }
}

template <typename T, typename Vol>
__global__ void pm_propagate_kernel(Vol vol, const float* __restrict__ disp_in,
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
    const int y = axis == 1 ? lane : pos, x = axis == 1 ? pos : lane;
    const long long p = (long long)y * W + x;
    const float cand_d = fminf(carry, (float)(x - pr));
    const T cand_c = vol.at(y, x, lookup_index(cand_d, D));
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

template <typename T, typename Vol>
__global__ void pm_mask_background_kernel(Vol vol, const float* __restrict__ disp,
                                          float* __restrict__ out, int H, int W, int D, int pr,
                                          float improve) {
  const int n = H * W;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n; p += gridDim.x * blockDim.x) {
    const int x = p % W;
    const int y = p / W;
    const float d = disp[p];
    const float cost_d = to_f(vol.at(y, x, lookup_index(fminf(d, (float)(x - pr)), D)));
    const bool keep = cost_d < __fmul_rn(improve, to_f(vol.at(y, x, 0)));
    const bool interior = y >= pr && y <= H - pr - 1 && x >= pr && x <= W - pr - 1;
    out[p] = keep && interior ? d : 0.f;
  }
}

int grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 32;
  return (int)(blocks < cap ? blocks : cap);
}

template <typename T, typename Vol>
int refresh(Vol vol, const void* disp_in, const void* noise, float scale, void* disp_out,
            void* cost_out, int H, int W, int D, int pr, cudaStream_t s) {
  const int threads = 256;
  pm_refresh_kernel<T><<<grid_for((long long)H * W, threads), threads, 0, s>>>(
      vol, (const float*)disp_in, (const float*)noise, scale, (float*)disp_out, (T*)cost_out,
      H, W, D, pr);
  return (int)cudaGetLastError();
}

template <typename T, typename Vol>
int propagate(Vol vol, const void* disp_in, const void* cost_in, void* disp_out, void* cost_out,
              int H, int W, int D, int axis, int forward, int chunks, int chunk, int halo, int pr,
              cudaStream_t s) {
  const int n = chunks * (axis == 1 ? H : W);
  const int threads = 128;
  pm_propagate_kernel<T><<<(n + threads - 1) / threads, threads, 0, s>>>(
      vol, (const float*)disp_in, (const T*)cost_in, (float*)disp_out, (T*)cost_out, H, W, D,
      axis, forward, chunks, chunk, halo, pr);
  return (int)cudaGetLastError();
}

template <typename T, typename Vol>
int mask_background(Vol vol, const void* disp, void* out, int H, int W, int D, int pr,
                    float improve, cudaStream_t s) {
  const int threads = 256;
  pm_mask_background_kernel<T><<<grid_for((long long)H * W, threads), threads, 0, s>>>(
      vol, (const float*)disp, (float*)out, H, W, D, pr, improve);
  return (int)cudaGetLastError();
}

template <typename T>
Hwd<T> hwd(const void* C, int W, int D) { return Hwd<T>{(const T*)C, W, D}; }

template <typename T>
ColStrips<T> col_strips(const void* V, int H, int W, int D, int chunks) {
  return ColStrips<T>{(const T*)V, W, D, H / chunks, chunks};
}

template <typename T>
RowStrips<T> row_strips(const void* V, int H, int W, int D, int chunks) {
  return RowStrips<T>{(const T*)V, H, D, W / chunks, chunks};
}

}  // namespace

// (H, W, D) volume.

extern "C" int opt_pm_refresh(const void* C, const void* disp_in, const void* noise, float scale,
                              void* disp_out, void* cost_out, int H, int W, int D, int pr,
                              int bf16, void* stream) {
  if (H * W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? refresh<__nv_bfloat16>(hwd<__nv_bfloat16>(C, W, D), disp_in, noise, scale,
                                       disp_out, cost_out, H, W, D, pr, s)
              : refresh<float>(hwd<float>(C, W, D), disp_in, noise, scale, disp_out, cost_out,
                               H, W, D, pr, s);
}

extern "C" int opt_pm_propagate(const void* C, const void* disp_in, const void* cost_in,
                                void* disp_out, void* cost_out, int H, int W, int D, int axis,
                                int forward, int chunks, int chunk, int halo, int pr, int bf16,
                                void* stream) {
  if (chunks * (axis == 1 ? H : W) == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? propagate<__nv_bfloat16>(hwd<__nv_bfloat16>(C, W, D), disp_in, cost_in,
                                         disp_out, cost_out, H, W, D, axis, forward, chunks,
                                         chunk, halo, pr, s)
              : propagate<float>(hwd<float>(C, W, D), disp_in, cost_in, disp_out, cost_out, H,
                                 W, D, axis, forward, chunks, chunk, halo, pr, s);
}

extern "C" int opt_pm_mask_background(const void* C, const void* disp, void* out, int H, int W,
                                      int D, int pr, float improve, int bf16, void* stream) {
  if (H * W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? mask_background<__nv_bfloat16>(hwd<__nv_bfloat16>(C, W, D), disp, out, H, W, D,
                                               pr, improve, s)
              : mask_background<float>(hwd<float>(C, W, D), disp, out, H, W, D, pr, improve, s);
}

// Strip layouts: V_col (chunk_y, chunks_y, D, W) for the refresh, the mask
// and column passes; V_row (chunk_x, chunks_x, D, H) for row passes. The
// pass's strips are the layout's strips.

extern "C" int opt_pm_refresh_strip(const void* V_col, const void* disp_in, const void* noise,
                                    float scale, void* disp_out, void* cost_out, int H, int W,
                                    int D, int chunks_y, int pr, int bf16, void* stream) {
  if (H * W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? refresh<__nv_bfloat16>(col_strips<__nv_bfloat16>(V_col, H, W, D, chunks_y),
                                       disp_in, noise, scale, disp_out, cost_out, H, W, D, pr, s)
              : refresh<float>(col_strips<float>(V_col, H, W, D, chunks_y), disp_in, noise,
                               scale, disp_out, cost_out, H, W, D, pr, s);
}

extern "C" int opt_pm_propagate_strip(const void* V, const void* disp_in, const void* cost_in,
                                      void* disp_out, void* cost_out, int H, int W, int D,
                                      int axis, int forward, int chunks, int halo, int pr,
                                      int bf16, void* stream) {
  if (chunks * (axis == 1 ? H : W) == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int chunk = (axis == 1 ? W : H) / chunks;
  if (axis == 1) {
    return bf16 ? propagate<__nv_bfloat16>(row_strips<__nv_bfloat16>(V, H, W, D, chunks),
                                           disp_in, cost_in, disp_out, cost_out, H, W, D, axis,
                                           forward, chunks, chunk, halo, pr, s)
                : propagate<float>(row_strips<float>(V, H, W, D, chunks), disp_in, cost_in,
                                   disp_out, cost_out, H, W, D, axis, forward, chunks, chunk,
                                   halo, pr, s);
  }
  return bf16 ? propagate<__nv_bfloat16>(col_strips<__nv_bfloat16>(V, H, W, D, chunks), disp_in,
                                         cost_in, disp_out, cost_out, H, W, D, axis, forward,
                                         chunks, chunk, halo, pr, s)
              : propagate<float>(col_strips<float>(V, H, W, D, chunks), disp_in, cost_in,
                                 disp_out, cost_out, H, W, D, axis, forward, chunks, chunk, halo,
                                 pr, s);
}

extern "C" int opt_pm_mask_background_strip(const void* V_col, const void* disp, void* out,
                                            int H, int W, int D, int chunks_y, int pr,
                                            float improve, int bf16, void* stream) {
  if (H * W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? mask_background<__nv_bfloat16>(
                    col_strips<__nv_bfloat16>(V_col, H, W, D, chunks_y), disp, out, H, W, D, pr,
                    improve, s)
              : mask_background<float>(col_strips<float>(V_col, H, W, D, chunks_y), disp, out,
                                       H, W, D, pr, improve, s);
}
