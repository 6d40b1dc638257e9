// The LK tracker's coarse start, for Hopper (sm_90a).
//
// lk_coarse_match replaces no TPU kernel: the JAX package runs its coarse
// block match in XLA (ocean_perception_tpu/tracking/lk.py::
// _coarse_block_match and _coarse_block_match_ring, reached with
// LKParams.coarse_init). Its plain PyTorch twin is
// tracking/lk.py::coarse_block_match_plain. For each point it takes the
// patch^2 template at round(pt) of the point's template frame and its SSD
// against every whole offset of (2*search + 1)^2 in the search frame, and
// writes pt + the offset of the least SSD (the first in row-major (dy, dx)
// order, as jnp.argmin takes it; a NaN SSD counts as least).
//
// Every SSD is summed row by row over the patch, left to right, and every
// rounding is pinned with an intrinsic (__fsub_rn, __fmul_rn, __fadd_rn), so
// that nvcc's contraction cannot change a bit: kernel and twin agree
// exactly. Levels are never padded: coordinates are those of the level
// edge-padded by pad = search + patch/2 + 1, as in the reference, and reads
// are clamped to the level, which gives the same values. A window's start
// is taken as jax.lax.dynamic_slice takes it: a negative start counts from
// the end of the padded axis, then it is clamped into it.
//
// One block of 128 threads a point. A batch of cameras is folded by the
// caller: the template rings into one ring (each point's src_t offset to its
// camera's frames), the search frames into one ring of a frame a camera,
// and the points into one grid, kpc points a camera (point k searches frame
// k / kpc).
//
// The work is small (at the default search 12, patch 9: 625 offsets of 81
// products a point, a 33^2 window and a 9^2 template read); what bounds it
// is the latency of each thread's chains of dependent adds, a few offsets
// a thread. The design: template and window are staged in shared memory,
// each thread keeps the least of its offsets (taken in increasing order, so
// a tie keeps the first), and the block takes the least of those (a tie
// goes to the lower index) with warp shuffles and one shared step.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// Points are clamped to +-2^20 px before rounding, so that the origins
// stay in int range (tracking/lk.py::_COARSE_MAX).
constexpr float kCoarseMax = 1048576.f;

__device__ __forceinline__ float clean(float v) { return isfinite(v) ? v : 0.f; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// jax.lax.dynamic_slice's start: negative counts from the end, then clamped.
__device__ __forceinline__ int slice_start(int v, int dim, int size) {
  return clampi(v < 0 ? v + dim : v, 0, dim - size);
}

// (cost, index) a is better than b: less cost, or equal cost and a lower
// index; index -1 holds no offset.
__device__ __forceinline__ bool better(float ca, int ia, float cb, int ib) {
  if (ia < 0) return false;
  if (ib < 0) return true;
  return ca < cb || (ca == cb && ia < ib);
}

__global__ void __launch_bounds__(kThreads) lk_coarse_match_kernel(
    const float* __restrict__ prev, const float* __restrict__ next, int Rt, int Rs, int H, int W,
    const float* __restrict__ pts, const int* __restrict__ src_t, int kpc,
    float* __restrict__ out, int search, int patch) {
  extern __shared__ float sm[];
  __shared__ float s_cost[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  const int k = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n = 2 * search + 1, wn = patch + 2 * search, r = patch / 2;
  const int pad = search + r + 1, Hp = H + 2 * pad, Wp = W + 2 * pad;
  float* tm = sm;                       // (patch, patch)
  float* wv = sm + patch * patch;       // (wn, wn)

  const float px = pts[2 * k], py = pts[2 * k + 1];
  const int cx = (int)rintf(fminf(fmaxf(clean(px), -kCoarseMax), kCoarseMax));
  const int cy = (int)rintf(fminf(fmaxf(clean(py), -kCoarseMax), kCoarseMax));
  const int ty0 = slice_start(cy + pad - r, Hp, patch), tx0 = slice_start(cx + pad - r, Wp, patch);
  const int wy0 = slice_start(cy + pad - r - search, Hp, wn);
  const int wx0 = slice_start(cx + pad - r - search, Wp, wn);
  const float* T = prev + (size_t)clampi(src_t[k], 0, Rt - 1) * H * W;
  const float* S = next + (size_t)clampi(k / kpc, 0, Rs - 1) * H * W;
  for (int i = tid; i < patch * patch; i += nt) {
    const int y = i / patch, x = i % patch;
    tm[i] = T[(size_t)clampi(ty0 + y - pad, 0, H - 1) * W + clampi(tx0 + x - pad, 0, W - 1)];
  }
  for (int i = tid; i < wn * wn; i += nt) {
    const int y = i / wn, x = i % wn;
    wv[i] = S[(size_t)clampi(wy0 + y - pad, 0, H - 1) * W + clampi(wx0 + x - pad, 0, W - 1)];
  }
  __syncthreads();

  float best = 0.f;
  int bi = -1;
  for (int o = tid; o < n * n; o += nt) {
    const int dy = o / n, dx = o % n;
    float acc = 0.f;
    for (int y = 0; y < patch; ++y) {
      const float* wrow = wv + (dy + y) * wn + dx;
      const float* trow = tm + y * patch;
      for (int x = 0; x < patch; ++x) {
        const float d = __fsub_rn(wrow[x], trow[x]);
        acc = __fadd_rn(acc, __fmul_rn(d, d));
      }
    }
    if (isnan(acc)) acc = -1.f;  // least, as jnp.argmin takes a NaN
    if (better(acc, o, best, bi)) {
      best = acc;
      bi = o;
    }
  }
  // The block's least: within each warp, then across the warps.
  for (int off = 16; off > 0; off >>= 1) {
    const float c = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(c, i, best, bi)) {
      best = c;
      bi = i;
    }
  }
  if ((tid & 31) == 0) {
    s_cost[tid >> 5] = best;
    s_idx[tid >> 5] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < nt / 32; ++w)
      if (better(s_cost[w], s_idx[w], best, bi)) {
        best = s_cost[w];
        bi = s_idx[w];
      }
    out[2 * k] = __fadd_rn(px, (float)(bi % n - search));
    out[2 * k + 1] = __fadd_rn(py, (float)(bi / n - search));
  }
}

}  // namespace

// The coarse block match of K points, one launch on `stream`: prev (Rt, H,
// W) and next (Rs, H, W) rings, pts (K, 2) [x, y], src_t (K,) each point's
// template frame, kpc points a search frame, out (K, 2). Returns a
// cudaError_t (0 on success).
extern "C" int opt_lk_coarse_match(const void* prev, const void* next, int Rt, int Rs, int H,
                                   int W, const void* pts, const void* src_t, int kpc, void* out,
                                   int K, int search, int patch, void* stream) {
  if (K == 0) return 0;
  if (search < 0 || patch < 1 || kpc < 1 || Rt < 1 || Rs < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int wn = patch + 2 * search;
  const size_t smem = sizeof(float) * ((size_t)patch * patch + (size_t)wn * wn);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lk_coarse_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lk_coarse_match_kernel<<<K, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)prev, (const float*)next, Rt, Rs, H, W, (const float*)pts,
      (const int*)src_t, kpc, (float*)out, search, patch);
  return (int)cudaGetLastError();
}
