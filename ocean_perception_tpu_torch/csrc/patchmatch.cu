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
// pm_propagate follows the reference CUDA design (patchmatch_gpu.cu:116-230)
// in what it computes: each (strip, lane) walks its chunk + 2*halo positions
// in order. Unlike the reference, every step reads the disparity and cost of
// its position from the PASS-START input buffers and only the strip's own
// chunk is written, to separate output buffers. That is the snapshot
// semantics of the JAX scan (halo positions read the values from before the
// pass), and it leaves no race between neighbouring strips.
//
// What bounds a pass is latency, not bytes (3.4 MB, 1.0 us at 720p): each
// step's volume load needs the previous step's carry, so a walk is a chain of
// 50 (row pass) or 34 (column pass) dependent L2 round trips, and a warp's
// gather of 32 scattered costs also holds its SM's load pipe for a while.
// The TPU kernel hid the chain by copying every position's whole (chunks, N,
// D) slab to VMEM, reading the whole volume each pass (11x the bound here).
// On the H100 (PERF.md) the two kinds of pass get two kernels:
//  - pm_propagate_rows_kernel (row passes, lanes are rows). A block is
//    kLanes rows of one strip. All kThreads threads first stage the rows'
//    pass-start disparities and costs in shared memory, kSegment positions
//    at a time, reading runs along the rows (a plain walk reads them a row
//    apart), and the outputs go back the same way. Its first kLanes threads
//    walk, so a gather touches kLanes lines and the 360 rows of a 720p pass
//    spread over 23 blocks a strip. They speculate K = Vol::kSpec steps at a
//    time: within a group of K steps after carry c, step i's candidate
//    disparity is min(carry_{i-1}, lim_i), lim = x - pr, which is
//    min(c, lim_0..lim_i) if no step of the group failed
//    before i, or min(cur_d_f, lim_{f+1}..lim_i) if step f failed last. All
//    K(K+1)/2 of these are known when the group starts, so their cost loads
//    go out together, one round trip, and the walk then picks, step by step
//    with selects, the one its compares chose. The disparity is recomputed
//    in order as before, so the pass is the plain walk's bit for bit. Steps
//    outside the CUDA loop bounds, and rows outside [pr, H-pr-1], fail for
//    certain and load nothing. In (H, W, D) the candidates of a step share
//    the step's pixel, D contiguous costs; in V_row each is a line of its
//    own, and speculating there costs more than the round trips it saves.
//  - pm_propagate_cols_kernel (column passes, lanes are columns): one thread
//    per (strip, lane) walks its positions over device memory. Its lanes'
//    fronts and candidates are already neighbours in memory, and neither
//    staging nor speculating beat it on the card.
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

// Steps of a row pass's walk resolved per round trip to the volume (see the
// note above), by layout: 4 on (H, W, D), none on V_row. Picked on an H100
// with pm_spec_sweep.py (PERF.md).
constexpr int kSpecHwd = 4;
constexpr int kSpecRowStrips = 1;

// The three volume layouts. at(y, x, d) is the cost of disparity d at pixel
// (y, x); x is the column, y the row.
template <typename T>
struct Hwd {
  static constexpr int kSpec = kSpecHwd;
  const T* C;
  int W, D;
  __device__ __forceinline__ T at(int y, int x, int d) const {
    return C[((long long)y * W + x) * D + d];
  }
};

template <typename T>
struct RowStrips {  // V_row (chunk, chunks, D, H), x = c*chunk + i
  static constexpr int kSpec = kSpecRowStrips;
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

constexpr int kLanes = 16;     // rows of a pm_propagate_rows_kernel block, one walking thread each
constexpr int kThreads = 128;  // its threads, all of which stage its fronts
constexpr int kSegment = 64;   // scan positions staged in shared memory at a time
constexpr int kBatch = 16;     // front elements a thread loads before it stores any

template <typename T, typename Vol>
__global__ void __launch_bounds__(kThreads)
pm_propagate_rows_kernel(Vol vol, const float* __restrict__ disp_in,
                         const T* __restrict__ cost_in, float* __restrict__ disp_out,
                         T* __restrict__ cost_out, int H, int W, int D, int forward, int chunk,
                         int halo, int pr) {
  // Scan along x; block (blockIdx.x, blockIdx.y) is rows [kLanes *
  // blockIdx.x, ...) of strip blockIdx.y. Front tiles [segment index][row],
  // padded against bank conflicts while they are staged.
  constexpr int K = Vol::kSpec;
  __shared__ float td[kSegment][kLanes + 1];
  __shared__ __align__(4) unsigned char tc_raw[kSegment * (kLanes + 1) * sizeof(T)];
  T* tc = reinterpret_cast<T*>(tc_raw);
  const int c = blockIdx.y;
  const int y0 = blockIdx.x * kLanes;
  const int nl = min(kLanes, H - y0);
  const int l = threadIdx.x;
  const int y = y0 + l;
  const int w = chunk + 2 * halo;
  const int start = c * chunk - halo;
  const int lo = max(start, pr);
  const int hi = min((c + 1) * chunk + halo, W - pr - 1);
  const bool walks = l < nl;  // rows outside [pr, H-pr-1] walk too, failing every step
  const bool row_ok = y >= pr && y <= H - pr - 1;
  // Walk step s is in-strip index j(s), at column clamp(start + j(s)).
  auto j_of = [&](int s) { return forward ? s : w - 1 - s; };
  auto x_of = [&](int s) { return clampi(start + j_of(s), 0, W - 1); };

  // The front starts at the predecessor of the strip's first position.
  float carry = 0.f;
  if (walks) {
    const int first = clampi(start + (forward ? 0 : w - 1), 0, W - 1);
    carry = disp_in[(long long)y * W + clampi(first + (forward ? -1 : 1), 0, W - 1)];
  }

  for (int base = 0; base < w; base += kSegment) {
    const int n = min(kSegment, w - base);
    // Consecutive threads take consecutive positions of a row, and each has
    // kBatch loads in flight before it stores one.
    for (int e0 = l; e0 < n * nl; e0 += kThreads * kBatch) {
      float dv[kBatch];
      T cv[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = e0 + b * kThreads;
        if (e < n * nl) {
          const long long p = (long long)(y0 + e / n) * W + x_of(base + e % n);
          dv[b] = disp_in[p];
          cv[b] = cost_in[p];
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int e = e0 + b * kThreads;
        if (e < n * nl) {
          td[e % n][e / n] = dv[b];
          tc[(e % n) * (kLanes + 1) + e / n] = cv[b];
        }
      }
    }
    __syncthreads();

    for (int s0 = 0; walks && s0 < n; s0 += K) {
      float cur_d[K], lim[K];
      T cur_c[K];
      bool ok[K];
      int xx[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int si = min(s0 + i, n - 1);
        const int u = start + j_of(base + si);
        xx[i] = clampi(u, 0, W - 1);
        lim[i] = (float)(xx[i] - pr);
        ok[i] = row_ok && s0 + i < n && u >= lo && u < hi;
        cur_d[i] = td[si][l];
        cur_c[i] = tc[si * (kLanes + 1) + l];
      }
      // Every candidate cost the group can need, all loads in flight at once:
      // chain[i] if no step before i failed, spec[f][i] if step f failed last.
      T chain[K], spec[K][K];
      float m = carry;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        m = fminf(m, lim[i]);
        chain[i] = ok[i] ? vol.at(y, xx[i], lookup_index(m, D)) : T{};
      }
#pragma unroll
      for (int f = 0; f + 1 < K; ++f) {
        float mf = cur_d[f];
#pragma unroll
        for (int i = f + 1; i < K; ++i) {
          mf = fminf(mf, lim[i]);
          spec[f][i] = ok[i] ? vol.at(y, xx[i], lookup_index(mf, D)) : T{};
        }
      }
      // The walk in order, as the plain one; the cost of its candidate is the
      // hypothesis of the last failed step (-1: none in this group).
      int last = -1;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (s0 + i < n) {
          T cand_c = chain[i];
#pragma unroll
          for (int f = 0; f < i; ++f) cand_c = last == f ? spec[f][i] : cand_c;
          const float cand_d = fminf(carry, lim[i]);
          const bool better = ok[i] && to_f(cand_c) < to_f(cur_c[i]);
          carry = better ? cand_d : cur_d[i];
          if (!better) last = i;
          td[s0 + i][l] = carry;
          tc[(s0 + i) * (kLanes + 1) + l] = better ? cand_c : cur_c[i];
        }
      }
    }
    __syncthreads();

    // The strip's own chunk goes out the way the fronts came in.
    for (int e = l; e < n * nl; e += kThreads) {
      const int i = e % n, k = e / n;
      const int j = j_of(base + i);
      if (j >= halo && j < halo + chunk) {
        const long long p = (long long)(y0 + k) * W + start + j;
        disp_out[p] = td[i][k];
        cost_out[p] = tc[i * (kLanes + 1) + k];
      }
    }
    __syncthreads();
  }
}

template <typename T, typename Vol>
__global__ void pm_propagate_cols_kernel(Vol vol, const float* __restrict__ disp_in,
                                         const T* __restrict__ cost_in,
                                         float* __restrict__ disp_out, T* __restrict__ cost_out,
                                         int H, int W, int D, int forward, int chunks, int chunk,
                                         int halo, int pr) {
  // Scan along y; one thread per (strip, column).
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= chunks * W) return;
  const int x = t % W;
  const int c = t / W;
  const int w = chunk + 2 * halo;
  const int start = c * chunk - halo;
  const int lo = max(start, pr);
  const int hi = min((c + 1) * chunk + halo, H - pr - 1);
  const bool col_ok = x >= pr && x <= W - pr - 1;

  // The front starts at the predecessor of the strip's first position.
  const int first = clampi(start + (forward ? 0 : w - 1), 0, H - 1);
  const int pred = clampi(first + (forward ? -1 : 1), 0, H - 1);
  float carry = disp_in[(long long)pred * W + x];

  for (int s = 0; s < w; ++s) {
    const int j = forward ? s : w - 1 - s;
    const int u = start + j;
    const int y = clampi(u, 0, H - 1);
    const long long p = (long long)y * W + x;
    const float cand_d = fminf(carry, (float)(x - pr));
    const T cand_c = vol.at(y, x, lookup_index(cand_d, D));
    const float cur_d = disp_in[p];
    const T cur_c = cost_in[p];
    const bool better = u >= lo && u < hi && col_ok && to_f(cand_c) < to_f(cur_c);
    carry = better ? cand_d : cur_d;
    if (j >= halo && j < halo + chunk) {
      disp_out[p] = carry;
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

// Blocks of a grid-stride launch over n items: at most 32 a streaming
// multiprocessor, counted once on the current device.
int grid_for(long long n, int threads) {
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  const long long blocks = (n + threads - 1) / threads, cap = 32LL * sms;
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
int propagate_rows(Vol vol, const void* disp_in, const void* cost_in, void* disp_out,
                   void* cost_out, int H, int W, int D, int forward, int chunks, int chunk,
                   int halo, int pr, cudaStream_t s) {
  const dim3 grid((H + kLanes - 1) / kLanes, chunks);
  pm_propagate_rows_kernel<T><<<grid, kThreads, 0, s>>>(
      vol, (const float*)disp_in, (const T*)cost_in, (float*)disp_out, (T*)cost_out, H, W, D,
      forward, chunk, halo, pr);
  return (int)cudaGetLastError();
}

template <typename T, typename Vol>
int propagate_cols(Vol vol, const void* disp_in, const void* cost_in, void* disp_out,
                   void* cost_out, int H, int W, int D, int forward, int chunks, int chunk,
                   int halo, int pr, cudaStream_t s) {
  const int threads = 128;
  pm_propagate_cols_kernel<T><<<(chunks * W + threads - 1) / threads, threads, 0, s>>>(
      vol, (const float*)disp_in, (const T*)cost_in, (float*)disp_out, (T*)cost_out, H, W, D,
      forward, chunks, chunk, halo, pr);
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
  if (bf16) {
    const auto vol = hwd<__nv_bfloat16>(C, W, D);
    return (axis == 1 ? propagate_rows<__nv_bfloat16, Hwd<__nv_bfloat16>>
                      : propagate_cols<__nv_bfloat16, Hwd<__nv_bfloat16>>)(
        vol, disp_in, cost_in, disp_out, cost_out, H, W, D, forward, chunks, chunk, halo, pr, s);
  }
  const auto vol = hwd<float>(C, W, D);
  return (axis == 1 ? propagate_rows<float, Hwd<float>> : propagate_cols<float, Hwd<float>>)(
      vol, disp_in, cost_in, disp_out, cost_out, H, W, D, forward, chunks, chunk, halo, pr, s);
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
    return bf16 ? propagate_rows<__nv_bfloat16>(row_strips<__nv_bfloat16>(V, H, W, D, chunks),
                                                disp_in, cost_in, disp_out, cost_out, H, W, D,
                                                forward, chunks, chunk, halo, pr, s)
                : propagate_rows<float>(row_strips<float>(V, H, W, D, chunks), disp_in, cost_in,
                                        disp_out, cost_out, H, W, D, forward, chunks, chunk,
                                        halo, pr, s);
  }
  return bf16 ? propagate_cols<__nv_bfloat16>(col_strips<__nv_bfloat16>(V, H, W, D, chunks),
                                              disp_in, cost_in, disp_out, cost_out, H, W, D,
                                              forward, chunks, chunk, halo, pr, s)
              : propagate_cols<float>(col_strips<float>(V, H, W, D, chunks), disp_in, cost_in,
                                      disp_out, cost_out, H, W, D, forward, chunks, chunk, halo,
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
