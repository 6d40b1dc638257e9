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
// backend computes), the taps are __fadd_rn, the cast is round-to-nearest
// (cost_terms.cuh, shared with volume_build.cu).
//
// Bound: the (H, W, D) output. At 360x640x64 bf16 that is 29.5 MB written
// per frame, plus the four (H, W) float32 inputs read once (3.7 MB).
// Design: a block stages its tile's image rows with their halo in shared
// memory once (CostTile, cost_terms.cuh): kBand + 2 rows of L and GL, the
// same rows of R and GR widened by the block's disparities. Each warp then
// runs the row sweep below over the band, a run of kRun columns and 32
// disparities: every e-term once, in registers (1.52 e-terms an output), the
// images the only shared-memory reads. A lane of an output row writes its
// pixel's 8 costs of a step as one 16-byte vector (two in float32): a warp's
// store covers kBand rows x 64 contiguous bytes. The grid is one block per
// tile and camera: a batch of B stereo pairs, (B, H, W) images and a
// (B, H, W, D) volume, is one launch, the camera beside the disparity
// blocks in gridDim.z. A one-camera launch takes the kernel built without
// the camera (kBatch false), the code of the one-camera kernel before the
// batch: the camera's decode and pointer offsets cost the batched build
// 1.3-1.5% of its float32 device time at one camera (bf16 0-1.2% less), in
// turns in three runs on an H100 (PERF.md).

#include "cost_terms.cuh"

namespace {

constexpr int kBand = 6;             // output rows a block: a lane row each, and the halo
constexpr int kRun = 14;             // output columns a warp sweeps: 16 steps
constexpr int kRuns = 2;             // warps along x a block
constexpr int kDW = 32;              // disparities a warp: 4 lanes x 8
constexpr int kDGroups = 2;          // warps along d a block
constexpr int kTX = kRun * kRuns;    // columns a block
constexpr int kDB = kDW * kDGroups;  // disparities a block
constexpr int kThreads = 32 * kRuns * kDGroups;

// The row sweep. A warp's lane (r, c) = (lane / 4, lane % 4) holds staged
// row r of t (pixel row y0 - 1 + r: the band's rows and the halo row above
// and below) and the 8 disparities dbase .. dbase+7 (its own dbase). The
// warp walks the columns x = xs - 1 .. xs + kRun, one a step: step s
// computes the lane's 8 e-terms of column x = xs - 1 + s once, in
// registers, and passes them to the lanes of the rows above and below by
// shuffle (a column right of W - 1 takes column W - 1's, carried). From
// step 2 on, a lane of rows 1 .. kBand has its pixel's costs at column x - 1
// and hands them to sink(s, v): v[k] = C(y0 - 1 + r, xs - 2 + s, dbase + k),
// summed in STENCIL order. Every lane of the warp must call (the shuffles);
// a lane's rows, columns or disparities outside the image give values the
// sink drops. (Written as a function with a sink, the sweep took 9% less
// device time on the H100 than the same code written into the kernel, in
// turns in one run of cost_turns.py.)
template <typename Sink>
__device__ __forceinline__ void sweep_row(const CostTile& t, int xs, int dbase, int W,
                                          float alpha, float beta, Sink&& sink) {
  constexpr int kSteps = kRun + 2;
  static_assert((kBand + 2) * 4 == 32, "a lane per staged row and chunk of 8 d");
  constexpr int kWin = 8 + 7;  // R samples 8 steps of 8 disparities read
  const int r = (threadIdx.x & 31) >> 2;
  const float* l_row = t.l + r * t.cols + (xs - t.x0);  // step s: column xs - 1 + s
  const float* gl_row = t.gl + r * t.cols + (xs - t.x0);
  // Step s, disparity dbase + k: staged column xs - 1 + s - dbase - k -
  // (x0 - d_hi) = j0 + (s - k + 7).
  const int j0 = r * t.rw + (xs - 1 - dbase) - (t.x0 - t.d_hi) - 7;
  const float* r_row = t.r + j0;
  const float* gr_row = t.gr + j0;

  // Carried from step to step (x is the step's column): P = e(y, x-1) +
  // e(y-1, x-2), the first sum of the output at x-1; Dm2 = e(y+1, x-2);
  // Um1 = e(y-1, x-1); Dm1 = e(y+1, x-1).
  float P[8], Dm2[8], Um1[8], Dm1[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) P[k] = Dm2[k] = Um1[k] = Dm1[k] = 0.f;

#pragma unroll
  for (int g = 0; g < kSteps; g += 8) {
    const int n = min(8, kSteps - g);  // steps of this group
    // The group's R samples: step g + u, disparity dbase + k reads
    // w[u - k + 7].
    float wr[kWin], wg[kWin];
#pragma unroll
    for (int i = 0; i < kWin; ++i) {
      wr[i] = i < n + 7 ? r_row[g + i] : 0.f;
      wg[i] = i < n + 7 ? gr_row[g + i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (u >= n) break;
      const int s = g + u, x = xs - 1 + s;
      const float lv = l_row[s], glv = gl_row[s];
      float e[8], U[8], Dn[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) e[k] = e_value(lv, wr[u - k + 7], glv, wg[u - k + 7], alpha, beta);
      if (x < W) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          U[k] = __shfl_up_sync(0xffffffffu, e[k], 4);    // lane (r-1, c): row y-1
          Dn[k] = __shfl_down_sync(0xffffffffu, e[k], 4);  // lane (r+1, c): row y+1
        }
      } else {
        // Right of the image: the neighbours' e-terms are column W-1's.
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          U[k] = Um1[k];
          Dn[k] = Dm1[k];
        }
      }
      if (s >= 2) {
        // C(y, x-1) = ((((e(y,x-1) + e(y-1,x-2)) + e(y-1,x)) + e(y+1,x-2)) + e(y+1,x)).
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = __fadd_rn(__fadd_rn(__fadd_rn(P[k], U[k]), Dm2[k]), Dn[k]);
        sink(s, v);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        P[k] = __fadd_rn(e[k], Um1[k]);
        Dm2[k] = Dm1[k];
        Um1[k] = U[k];
        Dm1[k] = Dn[k];
      }
    }
  }
}

template <typename T, bool kBatch>
__global__ void __launch_bounds__(kThreads)
cost_volume_kernel(const float* __restrict__ iml, const float* __restrict__ imr,
                   const float* __restrict__ gl, const float* __restrict__ gr,
                   T* __restrict__ out, int H, int W, int D, float alpha, float beta, int vec) {
  __shared__ __align__(16) float img[CostTile::floats(kBand, kTX, kDB)];
  const int d_blocks = (D + kDB - 1) / kDB, cam = kBatch ? blockIdx.z / d_blocks : 0;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kBand;
  const int d_lo = (kBatch ? blockIdx.z % d_blocks : blockIdx.z) * kDB;
  if (kBatch) {  // this camera's images and volume
    const long long pixels = (long long)H * W;
    iml += cam * pixels;
    imr += cam * pixels;
    gl += cam * pixels;
    gr += cam * pixels;
    out += cam * pixels * D;
  }
  CostTile t;
  t.stage(img, iml, imr, gl, gr, H, W, y0, x0, kBand, kTX, d_lo, d_lo + kDB);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int xs = x0 + kRun * (warp % kRuns), dw = d_lo + kDW * (warp / kRuns);
  if (xs >= W || dw >= D) return;  // no barrier follows
  const int r = lane >> 2, dbase = dw + 8 * (lane & 3), y = y0 - 1 + r;
  const bool out_lane = r >= 1 && r <= kBand && y < H && dbase < D;
  T* o = out + ((long long)y * W + xs - 2) * D + dbase;  // step s writes column xs - 2 + s
  sweep_row(t, xs, dbase, W, alpha, beta, [&](int s, const float* v) {
    if (!out_lane || xs - 2 + s >= W) return;
    T* ox = o + (long long)s * D;
    if (vec) {
      store8(ox, v);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (dbase + k < D) store(ox, k, v[k]);
    }
  });
}

template <typename T>
int launch(const void* iml, const void* imr, const void* gl, const void* gr, void* out, int B,
           int H, int W, int D, float alpha, float beta, cudaStream_t s) {
  // 16-byte stores need whole chunks of 8 d at 16-byte aligned addresses
  // (each camera's volume then starts aligned too).
  const int vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((W + kTX - 1) / kTX, (H + kBand - 1) / kBand, B * ((D + kDB - 1) / kDB));
  (B > 1 ? cost_volume_kernel<T, true> : cost_volume_kernel<T, false>)<<<grid, kThreads, 0, s>>>(
      (const float*)iml, (const float*)imr, (const float*)gl, (const float*)gr, (T*)out, H, W, D,
      alpha, beta, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// B stereo pairs, (B, H, W) float32 images, into the (B, H, W, D) volume out.
extern "C" int opt_cost_volume(const void* iml, const void* imr, const void* gl,
                               const void* gr, void* out, int B, int H, int W, int D,
                               float alpha, float beta, int out_bf16, void* stream) {
  if ((long long)B * H * W * D == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return out_bf16 ? launch<__nv_bfloat16>(iml, imr, gl, gr, out, B, H, W, D, alpha, beta, s)
                  : launch<float>(iml, imr, gl, gr, out, B, H, W, D, alpha, beta, s);
}
