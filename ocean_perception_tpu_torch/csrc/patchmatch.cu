// PatchMatch one-side match for Hopper (sm_90a): one launch computes what one
// launch of the TPU's whole-frame kernel computes.
//
// Replaces: ocean_perception_tpu/ops/pallas/fused_patchmatch.py::
// pallas_patchmatch_fused (body _kernel) and its prebuilt-volume entry
// pallas_patchmatch_fused_prebuilt, with its per-pass unit
// ocean_perception_tpu/ops/pallas/propagate.py::pallas_propagate_pass (body
// _prop_kernel), which pm_pass launches alone. Semantics are those of
// stereo/patchmatch.py::_match_plain:
//   per iteration: foreground noise and cost refresh, then the directional
//   passes R+ C+ R- C-; after the last iteration MaskBackground.
//
// The volume is read through an accessor, in one of three layouts:
//   Hwd:        C[y, x, d], the (H, W, D) volume of cost_volume.cu;
//   RowStrips:  V_row[i, c, d, y] with x = c*chunk + i (volume_build.cu);
//   ColStrips:  V_col[i, c, d, x] with y = c*chunk + i (volume_build.cu).
// pm_match reads Hwd in every pass; pm_match_strip reads V_row in row passes
// (a warp's lanes are consecutive rows, so at equal d they read consecutive
// addresses) and V_col in column passes (lanes are consecutive columns).
// The TPU kernel kept both strip layouts resident in VMEM and moved the
// front between them with permutation matmuls; here the (H, W) fronts stay
// in one layout in device memory (1.4 MB at 720p, in the 50 MB L2) and only
// the volume reads change.
//
// One launch runs all 4 * iters passes: a persistent grid, as many blocks as
// can be resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// times the SM count, launched cooperatively) and no more than a pass has
// work items, with a grid-wide barrier (cooperative_groups grid sync) where
// a launch boundary stood. The fronts ping-pong between two (disp, cost)
// buffers: row passes write buffer 0, column passes buffer 1. Every front
// load goes through L2 only (ld.global.cg), since other blocks wrote the
// front earlier in the same launch. A row pass is one work item per
// (camera, kLanes rows, strip), a column pass one per (camera, kColumns
// columns, strip).
//
// A launch matches a batch of B cameras: B volumes, seeds, front pairs and
// outputs, one after another in memory, and one (H, W) noise image that all
// share. Each pass's items are the B cameras' items, which the blocks walk
// in one loop, so the grid barriers stay one a pass for the whole batch. A
// one-camera launch takes the kernel built without the camera (kBatch
// false): the camera's decode cost the batched build 2.5% of the match's
// device time at one camera, in turns on an H100 (PERF.md).
//
// pm_pass launches one of these passes alone, for one block of a frame whose
// rows are split across devices (parallel/stereo_sharded.py): the block is
// one y-strip of the frame, and between its passes the neighbouring blocks
// exchange the rows its column scans reach, so the passes cannot share one
// launch. It runs the same row_pass and col_pass as pm_match, with the
// fronts, the volume and the lanes' validity placed in the frame by the row
// offsets of Match (zero for a whole frame); the refresh is folded into R+
// and the mask into the last C- as in pm_match.
//
// The passes follow the reference CUDA design (patchmatch_gpu.cu:116-230)
// in what they compute: each (strip, lane) walks its chunk + 2*halo
// positions in order. Unlike the reference, every step reads the disparity
// and cost of its position from the PASS-START fronts and only the strip's
// own chunk is written, to the other buffer. That is the snapshot semantics
// of the JAX scan (halo positions read the values from before the pass), and
// it leaves no race between neighbouring strips.
//
// The refresh and the mask are folded into the passes:
//  - Each iteration's R+ pass stages, in place of its pass-start fronts,
//    the refreshed disparity max((d + noise*scale)*[d > 0], 0) and the cost
//    at it. The refresh is elementwise, so the halo positions that
//    neighbouring strips both compute agree bit for bit.
//  - The last C- pass writes, for each position of its own chunk, the
//    masked disparity: kept where its cost is below improve * cost(0) and
//    the pixel is interior. Its cost is the one the walk carries, not a
//    second gather: after the refresh and after every pass, cost[p] is the
//    volume at lookup_index(min(disp[p], x - pr)) for every pixel (the
//    refresh looks it up there; a pass keeps a position's pass-start pair or
//    takes a candidate min(carry, x - pr) with the cost at it).
//
// What bounds a pass is latency, not bytes (3.4 MB, 1.0 us at 720p): each
// step's volume load needs the previous step's carry, so a walk is a chain
// of 50 (row pass) or 34 (column pass) dependent L2 round trips, and a
// warp's gather of 32 scattered costs also holds its SM's load pipe for a
// while. The TPU kernel hid the chain by copying every position's whole
// (chunks, N, D) slab to VMEM, reading the whole volume each pass (11x the
// bound here). The two kinds of pass are done differently (PERF.md):
//  - Row passes (lanes are rows). A work item is kLanes rows of one strip.
//    All kThreads threads first stage the rows' pass-start disparities and
//    costs in shared memory, kSegment positions at a time, reading runs
//    along the rows (a plain walk reads them a row apart), and the outputs
//    go back the same way. Its first kLanes threads walk, so a gather
//    touches kLanes lines and the 360 rows of a 720p pass spread over 23
//    items a strip. They speculate K = Vol::kSpec steps at a time: within a
//    group of K steps after carry c, step i's candidate disparity is
//    min(carry_{i-1}, lim_i), lim = x - pr, which is min(c, lim_0..lim_i) if
//    no step of the group failed before i, or min(cur_d_f, lim_{f+1}..lim_i)
//    if step f failed last. All K(K+1)/2 of these are known when the group
//    starts, so their cost loads go out together, one round trip, and the
//    walk then picks, step by step with selects, the one its compares chose.
//    The disparity is recomputed in order as before, so the pass is the
//    plain walk's bit for bit. Steps outside the CUDA loop bounds, and rows
//    outside [pr, H-pr-1], fail for certain and load nothing. In (H, W, D)
//    the candidates of a step share the step's pixel, D contiguous costs; in
//    V_row each is a line of its own, and speculating there costs more than
//    the round trips it saves.
//  - Column passes (lanes are columns): one thread per (strip, column) walks
//    its positions over device memory. Its lanes' fronts and candidates are
//    already neighbours in memory, and neither staging nor speculating beat
//    it on the card.
//
// All costs are compared as float32 (exact for bf16 values); lookups round
// half to even (rintf) like jnp.round; no floating-point operation here can
// be contracted, and the two products (noise * scale, exact for
// power-of-two noise scales; improve * cost(0)) are pinned with intrinsics.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// A front load, through L2 only.
__device__ __forceinline__ float ld_front(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_front(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// Index of the clamped disparity min(d, x - pr), rounded half to even and
// clipped to [0, D-1] (stereo/patchmatch.py _lookup_cost).
__device__ __forceinline__ int lookup_index(float d_eff, int D) {
  float r = rintf(d_eff);
  r = fminf(fmaxf(r, 0.f), (float)(D - 1));
  return (int)r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Foreground noise (stereo/patchmatch.py add_foreground_noise).
__device__ __forceinline__ float refreshed(float d, float noise, float scale) {
  const float mask = d > 0.f ? 1.f : 0.f;
  return fmaxf(__fmul_rn(__fadd_rn(d, __fmul_rn(noise, scale)), mask), 0.f);
}

// Steps of a row pass's walk resolved per round trip to the volume (see the
// note above), by layout: 4 on (H, W, D), none on V_row. Picked on an H100
// with the passes as launches of their own (PERF.md).
constexpr int kSpecHwd = 4;
constexpr int kSpecRowStrips = 1;

// The three volume layouts. at(y, x, d) is the cost of disparity d at pixel
// (y, x); x is the column, y the row.
// at(y, x, d) is the volume of the camera set by camera(), H*W*D elements
// (volume) after the previous one's.
template <typename T>
struct Hwd {
  static constexpr int kSpec = kSpecHwd;
  const T* C;
  int W, D;
  long long volume;
  __device__ __forceinline__ Hwd camera(int b) const { return {C + b * volume, W, D, volume}; }
  __device__ __forceinline__ T at(int y, int x, int d) const {
    return C[((long long)y * W + x) * D + d];
  }
};

// (H, W, D) rows from frame row y0 on: at(y, ...) with y a row of the frame.
// A block of a sharded frame (pm_pass) holds its own rows and those its
// column scan reaches.
template <typename T>
struct HwdFrom {
  const T* C;
  int W, D, y0;
  __device__ __forceinline__ T at(int y, int x, int d) const {
    return C[((long long)(y - y0) * W + x) * D + d];
  }
};

template <typename T>
struct RowStrips {  // V_row (chunk, chunks, D, H), x = c*chunk + i
  static constexpr int kSpec = kSpecRowStrips;
  const T* V;
  int H, D, chunk, chunks;
  long long volume;
  __device__ __forceinline__ RowStrips camera(int b) const {
    return {V + b * volume, H, D, chunk, chunks, volume};
  }
  __device__ __forceinline__ T at(int y, int x, int d) const {
    const int i = x % chunk, c = x / chunk;
    return V[((long long)(i * chunks + c) * D + d) * H + y];
  }
};

template <typename T>
struct ColStrips {  // V_col (chunk, chunks, D, W), y = c*chunk + i
  const T* V;
  int W, D, chunk, chunks;
  long long volume;
  __device__ __forceinline__ ColStrips camera(int b) const {
    return {V + b * volume, W, D, chunk, chunks, volume};
  }
  __device__ __forceinline__ T at(int y, int x, int d) const {
    const int i = y % chunk, c = y / chunk;
    return V[((long long)(i * chunks + c) * D + d) * W + x];
  }
};

// One launch's matches, B cameras: their inputs, front buffers and outputs.
template <typename T>
struct Match {
  const float* seed;   // (B, H, W) starting disparities
  const float* noise;  // (H, W) unit noise, scaled by scale0 / 2^it in iteration it
  float* disp;         // (B, 2, H, W) fronts: row passes write buffer 0, column passes 1
  T* cost;             // (B, 2, H, W)
  float* out;          // (B, H, W) masked disparities
  int B, H, W, D, pr, halo, chunks_x, chunk_x, chunks_y, chunk_y, iters;
  float scale0, improve;
  // Where the fronts sit in the frame (all 0 and rows = H for a whole frame).
  // Row passes: row 0 of the fronts is frame row row0 of a frame of rows
  // rows, which decides each lane's validity. Column passes: row 0 of the
  // input fronts is frame row front_row0, of the outputs frame row out_row0.
  int row0, rows, front_row0, out_row0;
};

constexpr int kLanes = 16;     // rows of a row-pass work item, one walking thread each
constexpr int kThreads = 128;  // threads of a block
constexpr int kColumns = 128;  // columns of a column-pass work item, one thread each (<= kThreads)
constexpr int kSegment = 64;   // scan positions staged in shared memory at a time
constexpr int kBatch = 16;     // front elements a thread loads before it stores any
constexpr int kMinBlocks = 3;  // resident blocks an SM must hold: 396 >= 368 row items at 720p

// One row pass (scan along x) over rows [y0, y0 + kLanes) of strip c. With
// kRefresh (an iteration's R+ pass) the pass-start fronts are the refreshed
// disp_in and the cost at it, and cost_in is not read. Front tiles
// td/tc[segment index][row], padded against bank conflicts.
template <bool kRefresh, typename T, typename Vol>
__device__ __forceinline__ void row_pass(const Vol& vol, const Match<T>& a, const float* disp_in,
                                         const T* cost_in, float scale, float* disp_out,
                                         T* cost_out, bool forward, int y0, int c,
                                         float (*td)[kLanes + 1], T* tc) {
  constexpr int K = Vol::kSpec;
  const int H = a.H, W = a.W, D = a.D, pr = a.pr, halo = a.halo, chunk = a.chunk_x;
  const int nl = min(kLanes, H - y0);
  const int l = threadIdx.x;
  const int y = y0 + l;
  const int w = chunk + 2 * halo;
  const int start = c * chunk - halo;
  const int lo = max(start, pr);
  const int hi = min((c + 1) * chunk + halo, W - pr - 1);
  const bool walks = l < nl;  // rows outside [pr, H-pr-1] walk too, failing every step
  const bool row_ok = y + a.row0 >= pr && y + a.row0 <= a.rows - pr - 1;
  // Walk step s is in-strip index j(s), at column clamp(start + j(s)).
  auto j_of = [&](int s) { return forward ? s : w - 1 - s; };
  auto x_of = [&](int s) { return clampi(start + j_of(s), 0, W - 1); };

  // The front starts at the predecessor of the strip's first position.
  float carry = 0.f;
  if (walks) {
    const int first = clampi(start + (forward ? 0 : w - 1), 0, W - 1);
    const long long p = (long long)y * W + clampi(first + (forward ? -1 : 1), 0, W - 1);
    carry = ld_front(disp_in + p);
    if (kRefresh) carry = refreshed(carry, a.noise[p], scale);
  }

  for (int base = 0; base < w; base += kSegment) {
    const int n = min(kSegment, w - base);
    // Consecutive threads take consecutive positions of a row, and each has
    // kBatch loads in flight before it stores one.
    for (int e0 = l; e0 < n * nl; e0 += kThreads * kBatch) {
      float dv[kBatch];
      T cv[kBatch];
      if (kRefresh) {
        float nv[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int e = e0 + b * kThreads;
          if (e < n * nl) {
            const long long p = (long long)(y0 + e / n) * W + x_of(base + e % n);
            dv[b] = ld_front(disp_in + p);
            nv[b] = a.noise[p];
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int e = e0 + b * kThreads;
          if (e < n * nl) {
            const int x = x_of(base + e % n);
            dv[b] = refreshed(dv[b], nv[b], scale);
            cv[b] = vol.at(y0 + e / n, x, lookup_index(fminf(dv[b], (float)(x - pr)), D));
          }
        }
      } else {
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int e = e0 + b * kThreads;
          if (e < n * nl) {
            const long long p = (long long)(y0 + e / n) * W + x_of(base + e % n);
            dv[b] = ld_front(disp_in + p);
            cv[b] = ld_front(cost_in + p);
          }
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

// One column pass (scan along y) of column x in strip c. With kMask (the
// match's last pass) each position of the strip's own chunk writes the
// masked disparity to out instead of its fronts.
template <bool kMask, typename T, typename Vol>
__device__ __forceinline__ void col_pass(const Vol& vol, const Match<T>& a, const float* disp_in,
                                         const T* cost_in, float* disp_out, T* cost_out,
                                         float* out, bool forward, int x, int c) {
  const int H = a.H, W = a.W, D = a.D, pr = a.pr, halo = a.halo, chunk = a.chunk_y;
  const int w = chunk + 2 * halo;
  const int start = c * chunk - halo;
  const int lo = max(start, pr);
  const int hi = min((c + 1) * chunk + halo, H - pr - 1);
  const bool col_ok = x >= pr && x <= W - pr - 1;

  // The front starts at the predecessor of the strip's first position.
  const int first = clampi(start + (forward ? 0 : w - 1), 0, H - 1);
  const int pred = clampi(first + (forward ? -1 : 1), 0, H - 1);
  float carry = ld_front(disp_in + (long long)(pred - a.front_row0) * W + x);

  for (int s = 0; s < w; ++s) {
    const int j = forward ? s : w - 1 - s;
    const int u = start + j;
    const int y = clampi(u, 0, H - 1);
    const long long p = (long long)(y - a.front_row0) * W + x;
    const float cand_d = fminf(carry, (float)(x - pr));
    const T cand_c = vol.at(y, x, lookup_index(cand_d, D));
    const float cur_d = ld_front(disp_in + p);
    const T cur_c = ld_front(cost_in + p);
    const bool better = u >= lo && u < hi && col_ok && to_f(cand_c) < to_f(cur_c);
    carry = better ? cand_d : cur_d;
    if (j >= halo && j < halo + chunk) {
      const T cost = better ? cand_c : cur_c;
      const long long q = (long long)(y - a.out_row0) * W + x;
      if (kMask) {
        const bool keep = to_f(cost) < __fmul_rn(a.improve, to_f(vol.at(y, x, 0)));
        const bool interior = y >= pr && y <= H - pr - 1 && col_ok;
        out[q] = keep && interior ? carry : 0.f;
      } else {
        disp_out[q] = carry;
        cost_out[q] = cost;
      }
    }
  }
}

// Every pass of the match, in one cooperative launch; pass ph is pass
// ph % 4 (R+ C+ R- C-) of iteration ph / 4. Item i of a pass is item
// i % items of camera i / items.
template <typename T, typename RowVol, typename ColVol, bool kBatch>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pm_match_kernel(RowVol rvol, ColVol cvol, Match<T> a) {
  __shared__ float td[kSegment][kLanes + 1];
  __shared__ __align__(4) unsigned char tc_raw[kSegment * (kLanes + 1) * sizeof(T)];
  T* tc = reinterpret_cast<T*>(tc_raw);
  const int row_blocks = (a.H + kLanes - 1) / kLanes;
  const int col_tiles = (a.W + kColumns - 1) / kColumns;
  const int row_items = row_blocks * a.chunks_x, col_items = col_tiles * a.chunks_y;
  const long long hw = (long long)a.H * a.W;
  const int B = kBatch ? a.B : 1;
  for (int ph = 0; ph < 4 * a.iters; ++ph) {
    if (ph > 0) cg::this_grid().sync();
    const int it = ph / 4, k = ph % 4;
    const bool forward = k < 2;
    if (k % 2 == 0) {  // R+ (with the refresh) or R-: buffer 1 (or the seed) to buffer 0
      const float scale = ldexpf(a.scale0, -it);
      for (int item = blockIdx.x; item < B * row_items; item += gridDim.x) {
        const int b = kBatch ? item / row_items : 0, r = item - b * row_items;
        const int y0 = r % row_blocks * kLanes, c = r / row_blocks;
        float* disp = a.disp + 2 * b * hw;  // this camera's two buffers
        T* cost = a.cost + 2 * b * hw;
        const float* disp_in = ph == 0 ? a.seed + b * hw : disp + hw;
        if (k == 0) {
          row_pass<true>(rvol.camera(b), a, disp_in, cost + hw, scale, disp, cost, forward, y0,
                         c, td, tc);
        } else {
          row_pass<false>(rvol.camera(b), a, disp_in, cost + hw, scale, disp, cost, forward, y0,
                          c, td, tc);
        }
      }
    } else {  // C+ or C- (with the mask, last): buffer 0 to buffer 1 (or the output)
      const bool last = ph == 4 * a.iters - 1;
      for (int item = blockIdx.x; item < B * col_items; item += gridDim.x) {
        const int b = kBatch ? item / col_items : 0, r = item - b * col_items;
        const int x = r % col_tiles * kColumns + threadIdx.x, c = r / col_tiles;
        if (threadIdx.x >= kColumns || x >= a.W) continue;
        float* disp = a.disp + 2 * b * hw;
        T* cost = a.cost + 2 * b * hw;
        if (last) {
          col_pass<true>(cvol.camera(b), a, disp, cost, disp + hw, cost + hw, a.out + b * hw,
                         forward, x, c);
        } else {
          col_pass<false>(cvol.camera(b), a, disp, cost, disp + hw, cost + hw, a.out + b * hw,
                          forward, x, c);
        }
      }
    }
  }
}

// One pass of one block of a sharded frame (pm_pass): the block owns frame
// rows [a.row0, a.row0 + chunk) and is one y-strip of the frame. kAxis 1 is
// a row pass over the block's rows in a.chunks_x x-strips, a work item a
// block of threads, as in pm_match (kFold: the iteration's refresh, R+);
// kAxis 0 a column pass of the block's strip (kFold: the mask, the last C-),
// a thread a column. Its inputs and outputs are those of the pass in
// pm_match, the fronts moved by the offsets of Match.
template <typename T, int kAxis, bool kFold>
__global__ void __launch_bounds__(kThreads)
pm_pass_kernel(Hwd<T> rvol, HwdFrom<T> cvol, Match<T> a, const float* disp_in, const T* cost_in,
               float* disp_out, T* cost_out, float scale, bool forward, int strip) {
  if constexpr (kAxis == 1) {
    __shared__ float td[kSegment][kLanes + 1];
    __shared__ __align__(4) unsigned char tc_raw[kSegment * (kLanes + 1) * sizeof(T)];
    const int row_blocks = (a.H + kLanes - 1) / kLanes;
    const int y0 = blockIdx.x % row_blocks * kLanes, c = blockIdx.x / row_blocks;
    row_pass<kFold>(rvol, a, disp_in, cost_in, scale, disp_out, cost_out, forward, y0, c, td,
                    reinterpret_cast<T*>(tc_raw));
  } else {
    const int x = blockIdx.x * kColumns + threadIdx.x;
    if (threadIdx.x >= kColumns || x >= a.W) return;
    col_pass<kFold>(cvol, a, disp_in, cost_in, disp_out, cost_out, disp_out, forward, x, strip);
  }
}

// Blocks of kernel that can be resident at once on the current device.
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return per_sm * sms;
}

template <typename T, typename RowVol, typename ColVol>
int match(RowVol rvol, ColVol cvol, const Match<T>& a, cudaStream_t s) {
  const bool batch = a.B > 1;
  const auto kernel = batch ? pm_match_kernel<T, RowVol, ColVol, true>
                            : pm_match_kernel<T, RowVol, ColVol, false>;
  const int row_items = a.B * ((a.H + kLanes - 1) / kLanes * a.chunks_x);
  const int col_items = a.B * ((a.W + kColumns - 1) / kColumns * a.chunks_y);
  // Counted once on the current device, for each of the two kernels.
  static const int resident[2] = {resident_blocks(pm_match_kernel<T, RowVol, ColVol, false>),
                                  resident_blocks(pm_match_kernel<T, RowVol, ColVol, true>)};
  if (resident[batch] < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.gridDim = dim3(std::min(resident[batch], std::max(row_items, col_items)));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, rvol, cvol, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
Match<T> match_args(const void* seed, const void* noise, void* disp, void* cost, void* out,
                    int B, int H, int W, int D, int chunks_x, int chunks_y, int halo, int pr,
                    int iters, float scale0, float improve) {
  Match<T> a;
  a.seed = (const float*)seed;
  a.noise = (const float*)noise;
  a.disp = (float*)disp;
  a.cost = (T*)cost;
  a.out = (float*)out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.D = D;
  a.pr = pr;
  a.halo = halo;
  a.chunks_x = chunks_x;
  a.chunk_x = W / chunks_x;
  a.chunks_y = chunks_y;
  a.chunk_y = H / chunks_y;
  a.iters = iters;
  a.scale0 = scale0;
  a.improve = improve;
  a.row0 = 0;
  a.rows = H;
  a.front_row0 = 0;
  a.out_row0 = 0;
  return a;
}

template <typename T>
int block_pass(const void* C, const void* disp_in, const void* cost_in, const void* noise,
               void* disp_out, void* cost_out, int H, int W, int D, int row0, int chunk,
               int vol_row0, int front_row0, int chunks_x, int halo, int pr, int axis,
               int forward, int fold, float scale, float improve, cudaStream_t s) {
  Match<T> a = match_args<T>(nullptr, noise, nullptr, nullptr, nullptr, 1, H, W, D, chunks_x,
                             H / chunk, halo, pr, 1, scale, improve);
  a.chunk_y = chunk;
  a.row0 = row0;
  a.front_row0 = front_row0;
  a.out_row0 = row0;
  // A row pass walks the block's own rows: its fronts, noise and volume
  // from there on, and lanes counted from the block's first row.
  const Hwd<T> rvol{(const T*)C + (long long)(row0 - vol_row0) * W * D, W, D, 0};
  const HwdFrom<T> cvol{(const T*)C, W, D, vol_row0};
  const float* din = (const float*)disp_in;
  const T* cin = (const T*)cost_in;
  int blocks;
  if (axis == 1) {
    a.H = chunk;
    din += (long long)(row0 - front_row0) * W;
    cin += (long long)(row0 - front_row0) * W;
    blocks = (chunk + kLanes - 1) / kLanes * chunks_x;
  } else {
    blocks = (W + kColumns - 1) / kColumns;
  }
  const auto kernel = axis == 1 ? (fold ? pm_pass_kernel<T, 1, true> : pm_pass_kernel<T, 1, false>)
                                : (fold ? pm_pass_kernel<T, 0, true> : pm_pass_kernel<T, 0, false>);
  kernel<<<blocks, kThreads, 0, s>>>(rvol, cvol, a, din, cin, (float*)disp_out, (T*)cost_out,
                                     scale, forward != 0, row0 / chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int match_hwd(const void* C, const void* seed, const void* noise, void* disp, void* cost,
              void* out, int B, int H, int W, int D, int chunks_x, int chunks_y, int halo, int pr,
              int iters, float scale0, float improve, cudaStream_t s) {
  const Hwd<T> vol{(const T*)C, W, D, (long long)H * W * D};
  return match(vol, vol, match_args<T>(seed, noise, disp, cost, out, B, H, W, D, chunks_x,
                                       chunks_y, halo, pr, iters, scale0, improve), s);
}

template <typename T>
int match_strips(const void* V_row, const void* V_col, const void* seed, const void* noise,
                 void* disp, void* cost, void* out, int B, int H, int W, int D, int chunks_x,
                 int chunks_y, int halo, int pr, int iters, float scale0, float improve,
                 cudaStream_t s) {
  const long long volume = (long long)H * W * D;
  const RowStrips<T> rvol{(const T*)V_row, H, D, W / chunks_x, chunks_x, volume};
  const ColStrips<T> cvol{(const T*)V_col, W, D, H / chunks_y, chunks_y, volume};
  return match(rvol, cvol, match_args<T>(seed, noise, disp, cost, out, B, H, W, D, chunks_x,
                                         chunks_y, halo, pr, iters, scale0, improve), s);
}

}  // namespace

// The whole one-side match of B cameras over their (B, H, W, D) volume C.
// seed is (B, H, W), noise one (H, W) image for all; disp and cost are the
// front buffers, (B, 2, H, W) each, in float32 and in C's dtype; out is the
// (B, H, W) masked disparity. The strips tile the axes: chunks_x divides W
// and chunks_y divides H.
extern "C" int opt_pm_match(const void* C, const void* seed, const void* noise, void* disp,
                            void* cost, void* out, int B, int H, int W, int D, int chunks_x,
                            int chunks_y, int halo, int pr, int iters, float scale0,
                            float improve, int bf16, void* stream) {
  if ((long long)B * H * W == 0 || iters < 1) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (bf16 ? match_hwd<__nv_bfloat16> : match_hwd<float>)(
      C, seed, noise, disp, cost, out, B, H, W, D, chunks_x, chunks_y, halo, pr, iters, scale0,
      improve, s);
}

// The match over the strip layouts: V_row (B, W / chunks_x, chunks_x, D, H)
// for row passes, V_col (B, H / chunks_y, chunks_y, D, W) for column passes;
// the passes' strips are the layouts' strips.
extern "C" int opt_pm_match_strip(const void* V_row, const void* V_col, const void* seed,
                                  const void* noise, void* disp, void* cost, void* out, int B,
                                  int H, int W, int D, int chunks_x, int chunks_y, int halo,
                                  int pr, int iters, float scale0, float improve, int bf16,
                                  void* stream) {
  if ((long long)B * H * W == 0 || iters < 1) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (bf16 ? match_strips<__nv_bfloat16> : match_strips<float>)(
      V_row, V_col, seed, noise, disp, cost, out, B, H, W, D, chunks_x, chunks_y, halo, pr, iters,
      scale0, improve, s);
}

// One directional pass of one block of a frame of H rows split into blocks
// of chunk rows, the block that owns rows [row0, row0 + chunk) (row0 a
// multiple of chunk). C holds the block's (H, W, D) volume rows from frame
// row vol_row0 on, as many as the pass reads; disp_in and cost_in (float32
// and C's dtype) the pass-start fronts from frame row front_row0 on. axis 1
// is a row pass over the block's rows in chunks_x x-strips; fold adds the
// iteration's refresh (noise, the block's (chunk, W) rows of the unit noise
// image, times scale), and cost_in is not read. axis 0 is a column pass with
// the block as the one y-strip, its positions and their validity counted in
// frame rows; fold masks the result (improve) and writes only disp_out.
// disp_out and cost_out are the block's (chunk, W) fronts after the pass.
extern "C" int opt_pm_pass(const void* C, const void* disp_in, const void* cost_in,
                           const void* noise, void* disp_out, void* cost_out, int H, int W, int D,
                           int row0, int chunk, int vol_row0, int front_row0, int chunks_x,
                           int halo, int pr, int axis, int forward, int fold, float scale,
                           float improve, int bf16, void* stream) {
  if ((long long)chunk * W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (bf16 ? block_pass<__nv_bfloat16> : block_pass<float>)(
      C, disp_in, cost_in, noise, disp_out, cost_out, H, W, D, row0, chunk, vol_row0, front_row0,
      chunks_x, halo, pr, axis, forward, fold, scale, improve, s);
}
