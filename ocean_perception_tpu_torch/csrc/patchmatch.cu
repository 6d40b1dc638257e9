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
//    already neighbours in memory, and over pm_match's strips of 34
//    positions neither staging nor speculating beat it on the card.
//
// pm_pass walks differently: a warp a scan line (PERF.md). Its column pass
// is one strip a block, chunk + 2*halo positions (190 at N=2, 100 at N=4 on
// the 720p block). With a thread a column (col_pass) only W threads walk (5
// blocks at W=640), each step a chain of three L2 trips (the gather, whose
// address needs the carry, then the front loads behind the previous step's
// stores): 80-112 us a launch at N=2 on an H100, against a byte bound of
// 0.5 us. What a walk visits does not depend on the carry; only the index
// within a pixel's line of D costs does. So a warp walks one scan line (a
// column, or one row of an x-strip; kWalkWarps walks a block) in batches of
// kWalkWords / NW steps: while it walks one batch, the next batch's lines
// (NW * 128 bytes at most) go to a shared-memory ring by 16-byte cp.async,
// and its pass-start fronts to registers, one step a lane. Every lane runs
// the same compares, so the carry stays uniform. The lookups leave the chain
// (see walk): the lane of step i looks up, in its own line and before the
// walk, the two candidate costs that follow a failure or one success, and
// the third, after two successes, is looked up two steps ahead; the mask's
// cost(0) and the refresh's lookup come from the same line. A walk reads its
// lines once: 190 * 640 * 128 B = 15.6 MB a column pass at N=2 (4.6 us at
// 3.35 TB/s; the block's volume stays in the 50 MB L2 between passes). What
// bounds it now is the walk's own issue, about 90-100 cycles a step of one
// warp's in-order instructions (clock64 stamps) for 2 on the chain: 16 us a
// C+/C- launch at N=2, 11 us at N=4. Variants, in turns (pass_turns.py):
// kWalkWords, kWalkWarps, kWalkRows (row passes as row_pass). Lines in
// registers looked up by shuffles, and lines by cp.async.bulk (issued one
// lane at a time), were slower. A line that is not whole 16-byte pieces, or
// longer than 512 bytes, takes col_pass and row_pass.
//
// All costs are compared as float32 (exact for bf16 values); lookups round
// half to even (rintf) like jnp.round; no floating-point operation here can
// be contracted, and the two products (noise * scale, exact for
// power-of-two noise scales; improve * cost(0)) are pinned with intrinsics.

#include <algorithm>
#include <cstdint>

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

// pm_pass's walks: a warp a scan line (see the note above).
constexpr int kWalkWords = 32;  // a batch is kWalkWords / NW steps: 4 KB of lines a walk
constexpr int kWalkRows = 1;    // 0: row passes run row_pass, a block a kLanes rows
constexpr int kWalkWarps = 2;   // walks of a block (<= kThreads / 32)
constexpr unsigned kFull = 0xffffffffu;

// A cost as a float (a bf16 cost is exact, its low 16 bits zero) and back to
// the element's bits; a line's costs are read from its 4-byte words.
template <typename T>
struct Cost;
template <>
struct Cost<float> {
  static constexpr int kShift = 0;  // log2 of the elements of a word
  // The element's bits, and the cost they hold (kept apart so that the
  // conversion is not placed right behind the load).
  __device__ static __forceinline__ unsigned load_bits(const float* p) {
    return __float_as_uint(__ldg(p));
  }
  __device__ static __forceinline__ float value(unsigned bits) { return __uint_as_float(bits); }
  __device__ static __forceinline__ void store(float* p, float c) { *p = c; }
  // Permute selector that moves element e's bits of a word into place.
  __device__ static __forceinline__ unsigned selector(int) { return 0x3210u; }
};
template <>
struct Cost<__nv_bfloat16> {
  static constexpr int kShift = 1;
  __device__ static __forceinline__ unsigned load_bits(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static __forceinline__ float value(unsigned bits) { return __uint_as_float(bits << 16); }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, float c) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)(__float_as_uint(c) >> 16);
  }
  // The high half of word: element e & 1 into the high half, zeros below.
  __device__ static __forceinline__ unsigned selector(int e) { return e & 1 ? 0x3244u : 0x1044u; }
};

// A batch of K steps' lines in the warp's shared-memory ring, line i at
// w[i * kStride], filled by 16-byte cp.async: the lane of step i works out
// the line's address and the warp copies it. at(i, e) is cost e of line i.
template <typename T, int K, int NW>
struct Lines {
  static constexpr int kStride = NW * 32 + 4;  // words a line, padded by 16 bytes
  static constexpr int kWords = K * kStride;
  unsigned* w;
  // mine: the line of this lane's step (lanes >= live: of the last step).
  __device__ __forceinline__ void load(const unsigned* mine, int nwords, int live, int lane) {
    __syncwarp();  // every lane has read the batch this one replaces
    constexpr int kChunks = NW * 8;  // 16-byte pieces a line slot holds
#pragma unroll
    for (int g0 = 0; g0 < K * kChunks; g0 += 32) {
      const int g = g0 + lane, i = g / kChunks, c = g % kChunks;
      const unsigned long long src = __shfl_sync(kFull, (unsigned long long)mine, i);
      if (i < live && c < nwords / 4) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         (unsigned)__cvta_generic_to_shared(w + i * kStride + 4 * c)),
                     "l"(src + 16ull * c) : "memory");
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  // This batch's copies are done; with next, the next batch's may still run.
  __device__ __forceinline__ void ready(bool next) const {
    if (next) {
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncwarp();
  }
  __device__ __forceinline__ float at(int i, int e) const {
    return __uint_as_float(
        __byte_perm(w[i * kStride + (e >> Cost<T>::kShift)], 0, Cost<T>::selector(e)));
  }
};

// One scan line of a pm_pass walked by a warp: a column of the block's
// strip (kAxis 0) or one row of an x-strip (kAxis 1). Step s is position
// u = start + j, j = s (forward) or n - 1 - s, at v = clamp(u, 0, len - 1);
// position v is volume line vol + v * step and front and output element
// front + v * step and out + v * step.
struct ScanLine {
  long long vol, front, out;
  int step, n, len, start, lo, hi, halo, chunk;
  bool lane_ok;  // the column (kAxis 0) or the row (kAxis 1) is inside [pr, size - pr - 1]
  float lim;     // a column's x - pr
};

// What a step of a batch needs from its lane, in the warp's shared memory
// (see walk): its lookups (ef in bits 0-9, lookup_index(lim) in 10-19, the
// validity in bit 30), its pass-start cost and disparity, and the costs A0
// and A1 (bf16: A0 in the high half of one word, A1 in the low half). A
// walk's D is at most 256 (a line of 512 bytes).
template <typename T>
struct __align__(16) Step {
  unsigned pk, cost, disp, a0, a1, unused[3];
  __device__ __forceinline__ static Step make(unsigned pk, float c, float d, float a0, float a1) {
    return {pk, __float_as_uint(c), __float_as_uint(d), __float_as_uint(a0), __float_as_uint(a1),
            {0u, 0u, 0u}};
  }
  __device__ __forceinline__ float A0() const { return __uint_as_float(a0); }
  __device__ __forceinline__ float A1() const { return __uint_as_float(a1); }
};
template <>
struct __align__(16) Step<__nv_bfloat16> {
  unsigned pk, cost, disp, a01;
  __device__ __forceinline__ static Step make(unsigned pk, float c, float d, float a0, float a1) {
    return {pk, __float_as_uint(c), __float_as_uint(d),
            __byte_perm(__float_as_uint(a0), __float_as_uint(a1), 0x3276)};
  }
  __device__ __forceinline__ float A0() const { return __uint_as_float(a01 & 0xffff0000u); }
  __device__ __forceinline__ float A1() const { return __uint_as_float(a01 << 16); }
};
constexpr int kField = 10;
constexpr unsigned kFieldMask = (1u << kField) - 1;

// The walk of one scan line by one warp. Step i's candidate is lookup_index
// (min(carry, lim_i)). With Ll_i = lookup_index(lim_i), monotone along the
// walk, and lookup_index monotone, that index is min(H_i, Ll_i): H_i is
// ef_{f+1} = lookup_index(min(d_f, lim_{f+1})) of the last failed step f
// (d_f its pass-start disparity), and H_i = better_{i-1} ? H_{i-1} : ef_i.
// So the candidate's cost is A0_i = line_i[ef_i] after a failure, A1_i =
// line_i[min(ef_{i-1}, Ll_i)] after one success that followed a failure, and
// line_i[min(H_{i-2}, Ll_i)] after two successes. The lane of step i looks
// up A0 and A1 in its own line before the walk; the third lookup waits only
// on the compare two steps back, so the chain of a step is a select and a
// compare.
template <typename T, int kAxis, bool kFold, int NW>
__device__ __forceinline__ void walk(const T* __restrict__ C, const float* __restrict__ disp_in,
                                     const T* __restrict__ cost_in,
                                     const float* __restrict__ noise, float* __restrict__ disp_out,
                                     T* __restrict__ cost_out, const ScanLine& sl,
                                     Lines<T, kWalkWords / NW, NW>& A,
                                     Lines<T, kWalkWords / NW, NW>& B, Step<T>* info, int D,
                                     int pr,
                                     float scale, float improve, bool forward) {
  constexpr int K = kWalkWords / NW;
  static_assert(K >= 1 && K <= 32, "a batch's steps are one a lane");
  constexpr bool kRefresh = kFold && kAxis == 1, kMask = kFold && kAxis == 0;
  using L_t = Lines<T, K, NW>;
  const int lane = threadIdx.x & 31;
  const int n = sl.n, nwords = D * (int)sizeof(T) / 4;
  const unsigned* Cw = reinterpret_cast<const unsigned*>(C);
  auto u_of = [&](int s) { return sl.start + (forward ? s : n - 1 - s); };
  auto v_of = [&](int s) { return clampi(u_of(s), 0, sl.len - 1); };

  // The batch of steps s0 .. s0 + K - 1: its lines into L, its pass-start
  // fronts (the noise instead of the cost with kRefresh) one step a lane,
  // as bits until the batch is walked. Every load is unconditional, from
  // the last step's place past n: a conditional one would be merged by a
  // select that waits for it.
  auto load = [&](int s0, L_t& L, float& fd, unsigned& fc) {
    const int v = v_of(min(s0 + lane, n - 1));
    L.load(Cw + (sl.vol + (long long)v * sl.step) * nwords, nwords, n - s0, lane);
    const long long f = sl.front + (long long)v * sl.step;
    fd = __ldg(disp_in + f);
    fc = kRefresh ? __float_as_uint(__ldg(noise + f)) : Cost<T>::load_bits(cost_in + f);
  };

  // The front starts at the predecessor of the strip's first position.
  const int first = clampi(sl.start + (forward ? 0 : n - 1), 0, sl.len - 1);
  const long long pred =
      sl.front + (long long)clampi(first + (forward ? -1 : 1), 0, sl.len - 1) * sl.step;
  float carry = __ldg(disp_in + pred);
  if (kRefresh) carry = refreshed(carry, __ldg(noise + pred), scale);
  // Carried from step to step: the last two compares, H of the last two
  // steps; and from batch to batch, the last step's d and ef.
  bool b1 = false, b2 = false;
  int H1 = 0, H2 = 0;
  float prev_d = carry;
  int prev_ef = 0;

  // Walk the batch from s0 in L. Lane k first works out step s0 + k's
  // pass-start pair and lookups into info[k]; the walk takes each step's
  // from there, and lane k keeps step s0 + k's outputs and writes them
  // after. No store inside the walk, so its loads can go out early.
  auto run = [&](int s0, const L_t& L, float fd, unsigned fc) {
    const int s = s0 + lane, k = min(lane, K - 1);
    const int u = u_of(s), v = clampi(u, 0, sl.len - 1);
    const float lim = kAxis == 0 ? sl.lim : (float)(v - pr);
    const int Ll = lookup_index(lim, D);
    float d = fd, c;
    if (kRefresh) {
      d = refreshed(fd, __uint_as_float(fc), scale);
      c = L.at(k, lookup_index(fminf(d, lim), D));
    } else {
      c = Cost<T>::value(fc);
    }
    float before = __shfl_up_sync(kFull, d, 1);
    before = lane == 0 ? prev_d : before;
    const int ef = lookup_index(fminf(before, lim), D);
    int ef_before = __shfl_up_sync(kFull, ef, 1);
    ef_before = lane == 0 ? prev_ef : ef_before;
    prev_d = __shfl_sync(kFull, d, K - 1);
    prev_ef = __shfl_sync(kFull, ef, K - 1);
    const unsigned ok = u >= sl.lo && u < sl.hi && sl.lane_ok ? 1u << 30 : 0u;
    const Step<T> mine = Step<T>::make(ok | (unsigned)Ll << kField | (unsigned)ef, c, d,
                                       L.at(k, ef), L.at(k, min(ef_before, Ll)));
    __syncwarp();  // the previous batch has read info
    if (lane < K) info[lane] = mine;
    __syncwarp();

    // The third candidate of step i, line_i[min(H_{i-2}, Ll_i)], is looked up
    // at step i - 2, as soon as H_{i-2} is known: third holds step i's,
    // third_next step i + 1's.
    static_assert(K >= 2, "the lookups run two steps ahead");
    auto Ll_of = [&](int i) { return (int)(info[i].pk >> kField & kFieldMask); };
    float third = L.at(0, min(H2, Ll_of(0))), third_next = L.at(1, min(H1, Ll_of(1)));
    float od = 0.f, oc = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {  // the steps past n compute what nothing reads
      const Step<T> q = info[i];
      const int ef_i = q.pk & kFieldMask;
      const float cur_c = __uint_as_float(q.cost);
      const float cand_c = b1 ? (b2 ? third : q.A1()) : q.A0();
      const bool better = (q.pk >> 30) != 0 && cand_c < cur_c;
      const float lim_i = kAxis == 0 ? sl.lim : (float)(v_of(s0 + i) - pr);
      const int H = b1 ? H1 : ef_i;
      carry = better ? fminf(carry, lim_i) : __uint_as_float(q.disp);
      b2 = b1;
      b1 = better;
      H2 = H1;
      H1 = H;
      third = third_next;
      if (i + 2 < K) third_next = L.at(i + 2, min(H, Ll_of(i + 2)));
      const bool me = lane == i;
      od = me ? carry : od;
      oc = me ? (better ? cand_c : cur_c) : oc;
    }
    if (lane < K && s < n) {
      const int j = forward ? s : n - 1 - s;
      if (j >= sl.halo && j < sl.halo + sl.chunk) {
        const long long o = sl.out + (long long)u * sl.step;
        if (kMask) {
          const bool keep = oc < __fmul_rn(improve, L.at(lane, 0));
          const bool interior = v >= pr && v <= sl.len - pr - 1 && sl.lane_ok;
          disp_out[o] = keep && interior ? od : 0.f;
        } else {
          disp_out[o] = od;
          Cost<T>::store(cost_out + o, oc);
        }
      }
    }
  };

  // Two batches in flight: while the warp walks one, the next one loads.
  float fdA, fdB = 0.f;
  unsigned fcA, fcB = 0u;
  load(0, A, fdA, fcA);
  for (int s0 = 0; s0 < n; s0 += 2 * K) {
    if (s0 + K < n) load(s0 + K, B, fdB, fcB);
    A.ready(s0 + K < n);
    run(s0, A, fdA, fcA);
    if (s0 + K >= n) break;
    if (s0 + 2 * K < n) load(s0 + 2 * K, A, fdA, fcA);
    B.ready(s0 + 2 * K < n);
    run(s0 + K, B, fdB, fcB);
  }
}

// One pass of one block of a sharded frame (pm_pass): the block owns frame
// rows [a.row0, a.row0 + chunk) and is one y-strip of the frame. kAxis 1 is
// a row pass over the block's rows in a.chunks_x x-strips (kFold: the
// iteration's refresh, R+); kAxis 0 a column pass of the block's strip
// (kFold: the mask, the last C-). Its inputs and outputs are those of the
// pass in pm_match, the fronts moved by the offsets of Match. NW > 0: a warp
// walks a column, or a row of an x-strip, its lines NW * 128 bytes at most
// (walk); NW = 0: a thread a column, and a row pass a block of kLanes rows a
// strip (row_pass), as in pm_match.
template <typename T, int kAxis, bool kFold, int NW>
__global__ void __launch_bounds__(kThreads)
pm_pass_kernel(Hwd<T> rvol, HwdFrom<T> cvol, Match<T> a, const float* __restrict__ disp_in,
               const T* __restrict__ cost_in, float* __restrict__ disp_out,
               T* __restrict__ cost_out, float scale, bool forward, int strip) {
  if constexpr (NW > 0) {
    constexpr int K = kWalkWords / NW;
    const int wi = threadIdx.x / 32, warp = blockIdx.x * kWalkWarps + wi;
    ScanLine sl;
    sl.halo = a.halo;
    if constexpr (kAxis == 1) {  // a row of an x-strip; the block's rows from rvol.C on
      const int y = warp / a.chunks_x, c = warp % a.chunks_x;
      if (y >= a.H) return;
      sl.chunk = a.chunk_x;
      sl.len = a.W;
      sl.step = 1;
      sl.vol = sl.front = sl.out = (long long)y * a.W;
      sl.lane_ok = y + a.row0 >= a.pr && y + a.row0 <= a.rows - a.pr - 1;
      sl.start = c * sl.chunk - a.halo;
      sl.lim = 0.f;
    } else {  // column x of strip strip, positions in frame rows
      const int x = warp;
      if (x >= a.W) return;
      sl.chunk = a.chunk_y;
      sl.len = a.H;
      sl.step = a.W;
      sl.vol = x - (long long)cvol.y0 * a.W;
      sl.front = x - (long long)a.front_row0 * a.W;
      sl.out = x - (long long)a.out_row0 * a.W;
      sl.lane_ok = x >= a.pr && x <= a.W - a.pr - 1;
      sl.start = strip * sl.chunk - a.halo;
      sl.lim = (float)(x - a.pr);
    }
    sl.n = sl.chunk + 2 * a.halo;
    sl.lo = max(sl.start, a.pr);
    sl.hi = min(sl.start + sl.chunk + 2 * a.halo, sl.len - a.pr - 1);
    const T* C = kAxis == 1 ? rvol.C : cvol.C;
    __shared__ Step<T> info[kWalkWarps][K];
    __shared__ __align__(16) unsigned ring[kWalkWarps][2][Lines<T, K, NW>::kWords];
    Lines<T, K, NW> A{ring[wi][0]}, B{ring[wi][1]};
    walk<T, kAxis, kFold, NW>(C, disp_in, cost_in, a.noise, disp_out, cost_out, sl, A, B,
                              info[wi], a.D, a.pr, scale, a.improve, forward);
  } else if constexpr (kAxis == 1) {
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

// pm_pass_kernel for a pass and its line's words a lane (0: no walk).
template <typename T, int kAxis, bool kFold>
auto pass_kernel(int nw) {
  switch (nw) {
    case 1: return pm_pass_kernel<T, kAxis, kFold, 1>;
    case 2: return pm_pass_kernel<T, kAxis, kFold, 2>;
    case 4: return pm_pass_kernel<T, kAxis, kFold, 4>;
    default: return pm_pass_kernel<T, kAxis, kFold, 0>;
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
  // A walk copies its lines in 16-byte pieces, NW * 128 bytes at most.
  const int line = D * (int)sizeof(T);
  const int nw = line % 16 != 0 || (uintptr_t)C % 16 != 0 ? 0
                 : line <= 128 ? 1 : line <= 256 ? 2 : line <= 512 ? 4 : 0;
  const bool walks = nw > 0 && (axis == 0 || kWalkRows != 0);
  int blocks;
  if (axis == 1) {
    a.H = chunk;
    din += (long long)(row0 - front_row0) * W;
    cin += (long long)(row0 - front_row0) * W;
    blocks = walks ? (chunk * chunks_x + kWalkWarps - 1) / kWalkWarps
                   : (chunk + kLanes - 1) / kLanes * chunks_x;
  } else {
    blocks = walks ? (W + kWalkWarps - 1) / kWalkWarps : (W + kColumns - 1) / kColumns;
  }
  const int k = walks ? nw : 0;
  const auto kernel = axis == 1 ? (fold ? pass_kernel<T, 1, true>(k) : pass_kernel<T, 1, false>(k))
                                : (fold ? pass_kernel<T, 0, true>(k) : pass_kernel<T, 0, false>(k));
  kernel<<<blocks, walks ? 32 * kWalkWarps : kThreads, 0, s>>>(
      rvol, cvol, a, din, cin, (float*)disp_out, (T*)cost_out, scale, forward != 0, row0 / chunk);
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
