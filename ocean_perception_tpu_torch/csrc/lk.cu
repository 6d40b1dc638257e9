// Pyramidal Lucas-Kanade, every level of one tracking direction in one
// launch, for Hopper (sm_90a).
//
// lk_track replaces the TPU kernel pair run once per level:
// ocean_perception_tpu/ops/pallas/lk_prep.py::lk_prep_pallas (body
// _lk_prep_kernel) and ops/pallas/lk_iterate.py::lk_iterate_lane_major and
// ::lk_iterate_pallas (body _lk_iter_kernel), with the per-level update that
// tracking/lk.py ran between them. Its plain PyTorch twin is
// tracking/lk.py::lk_track_plain, made of lk_prep_plain and lk_walk_plain.
// Every sum runs in the twin's order and every rounding is pinned with an
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn) so that nvcc's
// contraction cannot change a bit: kernel and twin agree exactly.
//
// Coordinates are those of the level edge-padded by `pad`, as in the
// reference; the level itself is never padded, reads are clamped to it. A
// level may be a ring of R frames; each point reads frame src[k] in place.
//
// One block of 128 threads a point walks the levels coarse to fine. What
// bounds it is not bytes (two windows a level) nor operations but latency:
// chains of dependent operations and loads in a block of four warps, each
// level waiting on the one before (its slack window sits at the guess the
// coarser level left). The design:
// - Phase A, once: the template side of every level (it depends on the
//   point, not on the guess): every level's template rows loaded into
//   registers before any is stored, then recentring, gradients, window
//   sums, the 2x2 inverse and the gate. Rows go to warps and columns to
//   lanes, and a warp's rows run side by side: lanes past a row compute
//   its last entry and only the stores are conditional, since a branch
//   around each row would run them one after another.
// - Phase B, a level at a time: fetch the slack window; the (2, A, A)
//   surfaces, a thread an offset (a, b) with both gradients; the walk on one
//   thread from shared memory; the level update in registers. On the main
//   path (window 21, slack 4) the surfaces' window is a compile-time
//   constant: a row's slack values and gradients sit in registers, and the
//   next row's loads issue between the current row's operations. They are
//   bound by the latency of those shared loads (2 * 441 a thread), not by
//   their arithmetic.
// - The tents have at most two non-zero taps on each axis, so the
//   recentring and the walk's lookups add two products where the twin adds
//   a whole axis. Dropping products with weight 0 changes no value as long
//   as every term is finite, at most the sign of a zero, which no later
//   operation turns into a value. The kernel takes the two-tap form when
//   every value it would drop is at most kTwoTapMax in magnitude (so that no
//   partial sum can overflow either), else the twin's full sums.
//
// slack <= 0 selects the unbounded walk of the reference (its
// search_slack <= 0, which the JAX package runs in XLA: tracking/lk.py,
// _lk_level's else branch). Its twin's walk is
// tracking/lk.py::lk_walk_unbounded_plain. Phase A is the same; Phase B
// walks each level without surfaces: every step reads the (win+2)^2 window
// at the position into shared memory, resamples the win x win patch there
// (two taps an axis under the same guard, else the twin's full sums), forms
// diff*gx and diff*gy a thread an element, sums each row on a thread and
// the rows on thread 0, which takes the step and hands the position to the
// block. A step is a chain of a load, three barriers and two sums of win
// terms; the walk stops once the point has converged (a converged point
// never moves again, so this is the twin's fixed loop). Nothing leaves a
// window, so the level update has no hit flag.

#include <cuda_runtime.h>

constexpr int kLkMaxLevels = 8;

// The caller's arguments (mirrored by ops/cuda.py::_LKLevel and _LKTrack),
// outside the anonymous namespace so that opt_lk_track keeps external
// linkage.
struct LkLevel {
  const float* tmpl;  // (Rt, H, W)
  const float* srch;  // (Rs, H, W)
  int Rt, Rs, H, W;
  int win;            // odd; 0 = level skipped
};

struct LkTrack {
  LkLevel lv[kLkMaxLevels];
  const float* pts;   // (K, 2) [x, y] at level 0's scale
  const float* init;  // (K, 2) initial guess at level 0's scale
  const int* src_t;   // (K,) template frame of each point
  const int* src_s;   // (K,) search frame of each point
  float* out_pts;     // (K, 2)
  bool* status;       // (K,)
  int levels, K, slack, pad, max_iters;
  float min_eig, eps2;
};

namespace {

constexpr int kMaxLevels = kLkMaxLevels;
constexpr int kMaxA = 32;
constexpr int kThreads = 128;
constexpr float kTwoTapMax = 1e37f;
// Rows a warp works on side by side in the template stages.
constexpr int kRowsA = 8;
using Level = LkLevel;
using Track = LkTrack;

// Shared-memory offsets in floats, every array 16-byte aligned.
struct Layout {
  int twin[kMaxLevels], t1[kMaxLevels], t2[kMaxLevels], G[kMaxLevels], rows[kMaxLevels],
      scal[kMaxLevels];
  int swin, corr, total;
};

struct Dims {
  int win, r, ST, P, ws, A, SW, GS;
};

// Template window origin and the point's offset in it, at level l.
struct TmplPos {
  int t0y, t0x;
  float fy, fx;
};

// A level's arguments, shared-memory offsets and template position, which
// the kernel copies into shared memory once and reads from there.
struct LevelArgs {
  const float* tmpl;
  const float* srch;
  int Rt, Rs, H, W, win;
  int twin, t1, t2, G, rows, scal;
  TmplPos tp;
};

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline Dims dims(int win, int slack) {
  Dims d;
  d.win = win;
  d.r = win / 2;
  d.ST = win + 3;
  d.P = win + 2;
  d.ws = win + 2 * (slack + 1);
  d.A = d.ws - win + 1;
  // Slack-window row stride = A (mod 32): thread (a, b) = a*A + b of the
  // surfaces reads word a*SW + b + c, one bank a lane.
  d.SW = d.ws + (((d.A - d.ws) % 32) + 32) % 32;
  d.GS = up4(2 * win);  // a row of interleaved (gx, gy) pairs
  return d;
}

// The unbounded walk's scratch at window win (slack 0: ws = win + 2): the
// (2, win, win) products diff*gx and diff*gy, their (2, win) row sums, and
// the (win, ws) first contraction of the full sums.
__host__ __device__ inline int walk_prod(int win) { return up4(2 * win * win); }
__host__ __device__ inline int walk_rows(int win) { return up4(2 * win); }

int walk_floats(const Track& t) {
  int n = 0;
  for (int l = 0; l < t.levels; ++l) {
    const int win = t.lv[l].win;
    const int need = walk_prod(win) + walk_rows(win) + up4(win * (win + 2));
    if (win && need > n) n = need;
  }
  return n;
}

Layout layout(const Track& t) {
  Layout L = {};
  int o = 0, swin = 0;
  for (int l = 0; l < t.levels; ++l) {
    if (!t.lv[l].win) continue;
    const Dims d = dims(t.lv[l].win, t.slack);
    L.twin[l] = o; o += up4(d.ST * d.ST);
    L.t1[l] = o;   o += up4(d.P * d.ST);
    L.t2[l] = o;   o += up4(d.P * d.P);
    L.G[l] = o;    o += d.win * d.GS;
    L.rows[l] = o; o += up4(5 * d.win);
    L.scal[l] = o; o += 8;
    swin = d.ws * d.SW > swin ? d.ws * d.SW : swin;
  }
  const int A = 2 * t.slack + 3;
  L.swin = o; o += up4(swin);
  // The unbounded walk's scratch (walk_unbounded) takes the surfaces' place.
  L.corr = o; o += t.slack > 0 ? up4(2 * A * A) : walk_floats(t);
  L.total = o;
  return L;
}

__device__ __forceinline__ float clean(float v) { return isfinite(v) ? v : 0.f; }

// clip(floor(c) - back, 0, hi) as an int (back already holds -pad).
__device__ __forceinline__ int origin(float c, int back, int hi) {
  const float v = __fsub_rn(floorf(c), (float)back);
  return (int)fminf(fmaxf(v, 0.f), (float)hi);
}

__device__ __forceinline__ float tent(float pos, int a) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(pos, (float)a))));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ bool small(float v) { return fabsf(v) <= kTwoTapMax; }

__device__ __forceinline__ TmplPos tmpl_pos(const Track& t, const LevelArgs& lv, int l, int k) {
  const Dims d = dims(lv.win, t.slack);
  const float s = ldexpf(1.f, -l);  // exact: points / 2**l
  const float ptx = clean(__fmul_rn(t.pts[2 * k], s));
  const float pty = clean(__fmul_rn(t.pts[2 * k + 1], s));
  TmplPos p;
  p.t0y = origin(pty, d.r + 1 - t.pad, lv.H + 2 * t.pad - d.ST);
  p.t0x = origin(ptx, d.r + 1 - t.pad, lv.W + 2 * t.pad - d.ST);
  p.fy = __fsub_rn(__fadd_rn(pty, (float)t.pad), (float)p.t0y);
  p.fx = __fsub_rn(__fadd_rn(ptx, (float)t.pad), (float)p.t0x);
  return p;
}

// Tent centre of a resampled row (or column) p: clip((f + p) - half, 0, last).
__device__ __forceinline__ float centre(float f, int p, int half, int last) {
  return fminf(fmaxf(__fsub_rn(__fadd_rn(f, (float)p), (float)half), 0.f), (float)last);
}

// Tent centre of recentring row (or column) p: clip(f + p - P/2, 0, ST-1).
__device__ __forceinline__ float tent_centre(float f, int p, const Dims& d) {
  return centre(f, p, d.P / 2, d.ST - 1);
}

// An n x n window of img (H, W), its top-left at (y0, x0) - pad, clamped to
// the image, into dst with row stride `stride`. Rows go to warps, columns to
// lanes; a warp issues kRowsA rows' loads before it stores any, so their
// latencies overlap. Clears small_all if a value is too large for the
// two-tap sums.
__device__ __forceinline__ void fetch_window(const float* __restrict__ img, int H, int W, int y0,
                                             int x0, int n, int pad, float* __restrict__ dst,
                                             int stride, bool& small_all) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int j = lane; j - lane < n; j += 32) {
    const int x = clampi(x0 + min(j, n - 1) - pad, 0, W - 1);
    for (int i0 = warp; i0 < n; i0 += kRowsA * nw) {
      // Every lane loads (rows and columns past the window repeat its
      // last), so no load waits behind a branch; only the stores are
      // conditional.
      float v[kRowsA];
#pragma unroll
      for (int u = 0; u < kRowsA; ++u)
        v[u] = img[(size_t)clampi(y0 + min(i0 + u * nw, n - 1) - pad, 0, H - 1) * W + x];
#pragma unroll
      for (int u = 0; u < kRowsA; ++u) {
        const int i = i0 + u * nw;
        if (i < n && j < n) {
          dst[i * stride + j] = v[u];
          small_all = small_all && small(v[u]);
        }
      }
    }
  }
}

// One row of offset (a, b)'s sums, both gradients, from registers: the
// row's slack values sv[x] = swin[y+a][x+b] and its (gx, gy) pairs, two to
// a float4. The next row's loads into (sn, gn), from (srow, grow), are
// spread between the operations, so a warp never stalls on a block of
// loads.
template <int WIN>
__device__ __forceinline__ void surface_row(const float (&sv)[WIN], const float4 (&gv)[(WIN + 1) / 2],
                                            float& ax, float& ay, float (&sn)[WIN],
                                            float4 (&gn)[(WIN + 1) / 2], const float* srow,
                                            const float* grow, bool next) {
#pragma unroll
  for (int x = 0; x < WIN; ++x) {
    if (next) {
      sn[x] = srow[x];
      if (x % 2 == 0) gn[x / 2] = reinterpret_cast<const float4*>(grow)[x / 2];
    }
    const float4 g = gv[x / 2];
    ax = __fadd_rn(ax, __fmul_rn(x % 2 ? g.z : g.x, sv[x]));
    ay = __fadd_rn(ay, __fmul_rn(x % 2 ? g.w : g.y, sv[x]));
  }
}

// Correlation surfaces: thread (a, b) sums both gradients' products over
// (y, x) row-major, one accumulator each. WIN and A_ > 0 fix the window and
// the surface width at compile time: then a row's slack values and (gx, gy)
// pairs sit in registers, while the next row's are loaded into a second
// set (rows alternate between the two). 0 reads them from d.
template <int WIN, int A_>
__device__ __forceinline__ bool surfaces(const float* __restrict__ G,
                                         const float* __restrict__ swin,
                                         float* __restrict__ corr, const Dims& d) {
  const int A = A_ ? A_ : d.A, SW = d.SW, GS = d.GS;
  bool big = false;
  for (int i = threadIdx.x; i < A * A; i += blockDim.x) {
    const int a = i / A, b = i % A;
    const float* s = swin + a * SW + b;
    float ax = 0.f, ay = 0.f;
    if constexpr (WIN > 0) {
      float s0[WIN], s1[WIN];
      float4 g0[(WIN + 1) / 2], g1[(WIN + 1) / 2];
#pragma unroll
      for (int x = 0; x < WIN; ++x) s0[x] = s[x];
#pragma unroll
      for (int x = 0; x < (WIN + 1) / 2; ++x) g0[x] = reinterpret_cast<const float4*>(G)[x];
#pragma unroll 1
      for (int y = 0; y < WIN; y += 2) {
        surface_row<WIN>(s0, g0, ax, ay, s1, g1, s + (y + 1) * SW, G + (y + 1) * GS, y + 1 < WIN);
        if (y + 1 < WIN)
          surface_row<WIN>(s1, g1, ax, ay, s0, g0, s + (y + 2) * SW, G + (y + 2) * GS, y + 2 < WIN);
      }
    } else {
      for (int y = 0; y < d.win; ++y)
        for (int x = 0; x < d.win; ++x) {
          const float sv = s[y * SW + x];
          ax = __fadd_rn(ax, __fmul_rn(G[y * GS + 2 * x], sv));
          ay = __fadd_rn(ay, __fmul_rn(G[y * GS + 2 * x + 1], sv));
        }
    }
    corr[i] = ax;
    corr[A * A + i] = ay;
    big = big || !small(ax) || !small(ay);
  }
  return big;
}

// The walk of one point on its surfaces: max_iters masked Gauss-Newton
// steps from (px, py); a point that leaves the slack window is hit and
// stops, one whose step falls under eps stops.
__device__ void walk(const float* __restrict__ corr, const float* __restrict__ sc, const Dims& d,
                    float sy0, float sx0, int pad, int max_iters, float eps2, bool two_tap,
                    float& px, float& py, bool& hit) {
  const int A = d.A, r = d.r;
  const float* CX = corr;
  const float* CY = corr + A * A;
  const float tgx = sc[0], tgy = sc[1], i00 = sc[2], i01 = sc[3], i10 = sc[4], i11 = sc[5];
  const float lo = (float)(r + 1), hi = (float)(d.ws - r - 2);
  bool conv = false;
  hit = false;
  for (int it = 0; it < max_iters; ++it) {
    const float cy = __fsub_rn(__fadd_rn(py, (float)pad), sy0);
    const float cx = __fsub_rn(__fadd_rn(px, (float)pad), sx0);
    hit = hit || !(cy >= lo && cy <= hi && cx >= lo && cx <= hi);
    // A stopped point never moves again, so leaving here is exact.
    if (conv || hit) break;
    const float ry = __fsub_rn(cy, (float)r), rx = __fsub_rn(cx, (float)r);
    float bx, by;
    if (two_tap) {
      // cy, cx in [lo, hi] put ry, rx in [1, A-2]: both taps lie inside.
      const int a0 = (int)floorf(ry), b0 = (int)floorf(rx);
      const float wy0 = tent(ry, a0), wy1 = tent(ry, a0 + 1);
      const float wx0 = tent(rx, b0), wx1 = tent(rx, b0 + 1);
      const float* x0 = CX + a0 * A + b0;
      const float* y0 = CY + a0 * A + b0;
      const float tx0 = __fadd_rn(__fmul_rn(x0[0], wx0), __fmul_rn(x0[1], wx1));
      const float tx1 = __fadd_rn(__fmul_rn(x0[A], wx0), __fmul_rn(x0[A + 1], wx1));
      const float ty0 = __fadd_rn(__fmul_rn(y0[0], wx0), __fmul_rn(y0[1], wx1));
      const float ty1 = __fadd_rn(__fmul_rn(y0[A], wx0), __fmul_rn(y0[A + 1], wx1));
      bx = __fadd_rn(__fmul_rn(tx0, wy0), __fmul_rn(tx1, wy1));
      by = __fadd_rn(__fmul_rn(ty0, wy0), __fmul_rn(ty1, wy1));
    } else {
      float wy[kMaxA], wx[kMaxA];
      for (int a = 0; a < A; ++a) {
        wy[a] = tent(ry, a);
        wx[a] = tent(rx, a);
      }
      bx = 0.f;
      by = 0.f;
      for (int a = 0; a < A; ++a) {
        float tx = 0.f, ty = 0.f;
        for (int b = 0; b < A; ++b) {
          tx = __fadd_rn(tx, __fmul_rn(CX[a * A + b], wx[b]));
          ty = __fadd_rn(ty, __fmul_rn(CY[a * A + b], wx[b]));
        }
        bx = __fadd_rn(bx, __fmul_rn(tx, wy[a]));
        by = __fadd_rn(by, __fmul_rn(ty, wy[a]));
      }
    }
    bx = __fsub_rn(bx, tgx);
    by = __fsub_rn(by, tgy);
    const float dx = -__fadd_rn(__fmul_rn(i00, bx), __fmul_rn(i01, by));
    const float dy = -__fadd_rn(__fmul_rn(i10, bx), __fmul_rn(i11, by));
    px = __fadd_rn(px, dx);
    py = __fadd_rn(py, dy);
    conv = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < eps2;
  }
}

// Phase B of the unbounded walk, every level coarse to fine, from the guess
// in s_guess; leaves the point and its status in thread 0's gx, gy and ok.
__device__ void walk_unbounded(const Track& t, const Layout& L, const LevelArgs* lp, float* sm,
                               float* s_guess, int k, float& gx, float& gy, bool& ok) {
  __shared__ int s_conv;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* swin = sm + L.swin;
  __syncthreads();  // Phase A's inverses and gates (A6), even where no step runs
  for (int l = t.levels - 1; l >= 0; --l) {
    const LevelArgs& lv = lp[l];
    if (lv.win) {
      const Dims d = dims(lv.win, 0);  // ws = win + 2
      const int win = d.win, r = d.r, ws = d.ws;
      const int Hp = lv.H + 2 * t.pad, Wp = lv.W + 2 * t.pad;
      const float* S = lv.srch + (size_t)clampi(t.src_s[k], 0, lv.Rs - 1) * lv.H * lv.W;
      const float* t2 = sm + lv.t2;
      const float* G = sm + lv.G;
      const float* sc = sm + lv.scal;
      float* prod = sm + L.corr;
      float* rsum = prod + walk_prod(win);
      float* t1 = rsum + walk_rows(win);
      float px = s_guess[0], py = s_guess[1];
      bool conv = false;
      for (int it = 0; it < t.max_iters && !conv; ++it) {
        // A non-finite position reads the window at 0 (and stays non-finite).
        const float cpx = clean(px), cpy = clean(py);
        const int y0 = origin(cpy, r + 1 - t.pad, Hp - ws);
        const int x0 = origin(cpx, r + 1 - t.pad, Wp - ws);
        bool small_all = true;
        fetch_window(S, lv.H, lv.W, y0, x0, ws, t.pad, swin, d.SW, small_all);
        const bool two_tap = __syncthreads_and(small_all);
        const float cy = __fsub_rn(__fadd_rn(cpy, (float)t.pad), (float)y0);
        const float cx = __fsub_rn(__fadd_rn(cpx, (float)t.pad), (float)x0);
        if (two_tap) {
          for (int e = tid; e < win * win; e += nt) {
            const int i = e / win, j = e % win;
            const float ci = centre(cy, i, r, ws - 1), cj = centre(cx, j, r, ws - 1);
            const int a0 = (int)ci, b0 = (int)cj;
            // The second tap's row (column), or the first's where the window
            // ends (its weight is then 0, and the value it multiplies finite).
            const int da = a0 + 1 < ws ? d.SW : 0, db = b0 + 1 < ws ? 1 : 0;
            const float wy0 = tent(ci, a0), wy1 = tent(ci, a0 + 1);
            const float wx0 = tent(cj, b0), wx1 = tent(cj, b0 + 1);
            const float* r0 = swin + a0 * d.SW + b0;
            const float u0 = __fadd_rn(__fmul_rn(wy0, r0[0]), __fmul_rn(wy1, r0[da]));
            const float u1 = __fadd_rn(__fmul_rn(wy0, r0[db]), __fmul_rn(wy1, r0[da + db]));
            const float v = __fadd_rn(__fmul_rn(u0, wx0), __fmul_rn(u1, wx1));
            const float diff = __fsub_rn(v, t2[(i + 1) * d.P + j + 1]);
            const float2 g = reinterpret_cast<const float2*>(G + i * d.GS)[j];
            prod[e] = __fmul_rn(diff, g.x);
            prod[win * win + e] = __fmul_rn(diff, g.y);
          }
        } else {
          // The twin's full sums: over the rows, then over the columns.
          for (int e = tid; e < win * ws; e += nt) {
            const int i = e / ws, b = e % ws;
            const float ci = centre(cy, i, r, ws - 1);
            float acc = 0.f;
            for (int a = 0; a < ws; ++a)
              acc = __fadd_rn(acc, __fmul_rn(tent(ci, a), swin[a * d.SW + b]));
            t1[e] = acc;
          }
          __syncthreads();
          for (int e = tid; e < win * win; e += nt) {
            const int i = e / win, j = e % win;
            const float cj = centre(cx, j, r, ws - 1);
            float acc = 0.f;
            for (int b = 0; b < ws; ++b)
              acc = __fadd_rn(acc, __fmul_rn(t1[i * ws + b], tent(cj, b)));
            const float diff = __fsub_rn(acc, t2[(i + 1) * d.P + j + 1]);
            const float2 g = reinterpret_cast<const float2*>(G + i * d.GS)[j];
            prod[e] = __fmul_rn(diff, g.x);
            prod[win * win + e] = __fmul_rn(diff, g.y);
          }
        }
        __syncthreads();
        // Each row of diff*gx (rows 0..win-1) and diff*gy, left to right.
        for (int y = tid; y < 2 * win; y += nt) {
          const float* row = prod + y * win;
          float acc = 0.f;
          for (int x = 0; x < win; ++x) acc = __fadd_rn(acc, row[x]);
          rsum[y] = acc;
        }
        __syncthreads();
        if (tid == 0) {
          float bx = 0.f, by = 0.f;
          for (int y = 0; y < win; ++y) {
            bx = __fadd_rn(bx, rsum[y]);
            by = __fadd_rn(by, rsum[win + y]);
          }
          const float dx = -__fadd_rn(__fmul_rn(sc[2], bx), __fmul_rn(sc[3], by));
          const float dy = -__fadd_rn(__fmul_rn(sc[4], bx), __fmul_rn(sc[5], by));
          s_guess[0] = __fadd_rn(px, dx);
          s_guess[1] = __fadd_rn(py, dy);
          s_conv = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < t.eps2;
        }
        __syncthreads();
        px = s_guess[0];
        py = s_guess[1];
        conv = s_conv;
      }
      if (tid == 0) {
        const bool in_img = px >= 0.f && px <= (float)(lv.W - 1) && py >= 0.f &&
                            py <= (float)(lv.H - 1);
        const bool ok_l = sc[6] != 0.f && in_img && isfinite(px) && isfinite(py);
        if (ok_l) {
          gx = px;
          gy = py;
        }
        // OpenCV semantics: the status comes from the finest level.
        if (l == 0) ok = ok_l;
      }
    }
    if (tid == 0) {
      if (l > 0) {
        gx = __fmul_rn(gx, 2.f);
        gy = __fmul_rn(gy, 2.f);
      }
      s_guess[0] = gx;
      s_guess[1] = gy;
    }
    __syncthreads();
  }
}

template <bool kUnbounded>
__global__ void __launch_bounds__(kThreads, 2) lk_track_kernel(const Track t, const Layout L) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  __shared__ float s_guess[2];
  __shared__ LevelArgs lp[kMaxLevels];
  const int k = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;

  // Stages below give rows to warps and columns to lanes.
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;

  if (tid < t.levels) {
    const Level& lv = t.lv[tid];
    LevelArgs a = {lv.tmpl, lv.srch, lv.Rt, lv.Rs, lv.H, lv.W, lv.win, L.twin[tid], L.t1[tid],
                   L.t2[tid], L.G[tid], L.rows[tid], L.scal[tid], {}};
    if (a.win) a.tp = tmpl_pos(t, a, tid, k);
    lp[tid] = a;
  }
  __syncthreads();

  // --- Phase A: the template side of every level. ---------------------------
  // A1: every level's template window, and whether its values allow the
  // two-tap recentring. Where every window fits a warp's lanes and kRowsA
  // rows a warp, all levels' loads are issued before any is stored, so
  // their latencies overlap; else a level at a time.
  bool small_all = true;
  bool fits = true;
  for (int l = 0; l < t.levels; ++l)
    fits = fits && (!lp[l].win || (lp[l].win + 3 <= 32 && lp[l].win + 3 <= kRowsA * nw));
  if (fits) {
    float v[kMaxLevels][kRowsA];
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l >= t.levels || !lp[l].win) continue;
      const LevelArgs& lv = lp[l];
      const int n = lv.win + 3;
      const float* T = lv.tmpl + (size_t)clampi(t.src_t[k], 0, lv.Rt - 1) * lv.H * lv.W;
      const int x = clampi(lv.tp.t0x + min(lane, n - 1) - t.pad, 0, lv.W - 1);
#pragma unroll
      for (int u = 0; u < kRowsA; ++u)
        v[l][u] = T[(size_t)clampi(lv.tp.t0y + min(warp + u * nw, n - 1) - t.pad, 0, lv.H - 1) *
                        lv.W + x];
    }
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l >= t.levels || !lp[l].win) continue;
      const int n = lp[l].win + 3;
#pragma unroll
      for (int u = 0; u < kRowsA; ++u) {
        const int i = warp + u * nw;
        if (i < n && lane < n) {
          sm[lp[l].twin + i * n + lane] = v[l][u];
          small_all = small_all && small(v[l][u]);
        }
      }
    }
  } else {
#pragma unroll 1
    for (int l = 0; l < t.levels; ++l) {
      const LevelArgs& lv = lp[l];
      if (!lv.win) continue;
      const float* T = lv.tmpl + (size_t)clampi(t.src_t[k], 0, lv.Rt - 1) * lv.H * lv.W;
      fetch_window(T, lv.H, lv.W, lv.tp.t0y, lv.tp.t0x, lv.win + 3, t.pad, sm + lv.twin,
                      lv.win + 3, small_all);
    }
  }
  if (tid == 0) {
    const float s = ldexpf(1.f, 1 - t.levels);  // exact: init / 2**(levels-1)
    s_guess[0] = __fmul_rn(t.init[2 * k], s);
    s_guess[1] = __fmul_rn(t.init[2 * k + 1], s);
  }
  const bool two_tap_t = __syncthreads_and(small_all);

  // A2-A3: the recentred template t2[p][j] = sum_b t1[p][b] * wx[j][b], with
  // t1[p][b] = sum_a wy[p][a] * twin[a][b]. Two taps: each t2 entry from the
  // two t1 entries it needs, each from two twin values, in one stage.
  if (two_tap_t) {
#pragma unroll 1
    for (int l = 0; l < t.levels; ++l) {
      if (!lp[l].win) continue;
      const Dims d = dims(lp[l].win, t.slack);
      const TmplPos tp = lp[l].tp;
      const float* twin = sm + lp[l].twin;
      float* t2 = sm + lp[l].t2;
      for (int j0 = lane; j0 - lane < d.P; j0 += 32) {
        // Lanes past the row compute its last entry and store nothing: no
        // lane branches, so a warp's rows run side by side.
        const int j = min(j0, d.P - 1);
        const float cx = tent_centre(tp.fx, j, d);
        const int b0 = (int)cx;
        // The second tap's column, or the first's where the window ends
        // (its weight is then 0, and the value it multiplies finite).
        const int db = b0 + 1 < d.ST ? 1 : 0;
        const float wx0 = tent(cx, b0), wx1 = tent(cx, b0 + 1);
        for (int p0 = warp; p0 < d.P; p0 += kRowsA * nw) {
          float out[kRowsA];
#pragma unroll
          for (int u = 0; u < kRowsA; ++u) {
            const int p = min(p0 + u * nw, d.P - 1);
            const float cy = tent_centre(tp.fy, p, d);
            const int a0 = (int)cy;
            const int da = a0 + 1 < d.ST ? d.ST : 0;  // as db, for the rows
            const float wy0 = tent(cy, a0), wy1 = tent(cy, a0 + 1);
            // A tap of weight 0 adds a zero: the value is the twin's.
            const float* r0 = twin + a0 * d.ST + b0;
            const float u0 = __fadd_rn(__fmul_rn(wy0, r0[0]), __fmul_rn(wy1, r0[da]));
            const float u1 = __fadd_rn(__fmul_rn(wy0, r0[db]), __fmul_rn(wy1, r0[da + db]));
            out[u] = __fadd_rn(__fmul_rn(u0, wx0), __fmul_rn(u1, wx1));
          }
#pragma unroll
          for (int u = 0; u < kRowsA; ++u) {
            const int p = p0 + u * nw;
            if (j0 < d.P && p < d.P) t2[p * d.P + j0] = out[u];
          }
        }
      }
    }
  } else {
    // The twin's full sums, t1 then t2.
    for (int l = 0; l < t.levels; ++l) {
      if (!lp[l].win) continue;
      const Dims d = dims(lp[l].win, t.slack);
      const float fy = lp[l].tp.fy;
      const float* twin = sm + lp[l].twin;
      float* t1 = sm + lp[l].t1;
      for (int p = warp; p < d.P; p += nw) {
        const float c = tent_centre(fy, p, d);
        for (int b = lane; b < d.ST; b += 32) {
          float acc = 0.f;
          for (int a = 0; a < d.ST; ++a) acc = __fadd_rn(acc, __fmul_rn(tent(c, a), twin[a * d.ST + b]));
          t1[p * d.ST + b] = acc;
        }
      }
    }
    __syncthreads();
    for (int l = 0; l < t.levels; ++l) {
      if (!lp[l].win) continue;
      const Dims d = dims(lp[l].win, t.slack);
      const float fx = lp[l].tp.fx;
      float* t2 = sm + lp[l].t2;
      for (int p = warp; p < d.P; p += nw) {
        const float* row = sm + lp[l].t1 + p * d.ST;
        for (int j = lane; j < d.P; j += 32) {
          const float c = tent_centre(fx, j, d);
          float acc = 0.f;
          for (int b = 0; b < d.ST; ++b) acc = __fadd_rn(acc, __fmul_rn(row[b], tent(c, b)));
          t2[p * d.P + j] = acc;
        }
      }
    }
  }
  __syncthreads();

  // A4: central differences into interleaved (gx, gy) rows; the template
  // patch is t2's interior.
#pragma unroll 1
  for (int l = 0; l < t.levels; ++l) {
    if (!lp[l].win) continue;
    const Dims d = dims(lp[l].win, t.slack);
    const float* t2 = sm + lp[l].t2;
    float* G = sm + lp[l].G;
    const int P = d.P;
    for (int x0 = lane; x0 - lane < d.win; x0 += 32)
      for (int y0 = warp; y0 < d.win; y0 += kRowsA * nw) {
        const int x = min(x0, d.win - 1);
        float2 out[kRowsA];
#pragma unroll
        for (int u = 0; u < kRowsA; ++u) {
          const int y = min(y0 + u * nw, d.win - 1);
          out[u] = make_float2(
              __fmul_rn(0.5f, __fsub_rn(t2[(y + 1) * P + x + 2], t2[(y + 1) * P + x])),
              __fmul_rn(0.5f, __fsub_rn(t2[(y + 2) * P + x + 1], t2[y * P + x + 1])));
        }
#pragma unroll
        for (int u = 0; u < kRowsA; ++u) {
          const int y = y0 + u * nw;
          if (x0 < d.win && y < d.win) reinterpret_cast<float2*>(G + y * d.GS)[x0] = out[u];
        }
      }
  }
  __syncthreads();

  // A5: gxx, gxy, gyy, tgx, tgy row sums, each row left to right: a thread
  // a (level, row), the five sums side by side.
  for (int i = tid;; i += nt) {
    int l = 0, y = i;
    for (; l < t.levels; ++l) {
      if (y < lp[l].win) break;
      y -= lp[l].win;
    }
    if (l == t.levels) break;
    const Dims d = dims(lp[l].win, t.slack);
    const float* g = sm + lp[l].G + y * d.GS;
    const float* tp = sm + lp[l].t2 + (y + 1) * d.P + 1;
    float r[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 7
    for (int x = 0; x < d.win; ++x) {
      const float2 ab = reinterpret_cast<const float2*>(g)[x];
      const float tv = tp[x];
      r[0] = __fadd_rn(r[0], __fmul_rn(ab.x, ab.x));
      r[1] = __fadd_rn(r[1], __fmul_rn(ab.x, ab.y));
      r[2] = __fadd_rn(r[2], __fmul_rn(ab.y, ab.y));
      r[3] = __fadd_rn(r[3], __fmul_rn(tv, ab.x));
      r[4] = __fadd_rn(r[4], __fmul_rn(tv, ab.y));
    }
    float* rows = sm + lp[l].rows;
#pragma unroll
    for (int q = 0; q < 5; ++q) rows[q * d.win + y] = r[q];
  }
  __syncthreads();

  // A6: the rows top to bottom, the 2x2 inverse and the gate: one thread a
  // level, in the last warp, while the others fetch the first slack window.
  {
    const int l = tid - (nt - 32);
    if (l >= 0 && l < t.levels && lp[l].win) {
      const int win = lp[l].win;
      const float* rows = sm + lp[l].rows;
      float tot[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 7
      for (int y = 0; y < win; ++y)
#pragma unroll
        for (int q = 0; q < 5; ++q) tot[q] = __fadd_rn(tot[q], rows[q * win + y]);
      const float gxx = tot[0], gxy = tot[1], gyy = tot[2];
      const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
      const float dd = __fsub_rn(gxx, gyy);
      const float root = __fsqrt_rn(__fadd_rn(__fmul_rn(dd, dd), __fmul_rn(__fmul_rn(4.f, gxy), gxy)));
      const float half = __fmul_rn(0.5f, __fsub_rn(__fadd_rn(gxx, gyy), root));
      const float me = __fdiv_rn(half, (float)(win * win));
      const float dsafe = det > 1e-12f ? det : 1.f;
      const float inv01 = __fdiv_rn(-gxy, dsafe);
      float* sc = sm + lp[l].scal;
      sc[0] = tot[3];
      sc[1] = tot[4];
      sc[2] = __fdiv_rn(gyy, dsafe);
      sc[3] = inv01;
      sc[4] = inv01;
      sc[5] = __fdiv_rn(gxx, dsafe);
      sc[6] = (det > 1e-12f && me > t.min_eig) ? 1.f : 0.f;
    }
  }

  // --- Phase B: coarse to fine. --------------------------------------------
  float gx = 0.f, gy = 0.f;  // the guess, in thread 0
  bool ok = false;
  if (tid == 0) {
    gx = s_guess[0];
    gy = s_guess[1];
  }
  if constexpr (kUnbounded) {
    walk_unbounded(t, L, lp, sm, s_guess, k, gx, gy, ok);
    if (tid == 0) {
      t.out_pts[2 * k] = gx;
      t.out_pts[2 * k + 1] = gy;
      t.status[k] = ok;
    }
    return;
  }
  float* swin = sm + L.swin;
  float* corr = sm + L.corr;
  for (int l = t.levels - 1; l >= 0; --l) {
    const LevelArgs& lv = lp[l];
    if (lv.win) {
      const Dims d = dims(lv.win, t.slack);
      // B1: the slack window at the guess.
      const int Hp = lv.H + 2 * t.pad, Wp = lv.W + 2 * t.pad;
      const int back = d.r + t.slack + 1 - t.pad;
      const int sy0 = origin(clean(s_guess[1]), back, Hp - d.ws);
      const int sx0 = origin(clean(s_guess[0]), back, Wp - d.ws);
      const float* S = lv.srch + (size_t)clampi(t.src_s[k], 0, lv.Rs - 1) * lv.H * lv.W;
      bool unused = true;
      fetch_window(S, lv.H, lv.W, sy0, sx0, d.ws, t.pad, swin, d.SW, unused);
      __syncthreads();

      // B2: the surfaces, and whether the walk may take two taps.
      const float* G = sm + lp[l].G;
      const bool big = (d.win == 21 && d.A == 11) ? surfaces<21, 11>(G, swin, corr, d)
                                                  : surfaces<0, 0>(G, swin, corr, d);
      const bool two_tap_w = !__syncthreads_or(big);

      // B3: the walk and the level update.
      if (tid == 0) {
        const float* sc = sm + lp[l].scal;
        float px = gx, py = gy;
        bool hit;
        walk(corr, sc, d, (float)sy0, (float)sx0, t.pad, t.max_iters, t.eps2, two_tap_w, px,
             py, hit);
        const bool in_img = px >= 0.f && px <= (float)(lv.W - 1) && py >= 0.f &&
                            py <= (float)(lv.H - 1);
        const bool ok_l = sc[6] != 0.f && in_img && isfinite(px) && isfinite(py) && !hit;
        if (ok_l) {
          gx = px;
          gy = py;
        }
        // OpenCV semantics: the status comes from the finest level.
        if (l == 0) ok = ok_l;
      }
    }
    if (tid == 0) {
      if (l > 0) {
        gx = __fmul_rn(gx, 2.f);
        gy = __fmul_rn(gy, 2.f);
      }
      s_guess[0] = gx;
      s_guess[1] = gy;
    }
    __syncthreads();
  }
  if (tid == 0) {
    t.out_pts[2 * k] = gx;
    t.out_pts[2 * k + 1] = gy;
    t.status[k] = ok;
  }
}

}  // namespace

// One direction of pyramidal LK for t->K points, every level in one launch
// on `stream`. Returns a cudaError_t (0 on success).
// slack <= 0 runs the unbounded walk.
extern "C" int opt_lk_track(const LkTrack* in, void* stream) {
  LkTrack t = *in;
  if (t.K == 0) return 0;
  const bool unbounded = t.slack <= 0;
  if (unbounded) t.slack = 0;
  if (t.levels < 1 || t.levels > kMaxLevels || 2 * t.slack + 3 > kMaxA)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < t.levels; ++l)
    if (t.lv[l].win && (t.lv[l].win < 3 || t.lv[l].win % 2 == 0)) return (int)cudaErrorInvalidValue;
  const Layout L = layout(t);
  const size_t smem = sizeof(float) * L.total;
  const auto kernel = unbounded ? lk_track_kernel<true> : lk_track_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<t.K, kThreads, smem, (cudaStream_t)stream>>>(t, L);
  return (int)cudaGetLastError();
}
