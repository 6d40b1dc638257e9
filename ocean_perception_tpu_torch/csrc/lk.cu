// Pyramidal Lucas-Kanade, one level and direction, for Hopper (sm_90a).
//
// lk_prep replaces ocean_perception_tpu/ops/pallas/lk_prep.py::lk_prep_pallas
// (body _lk_prep_kernel); lk_walk replaces
// ocean_perception_tpu/ops/pallas/lk_iterate.py::lk_iterate_lane_major and
// ::lk_iterate_pallas (body _lk_iter_kernel). The plain PyTorch twins are
// tracking/lk.py::lk_prep_plain and ::lk_walk_plain; every sum below runs in
// the twin's order and every rounding is pinned with an intrinsic
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn) so that nvcc's contraction
// cannot change a bit: kernel and twin agree exactly.
//
// Coordinates are those of the level edge-padded by `pad`, as in the
// reference; the level itself is never padded, reads are clamped to it. A
// level may be a ring of R frames; each point reads frame src[k] in place.
//
// lk_prep: one block per point. Bound by the per-point arithmetic on shared
// memory (the surfaces are 2*A*A dot products of win*win terms: 2*121*441
// multiply-adds at win=21, A=11), not by the bytes it reads (two windows,
// 24^2 + 31^2 floats). Design: both windows and every intermediate live in
// shared memory (about 19 KB at win=21), each output element is one
// thread's sequential sum, and the point-major outputs need no relayout.
//
// lk_walk: one thread per point, which leaves its loop once it stops; the
// 2*A*A surface values it reads each step stay in L1. Bound by the
// sequential dependency of the steps, not by memory.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxA = 32;

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

__global__ void lk_prep_kernel(const float* __restrict__ tmpl, const float* __restrict__ srch,
                               const float* __restrict__ pts, const float* __restrict__ guess,
                               const int* __restrict__ src_t, const int* __restrict__ src_s,
                               float* __restrict__ corr, float* __restrict__ scal,
                               bool* __restrict__ okg, int Rt, int Rs, int H, int W, int win,
                               int slack, int pad, float min_eig) {
  extern __shared__ float sm[];
  __shared__ float tot[5];
  const int k = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int r = win / 2, ST = win + 3, ws = win + 2 * (slack + 1), A = ws - win + 1;
  const int P = win + 2, Hp = H + 2 * pad, Wp = W + 2 * pad;
  float* twin = sm;                // ST*ST template window
  float* swin = twin + ST * ST;    // ws*ws slack window
  float* wy = swin + ws * ws;      // P*ST recentring tents, rows
  float* wx = wy + P * ST;         // P*ST recentring tents, columns
  float* t1 = wx + P * ST;         // P*ST after the y contraction
  float* t2 = t1 + P * ST;         // P*P recentred (win+2)^2 template
  float* gx = t2 + P * P;          // win*win
  float* gy = gx + win * win;      // win*win
  float* rows = gy + win * win;    // 5*win row sums

  // Window origins; every thread computes the same values.
  const float ptx = clean(pts[2 * k]), pty = clean(pts[2 * k + 1]);
  const float gsx = clean(guess[2 * k]), gsy = clean(guess[2 * k + 1]);
  const int t0y = origin(pty, r + 1 - pad, Hp - ST), t0x = origin(ptx, r + 1 - pad, Wp - ST);
  const int sy0 = origin(gsy, r + slack + 1 - pad, Hp - ws);
  const int sx0 = origin(gsx, r + slack + 1 - pad, Wp - ws);
  const float fy = __fsub_rn(__fadd_rn(pty, (float)pad), (float)t0y);
  const float fx = __fsub_rn(__fadd_rn(ptx, (float)pad), (float)t0x);
  const float* T = tmpl + (size_t)clampi(src_t[k], 0, Rt - 1) * H * W;
  const float* S = srch + (size_t)clampi(src_s[k], 0, Rs - 1) * H * W;

  for (int i = tid; i < ST * ST; i += nt) {
    const int y = clampi(t0y + i / ST - pad, 0, H - 1), x = clampi(t0x + i % ST - pad, 0, W - 1);
    twin[i] = T[(size_t)y * W + x];
  }
  for (int i = tid; i < ws * ws; i += nt) {
    const int y = clampi(sy0 + i / ws - pad, 0, H - 1), x = clampi(sx0 + i % ws - pad, 0, W - 1);
    swin[i] = S[(size_t)y * W + x];
  }
  for (int i = tid; i < P * ST; i += nt) {
    const int p = i / ST, a = i % ST;
    const float py = fminf(fmaxf(__fsub_rn(__fadd_rn(fy, (float)p), (float)(P / 2)), 0.f), (float)(ST - 1));
    const float px = fminf(fmaxf(__fsub_rn(__fadd_rn(fx, (float)p), (float)(P / 2)), 0.f), (float)(ST - 1));
    wy[i] = tent(py, a);
    wx[i] = tent(px, a);
  }
  __syncthreads();

  // Recentring: t1 = Wy @ twin (over rows a), t2 = t1 @ Wx^T (over columns b).
  for (int i = tid; i < P * ST; i += nt) {
    const int p = i / ST, b = i % ST;
    float acc = 0.f;
    for (int a = 0; a < ST; ++a) acc = __fadd_rn(acc, __fmul_rn(wy[p * ST + a], twin[a * ST + b]));
    t1[i] = acc;
  }
  __syncthreads();
  for (int i = tid; i < P * P; i += nt) {
    const int p = i / P, j = i % P;
    float acc = 0.f;
    for (int b = 0; b < ST; ++b) acc = __fadd_rn(acc, __fmul_rn(t1[p * ST + b], wx[j * ST + b]));
    t2[i] = acc;
  }
  __syncthreads();

  // Central differences; the template patch is t2's interior.
  for (int i = tid; i < win * win; i += nt) {
    const int y = i / win, x = i % win;
    gx[i] = __fmul_rn(0.5f, __fsub_rn(t2[(y + 1) * P + x + 2], t2[(y + 1) * P + x]));
    gy[i] = __fmul_rn(0.5f, __fsub_rn(t2[(y + 2) * P + x + 1], t2[y * P + x + 1]));
  }
  __syncthreads();

  // gxx, gxy, gyy, tgx, tgy: each row left to right, then rows top to bottom.
  for (int i = tid; i < 5 * win; i += nt) {
    const int q = i / win, y = i % win;
    float acc = 0.f;
    for (int x = 0; x < win; ++x) {
      const float a = gx[y * win + x], b = gy[y * win + x], t = t2[(y + 1) * P + x + 1];
      const float v = q == 0 ? __fmul_rn(a, a) : q == 1 ? __fmul_rn(a, b) : q == 2 ? __fmul_rn(b, b)
                    : q == 3 ? __fmul_rn(t, a) : __fmul_rn(t, b);
      acc = __fadd_rn(acc, v);
    }
    rows[i] = acc;
  }
  __syncthreads();
  if (tid < 5) {
    float acc = 0.f;
    for (int y = 0; y < win; ++y) acc = __fadd_rn(acc, rows[tid * win + y]);
    tot[tid] = acc;
  }

  // Correlation surfaces: one accumulator per (g, a, b) over (y, x) row-major.
  float* out = corr + (size_t)k * 2 * A * A;
  for (int i = tid; i < 2 * A * A; i += nt) {
    const float* G = i < A * A ? gx : gy;
    const int a = (i / A) % A, b = i % A;
    float acc = 0.f;
    for (int y = 0; y < win; ++y)
      for (int x = 0; x < win; ++x)
        acc = __fadd_rn(acc, __fmul_rn(G[y * win + x], swin[(y + a) * ws + x + b]));
    out[i] = acc;
  }
  __syncthreads();

  if (tid == 0) {
    const float gxx = tot[0], gxy = tot[1], gyy = tot[2];
    const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
    const float d = __fsub_rn(gxx, gyy);
    const float root = __fsqrt_rn(__fadd_rn(__fmul_rn(d, d), __fmul_rn(__fmul_rn(4.f, gxy), gxy)));
    const float half = __fmul_rn(0.5f, __fsub_rn(__fadd_rn(gxx, gyy), root));
    const float me = __fdiv_rn(half, (float)(win * win));
    const float dsafe = det > 1e-12f ? det : 1.f;
    const float inv01 = __fdiv_rn(-gxy, dsafe);
    float* sc = scal + (size_t)k * 8;
    sc[0] = tot[3];
    sc[1] = tot[4];
    sc[2] = __fdiv_rn(gyy, dsafe);
    sc[3] = inv01;
    sc[4] = inv01;
    sc[5] = __fdiv_rn(gxx, dsafe);
    sc[6] = (float)sy0;
    sc[7] = (float)sx0;
    okg[k] = det > 1e-12f && me > min_eig;
  }
}

__global__ void lk_walk_kernel(const float* __restrict__ corr, const float* __restrict__ scal,
                               const float* __restrict__ pos0, float* __restrict__ pos,
                               bool* __restrict__ hit_out, int K, int A, int r, int ws, int pad,
                               int max_iters, float eps2) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const float* CX = corr + (size_t)k * 2 * A * A;
  const float* CY = CX + A * A;
  const float* sc = scal + (size_t)k * 8;
  const float tgx = sc[0], tgy = sc[1], i00 = sc[2], i01 = sc[3], i10 = sc[4], i11 = sc[5];
  const float sy0 = sc[6], sx0 = sc[7];
  const float lo = (float)(r + 1), hi = (float)(ws - r - 2);
  float px = pos0[2 * k], py = pos0[2 * k + 1];
  bool conv = false, hit = false;
  float wy[kMaxA], wx[kMaxA];
  for (int it = 0; it < max_iters; ++it) {
    const float cy = __fsub_rn(__fadd_rn(py, (float)pad), sy0);
    const float cx = __fsub_rn(__fadd_rn(px, (float)pad), sx0);
    hit = hit || !(cy >= lo && cy <= hi && cx >= lo && cx <= hi);
    // A stopped point never moves again, so leaving here is exact.
    if (conv || hit) break;
    const float ry = __fsub_rn(cy, (float)r), rx = __fsub_rn(cx, (float)r);
    for (int a = 0; a < A; ++a) {
      wy[a] = tent(ry, a);
      wx[a] = tent(rx, a);
    }
    float bx = 0.f, by = 0.f;
    for (int a = 0; a < A; ++a) {
      float tx = 0.f, ty = 0.f;
      for (int b = 0; b < A; ++b) {
        tx = __fadd_rn(tx, __fmul_rn(CX[a * A + b], wx[b]));
        ty = __fadd_rn(ty, __fmul_rn(CY[a * A + b], wx[b]));
      }
      bx = __fadd_rn(bx, __fmul_rn(tx, wy[a]));
      by = __fadd_rn(by, __fmul_rn(ty, wy[a]));
    }
    bx = __fsub_rn(bx, tgx);
    by = __fsub_rn(by, tgy);
    const float dx = -__fadd_rn(__fmul_rn(i00, bx), __fmul_rn(i01, by));
    const float dy = -__fadd_rn(__fmul_rn(i10, bx), __fmul_rn(i11, by));
    px = __fadd_rn(px, dx);
    py = __fadd_rn(py, dy);
    conv = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < eps2;
  }
  pos[2 * k] = px;
  pos[2 * k + 1] = py;
  hit_out[k] = hit;
}

}  // namespace

extern "C" int opt_lk_prep(const void* tmpl, const void* srch, const void* pts, const void* guess,
                           const void* src_t, const void* src_s, void* corr, void* scal,
                           void* okg, int Rt, int Rs, int H, int W, int K, int win, int slack,
                           int pad, float min_eig, void* stream) {
  if (K == 0) return 0;
  const int ST = win + 3, ws = win + 2 * (slack + 1), P = win + 2;
  const size_t smem =
      sizeof(float) * (ST * ST + ws * ws + 3 * P * ST + P * P + 2 * win * win + 5 * win);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lk_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lk_prep_kernel<<<K, 256, smem, (cudaStream_t)stream>>>(
      (const float*)tmpl, (const float*)srch, (const float*)pts, (const float*)guess,
      (const int*)src_t, (const int*)src_s, (float*)corr, (float*)scal, (bool*)okg, Rt, Rs, H,
      W, win, slack, pad, min_eig);
  return (int)cudaGetLastError();
}

extern "C" int opt_lk_walk(const void* corr, const void* scal, const void* pos0, void* pos,
                           void* hit, int K, int A, int r, int ws, int pad, int max_iters,
                           float eps2, void* stream) {
  if (K == 0) return 0;
  if (A > kMaxA) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  lk_walk_kernel<<<(K + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const float*)corr, (const float*)scal, (const float*)pos0, (float*)pos, (bool*)hit, K, A,
      r, ws, pad, max_iters, eps2);
  return (int)cudaGetLastError();
}
