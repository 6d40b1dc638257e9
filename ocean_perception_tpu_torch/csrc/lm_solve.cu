// The Levenberg-Marquardt step of many small systems, and the row sums that
// accept or reject it, for Hopper (sm_90a).
//
// No TPU kernel comes before these: the JAX package leaves its LM's normal
// equations, damped solve and error sums to XLA
// (ocean_perception_tpu/ops/lm.py:84-89, J.T @ J and jnp.linalg.solve). The
// port needs its own because a library picks its reduction order and its
// solver kernel by the number of systems, so one camera's Sea-thru fit
// rounded differently alone and in a fleet, and the fits are ill-conditioned
// enough (cond ~4e9 in float32) for that to move one out of its basin. Here
// every system's arithmetic is fixed, whatever the batch:
//
// - every sum over the N samples is the pairwise tree of
//   ops/lm.py::tree_sum_plain: zeros past N up to Np, the power of two >= N,
//   then neighbours (2m, 2m+1) added level by level. A warp computes one
//   tree: lane l holds the K = Np / 32 leaves [l K, (l + 1) K) (K = 1 and
//   Np lanes when Np < 32), adds them pairwise in registers, and the lanes'
//   subtrees meet pairwise through shuffles, so the warp reproduces the
//   twin's association exactly;
// - lm_solve_small: a warp a system (P <= 16). Its J and r are staged in
//   shared memory, transposed, a leaf a word and one word skipped after each
//   lane's K leaves so that the lanes' reads fall in different banks. Each
//   entry of JtJ (upper triangle) and Jtr is one tree; then
//   A = JtJ + lam * damp, damp = diag(max(diag JtJ, 1e-12)) (Marquardt) or
//   I, b = -Jtr; Gaussian elimination with partial pivoting (lane 0 picks
//   the first row of largest |pivot|, a lane a row eliminates) and back
//   substitution a column at a time. Twin: ops/lm.py::lm_step_plain;
// - lm_row_sum: a warp a row, the same tree. Twin: tree_sum_plain.
//
// Every product, quotient and sum is pinned with __fmul_rn, __fdiv_rn,
// __fadd_rn or __fsub_rn, so nvcc cannot contract one into an FMA: kernel
// and twin agree bit for bit, and a system's bits do not depend on M.
//
// What bounds it: neither bytes (each J read once, 12 KB a system at
// N = 256) nor operations (P(P+1)/2 + P dot products of N terms), but
// latency: each of the 90 trees of a 12-parameter system ends in five
// dependent shuffles, and the P elimination steps depend on each other; a
// fit's call is 1 to 12 systems, a few warps on a few SMs. K is a template
// constant up to 64 (Np <= 2048); a longer row takes the same tree with its
// lane's leaves summed through a stack in local memory, reading J from
// device memory when the staging would not fit in 48 KB of shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 16;
constexpr int kRowWarps = 4;      // rows a block of lm_row_sum
constexpr int kMaxDepth = 33;     // levels of a lane's subtree + 1
constexpr int kSharedLimit = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// The sum of a lane's K leaves, leaf(k) for k < K, by the pairwise tree.
template <int K, class Leaf>
__device__ __forceinline__ float lane_tree(const Leaf& leaf) {
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = leaf(k);
#pragma unroll
  for (int s = 1; s < K; s *= 2) {
#pragma unroll
    for (int k = 0; k < K; k += 2 * s) v[k] = __fadd_rn(v[k], v[k + s]);
  }
  return v[0];
}

// The same for a run-time K (a power of two): leaf k joins the finished
// subtrees on a stack, merging (left + right) while the count of leaves
// before it has trailing ones, which pairs (2m, 2m+1) at every level.
template <class Leaf>
__device__ __forceinline__ float lane_tree_any(const Leaf& leaf, int K) {
  float stack[kMaxDepth];
  int depth = 0;
  for (int k = 0; k < K; ++k) {
    float v = leaf(k);
    for (int c = k; c & 1; c >>= 1) v = __fadd_rn(stack[--depth], v);
    stack[depth++] = v;
  }
  return stack[0];
}

// The warp's tree over Np leaves, leaf(n) for n < Np (0 past N is the
// caller's), lane l holding [l K, (l + 1) K); the sum, in every lane. All 32
// lanes must call it.
template <int K, class Leaf>
__device__ __forceinline__ float warp_tree(const Leaf& leaf, int lane, int lanes, int k_any) {
  float v = 0.f;
  if (lane < lanes) {
    if constexpr (K > 0) {
      v = lane_tree<K>([&](int k) { return leaf(lane * K + k); });
    } else {
      v = lane_tree_any([&](int k) { return leaf(lane * k_any + k); }, k_any);
    }
  }
  for (int off = 1; off < lanes; off *= 2) v = __fadd_rn(v, __shfl_down_sync(kFull, v, off));
  return __shfl_sync(kFull, v, 0);
}

struct Layout {
  int N, Np, lanes, K;
  __host__ __device__ Layout(int n) : N(n), Np(1) {
    while (Np < N) Np <<= 1;
    lanes = Np < 32 ? Np : 32;
    K = Np / lanes;
  }
  // A leaf's word in a staged row: one word skipped after each lane's K.
  __device__ __forceinline__ int word(int n) const { return n + n / K; }
  __host__ __device__ int row_words() const { return Np + lanes; }
};

template <int K>
__global__ void __launch_bounds__(32)
lm_solve_small_kernel(const float* __restrict__ J, const float* __restrict__ r,
                      const float* __restrict__ lam, float* __restrict__ delta, int N, int P,
                      int marquardt, int staged) {
  extern __shared__ float rows[];  // (P + 1) staged rows: J's columns, then r
  __shared__ float A[kMaxP][kMaxP + 1];
  __shared__ float b[kMaxP];
  const int lane = threadIdx.x;
  const long long m = blockIdx.x;
  const float* Jm = J + m * N * P;
  const float* rm = r + m * N;
  const Layout lay(N);
  const int row = lay.row_words();

  if (staged) {
    for (int idx = lane; idx < N * P; idx += 32) {
      const int n = idx / P, c = idx - n * P;
      rows[c * row + lay.word(n)] = Jm[idx];
    }
    for (int n = lane; n < N; n += 32) rows[P * row + lay.word(n)] = rm[n];
    for (int n = N + lane; n < lay.Np; n += 32) {
      for (int c = 0; c <= P; ++c) rows[c * row + lay.word(n)] = 0.f;
    }
    __syncwarp();
  }
  // Column c (P: r) at leaf n, 0 past N.
  const auto col = [&](int c, int n) -> float {
    if (staged) return rows[c * row + lay.word(n)];
    if (n >= N) return 0.f;
    return c < P ? Jm[(long long)n * P + c] : rm[n];
  };

  // The normal equations: entry e < P(P+1)/2 is JtJ[i][j], i <= j, row by
  // row; the P after them are Jtr.
  const int n_jtj = P * (P + 1) / 2;
  for (int e = 0; e < n_jtj + P; ++e) {
    int i, j;
    if (e < n_jtj) {
      int rest = e;
      i = 0;
      while (rest >= P - i) rest -= P - i++;
      j = i + rest;
    } else {
      i = e - n_jtj;
      j = P;
    }
    const float s = warp_tree<K>([&](int n) { return __fmul_rn(col(i, n), col(j, n)); }, lane,
                                 lay.lanes, lay.K);
    if (lane == 0) {
      if (j < P) {
        A[i][j] = s;
        A[j][i] = s;
      } else {
        b[i] = -s;
      }
    }
  }
  __syncwarp();

  // A = JtJ + lam * damp, a lane a row; the off-diagonal terms add lam * 0
  // as the twin's full damping matrix does.
  if (lane < P) {
    const float l = lam[m];
    const float jj = A[lane][lane];
    const float d = marquardt ? (jj < 1e-12f ? 1e-12f : jj) : 1.f;
    for (int c = 0; c < P; ++c) A[lane][c] = __fadd_rn(A[lane][c], __fmul_rn(l, c == lane ? d : 0.f));
  }
  __syncwarp();

  for (int k = 0; k < P; ++k) {
    // The pivot: the first row of largest |A[i][k]|, a NaN beating any
    // number (torch.argmax's order).
    int p = k;
    if (lane == 0) {
      float best = fabsf(A[k][k]);
      for (int i = k + 1; i < P; ++i) {
        const float v = fabsf(A[i][k]);
        if (!isnan(best) && (isnan(v) || v > best)) {
          best = v;
          p = i;
        }
      }
    }
    p = __shfl_sync(kFull, p, 0);
    if (p != k) {
      if (lane < P) {
        const float t = A[k][lane];
        A[k][lane] = A[p][lane];
        A[p][lane] = t;
      }
      if (lane == 0) {
        const float t = b[k];
        b[k] = b[p];
        b[p] = t;
      }
    }
    __syncwarp();
    if (lane > k && lane < P) {
      const float f = __fdiv_rn(A[lane][k], A[k][k]);
      for (int c = k + 1; c < P; ++c) A[lane][c] = __fsub_rn(A[lane][c], __fmul_rn(f, A[k][c]));
      b[lane] = __fsub_rn(b[lane], __fmul_rn(f, b[k]));
    }
    __syncwarp();
  }

  for (int i = P - 1; i >= 0; --i) {
    const float xi = __fdiv_rn(b[i], A[i][i]);
    if (lane == i) delta[m * P + i] = xi;
    if (lane < i) b[lane] = __fsub_rn(b[lane], __fmul_rn(A[lane][i], xi));
    __syncwarp();
  }
}

template <int K>
__global__ void __launch_bounds__(kRowWarps * 32)
lm_row_sum_kernel(const float* __restrict__ x, float* __restrict__ out, int M, int N) {
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (m >= M) return;  // the whole warp: m is the warp's
  const float* xm = x + m * N;
  const Layout lay(N);
  const float s = warp_tree<K>([&](int n) { return n < N ? xm[n] : 0.f; }, lane, lay.lanes,
                               lay.K);
  if (lane == 0) out[m] = s;
}

// A kernel's instance for a row's K (0: the run-time K).
template <template <int> class Launch, class... Args>
int dispatch(int K, Args... args) {
  switch (K) {
    case 1: return Launch<1>::run(args...);
    case 2: return Launch<2>::run(args...);
    case 4: return Launch<4>::run(args...);
    case 8: return Launch<8>::run(args...);
    case 16: return Launch<16>::run(args...);
    case 32: return Launch<32>::run(args...);
    case 64: return Launch<64>::run(args...);
    default: return Launch<0>::run(args...);
  }
}

template <int K>
struct SolveLaunch {
  static int run(const void* J, const void* r, const void* lam, void* delta, int M, int N, int P,
                 int marquardt, cudaStream_t s) {
    const Layout lay(N);
    const size_t bytes = sizeof(float) * (P + 1) * lay.row_words();
    const int staged = bytes <= (size_t)kSharedLimit - sizeof(float) * kMaxP * (kMaxP + 2);
    lm_solve_small_kernel<K><<<M, 32, staged ? bytes : 0, s>>>(
        (const float*)J, (const float*)r, (const float*)lam, (float*)delta, N, P, marquardt,
        staged);
    return (int)cudaGetLastError();
  }
};

template <int K>
struct RowSumLaunch {
  static int run(const void* x, void* out, int M, int N, cudaStream_t s) {
    lm_row_sum_kernel<K><<<(M + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, s>>>(
        (const float*)x, (float*)out, M, N);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" int opt_lm_solve_small(const void* J, const void* r, const void* lam, void* delta,
                                  int M, int N, int P, int marquardt, void* stream) {
  if (P < 1 || P > kMaxP || N < 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return dispatch<SolveLaunch>(Layout(N).K, J, r, lam, delta, M, N, P, marquardt,
                               (cudaStream_t)stream);
}

extern "C" int opt_lm_row_sum(const void* x, void* out, int M, int N, void* stream) {
  if (N < 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return dispatch<RowSumLaunch>(Layout(N).K, x, out, M, N, (cudaStream_t)stream);
}
