// The damped Levenberg-Marquardt system of a fit and its solve, shared by
// lm_solve.cu (lm_solve_small, a block a system) and sea_thru_fit.cu (a
// block a whole Sea-thru fit, the same system solved once an iteration).
//
// - Every sum over the N samples is the pairwise tree of
//   ops/lm.py::tree_sum_plain: zeros past N up to Np, the power of two >= N,
//   then neighbours (2m, 2m+1) added level by level. Its leaves are cut into
//   S = min(Np, 32) segments of K = Np / S: a thread adds a segment's K
//   leaves pairwise in registers, and the S segment sums meet pairwise in
//   the same order. A segment is an aligned power-of-two subtree, so the
//   split keeps the twin's association exactly.
// - The system is built from the staged rows of [J r] (a row a column of J,
//   then r; a leaf a word, one word skipped after each segment and one after
//   each row, so that neither the staging's stores nor the segments' loads
//   fall on one bank) in three phases between block barriers.
//   normal_segments: the normal equations are the upper triangle of
//   [J r]^T [J r] without its corner r.r, P(P+1)/2 + P entries (i, j), row
//   by row; the warps take contiguous runs of them, lane s sums the products
//   of columns i and j over segment s, keeping column i's leaves in
//   registers along a run, and stores the segment sum. normal_entries: a
//   thread an entry adds its S segment sums and writes JtJ[i][j] (both
//   halves) or b[i] = -Jtr[i]. damped_solve: warp 0 solves; lane l holds
//   row l of A = JtJ + lam * damp, damp = diag(max(diag JtJ, 1e-12))
//   (Marquardt) or I, and b[l], in registers. Elimination step k takes the
//   pivot by a warp reduction (the first row of largest |A[i][k]|, i >= k, a
//   NaN above any number: torch.argmax's order), swaps rows k and p and
//   hands every lane the pivot row by one shuffle a register, and each lane
//   below k eliminates its row: f = A[l][k] / A[k][k], then A[l][c] - f *
//   A[k][c] for each c > k and b. Back substitution: lane i divides, a
//   shuffle hands x_i to the lanes above, which update their b. P known at
//   compile time unrolls every step over its live columns; any other P runs
//   the same steps as a loop. Twin: ops/lm.py::lm_step_plain.
//
// Every product, quotient and sum is pinned with __fmul_rn, __fdiv_rn,
// __fadd_rn or __fsub_rn (the double intrinsics for double), so nvcc cannot
// contract one into an FMA: kernel and twin agree bit for bit, and a
// system's bits depend neither on the batch nor on which thread computes
// them.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxP = 16;
constexpr int kSolveThreads = 256;  // a block of lm_solve_small or sea_thru_fit
constexpr int kSolveWarps = kSolveThreads / 32;
constexpr int kSegStride = 33;      // words an entry's segment sums: S <= 32, and one apart
constexpr int kMaxDepth = 33;     // levels of a lane's subtree + 1
constexpr int kSharedLimit = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// Rounded arithmetic of each scalar type, none of it contractible.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
// The Marquardt floor, 1e-12 in the scalar type (the twin's clamp_min).
template <class T>
__device__ __forceinline__ T damp_floor() { return T(1e-12); }
template <>
__device__ __forceinline__ float damp_floor<float>() { return 1e-12f; }

// a / b rounded to nearest, the quotient of a zero dividend (0 with b's sign
// flipped into it, as IEEE division gives it) taken without the division,
// whose range check sends a zero dividend down its slow path. Some of the
// Sea-thru fits' systems hold exact zeros below a pivot.
template <class T>
__device__ __forceinline__ T quotient(T a, T b) {
  const bool zero = a == T(0) && b == b && b != T(0);
  const T q = div_rn(zero ? b : a, b);
  return zero ? mul_rn(a, copysign(T(1), b)) : q;
}

// The sum of a lane's K leaves, leaf(k) for k < K, by the pairwise tree.
template <class T, int K, class Leaf>
__device__ __forceinline__ T lane_tree(const Leaf& leaf) {
  T v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = leaf(k);
#pragma unroll
  for (int s = 1; s < K; s *= 2) {
#pragma unroll
    for (int k = 0; k < K; k += 2 * s) v[k] = add_rn(v[k], v[k + s]);
  }
  return v[0];
}

// The same for a run-time K (a power of two): leaf k joins the finished
// subtrees on a stack, merging (left + right) while the count of leaves
// before it has trailing ones, which pairs (2m, 2m+1) at every level.
template <class T, class Leaf>
__device__ __forceinline__ T lane_tree_any(const Leaf& leaf, int K) {
  T stack[kMaxDepth];
  int depth = 0;
  for (int k = 0; k < K; ++k) {
    T v = leaf(k);
    for (int c = k; c & 1; c >>= 1) v = add_rn(stack[--depth], v);
    stack[depth++] = v;
  }
  return stack[0];
}

// The lanes' values v (lane l the sum of segment l, 0 from lanes >= lanes)
// added by the pairwise tree; the sum, in every lane. All 32 lanes must
// call it.
template <class T>
__device__ __forceinline__ T segment_tree(T v, int lanes) {
  for (int off = 1; off < lanes; off *= 2) v = add_rn(v, __shfl_down_sync(kFull, v, off));
  return __shfl_sync(kFull, v, 0);
}

// The warp's tree over Np leaves, leaf(n) for n < Np (0 past N is the
// caller's), lane l holding [l K, (l + 1) K); the sum, in every lane. All 32
// lanes must call it.
template <class T, int K, class Leaf>
__device__ __forceinline__ T warp_tree(const Leaf& leaf, int lane, int lanes, int k_any) {
  T v = T(0);
  if (lane < lanes) {
    if constexpr (K > 0) {
      v = lane_tree<T, K>([&](int k) { return leaf(lane * K + k); });
    } else {
      v = lane_tree_any<T>([&](int k) { return leaf(lane * k_any + k); }, k_any);
    }
  }
  return segment_tree(v, lanes);
}

struct Layout {
  int N, Np, lanes, K;
  __host__ __device__ Layout(int n) : N(n), Np(1) {
    while (Np < N) Np <<= 1;
    lanes = Np < 32 ? Np : 32;
    K = Np / lanes;
  }
  // Words a staged row: a leaf a word, one skipped after each segment of K.
  __host__ __device__ int row_words() const { return Np + lanes; }
};

// The 16 bytes of a load.
__device__ __forceinline__ float elem(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}
__device__ __forceinline__ double elem(const double2& v, int u) { return u == 0 ? v.x : v.y; }

// The lane of the first row of largest |v| among the lanes with cand (one at
// least), a NaN above any number and the first NaN winning: torch.argmax's
// order. |v| is compared by its bits, which order the non-negative numbers;
// every NaN gets the same bits above infinity's.
__device__ __forceinline__ int pivot_lane(float v, bool cand) {
  const unsigned key = isnan(v) ? 0x7fc00000u : __float_as_uint(fabsf(v));
  const unsigned top = __reduce_max_sync(kFull, cand ? key : 0u);
  return __ffs(__ballot_sync(kFull, cand && key == top)) - 1;
}
__device__ __forceinline__ int pivot_lane(double v, bool cand) {
  const unsigned long long key =
      isnan(v) ? 0x7ff8000000000000ull : (unsigned long long)__double_as_longlong(fabs(v));
  const unsigned hi = unsigned(key >> 32), lo = unsigned(key);
  const unsigned top_hi = __reduce_max_sync(kFull, cand ? hi : 0u);
  const bool high = cand && hi == top_hi;
  const unsigned top_lo = __reduce_max_sync(kFull, high ? lo : 0u);
  return __ffs(__ballot_sync(kFull, high && lo == top_lo)) - 1;
}

// The elimination and back substitution of a system of P <= C parameters,
// lane l holding row l of A in a[0, C) and of b in bv: every step and
// column unrolled, a[c] holding column c. C is P where P is known at
// compile time (the Sea-thru fits' 12, trilateration's 3), so that a step
// touches only its live columns; else kMaxP, the columns past P garbage no
// step reads. Step k takes the pivot by a warp reduction, then one shuffle
// a register both swaps rows k and p and hands every lane the pivot row:
// lane p reads lane k's row, every other lane lane p's, and lane p keeps
// its own row as the pivot row. x[i] gets the solution.
template <int C, class T>
__device__ __forceinline__ void solve_rows(T (&a)[kMaxP], T bv, int lane, int P, T* x) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    if (k >= P) break;
    const int p = pivot_lane(a[k], lane >= k && lane < P);
    const int src = lane == p ? k : p;
    const bool moves = lane == k || lane == p;
    T pivot_row[C];
#pragma unroll
    for (int c = k; c < C; ++c) {
      const T got = __shfl_sync(kFull, a[c], src);
      pivot_row[c] = lane == p ? a[c] : got;
      if (moves) a[c] = got;
    }
    const T got_b = __shfl_sync(kFull, bv, src);
    const T pivot_b = lane == p ? bv : got_b;
    if (moves) bv = got_b;
    if (lane > k && lane < P) {
      const T f = quotient(a[k], pivot_row[k]);
#pragma unroll
      for (int c = k + 1; c < C; ++c) a[c] = sub_rn(a[c], mul_rn(f, pivot_row[c]));
      bv = sub_rn(bv, mul_rn(f, pivot_b));
    }
  }
#pragma unroll
  for (int i = C - 1; i >= 0; --i) {
    if (i >= P) continue;
    // The other lanes divide 1 by 1, which takes no special case.
    const T xi = __shfl_sync(kFull, quotient(lane == i ? bv : T(1), lane == i ? a[i] : T(1)), i);
    if (lane == i) x[i] = xi;
    if (lane < i) bv = sub_rn(bv, mul_rn(a[i], xi));
  }
}

// Entry e of the normal equations, row by row over the upper triangle of
// [J r]^T [J r]: row i < P holds (i, i) .. (i, P), column P being r.
__device__ __forceinline__ void entry_of(int e, int P, int& i, int& j) {
  i = 0;
  while (e > P - i) e -= P + 1 - i++;
  j = i + e;
}

__host__ __device__ constexpr int normal_entries_of(int P) { return (P + 1) * (P + 2) / 2 - 1; }

// The segment sums of the normal equations' entries into seg (an entry
// kSegStride words), a run of entries a warp, lane s segment s: from the
// staged rows (row words apart, leaf n at word n + n / K) or, when not
// staged, from col(c, n), column c of J (P: r) at leaf n, 0 past N. K is
// the segment's leaves where known at compile time, else 0 and k_any.
template <class T, int K, class Col>
__device__ __forceinline__ void normal_segments(const T* rows, int row, int shift, int staged,
                                                const Col& col, T* seg, int P, int S, int k_any,
                                                int warp, int lane) {
  const int n_entries = normal_entries_of(P);
  const auto word = [&](int n) { return n + (n >> shift); };
  const int e_begin = warp * n_entries / kSolveWarps;
  const int e_end = (warp + 1) * n_entries / kSolveWarps;
  if (lane < S && e_begin < e_end) {
    int i, j;
    entry_of(e_begin, P, i, j);
    if constexpr (K > 0) {
      const int base = lane * K;            // the segment's first leaf
      const int sbase = lane * (K + 1);     // and its word
      T ci[K];
      int cached = -1;
#pragma unroll 4
      for (int e = e_begin; e < e_end; ++e) {
        if (i != cached) {
#pragma unroll
          for (int k = 0; k < K; ++k) ci[k] = staged ? rows[i * row + sbase + k] : col(i, base + k);
          cached = i;
        }
        T s;
        if (staged) {
          s = lane_tree<T, K>([&](int k) { return mul_rn(ci[k], rows[j * row + sbase + k]); });
        } else {
          s = lane_tree<T, K>([&](int k) { return mul_rn(ci[k], col(j, base + k)); });
        }
        seg[e * kSegStride + lane] = s;
        if (++j > P) j = ++i;
      }
    } else {
      for (int e = e_begin; e < e_end; ++e) {
        const int base = lane * k_any;
        seg[e * kSegStride + lane] = lane_tree_any<T>([&](int k) {
          const int n = base + k;
          return staged ? mul_rn(rows[i * row + word(n)], rows[j * row + word(n)])
                        : mul_rn(col(i, n), col(j, n));
        }, k_any);
        if (++j > P) j = ++i;
      }
    }
  }
}

// A thread an entry: its S segment sums by the pairwise tree, into
// JtJ[i][j] and JtJ[j][i], or b[i] = -Jtr[i].
template <class T>
__device__ __forceinline__ void normal_entries(const T* seg, int P, int S, int tid,
                                               T (&A)[kMaxP][kMaxP + 1], T (&b)[kMaxP]) {
  const int n_entries = normal_entries_of(P);
  for (int e = tid; e < n_entries; e += kSolveThreads) {
    T v[32];
#pragma unroll
    for (int s = 0; s < 32; ++s) v[s] = s < S ? seg[e * kSegStride + s] : T(0);
#pragma unroll
    for (int h = 1; h < 32; h *= 2) {
      if (h < S) {
#pragma unroll
        for (int s = 0; s < 32; s += 2 * h) v[s] = add_rn(v[s], v[s + h]);
      }
    }
    int i, j;
    entry_of(e, P, i, j);
    if (j < P) {
      A[i][j] = v[0];
      A[j][i] = v[0];
    } else {
      b[i] = -v[0];
    }
  }
}

// Warp 0's solve of (JtJ + lam * damp) x = b: lane l row l (the
// off-diagonal terms add lam * 0 as the twin's full damping matrix does;
// the lanes past P hold ones). kP is P where known at compile time, else 0.
template <int kP, class T>
__device__ __forceinline__ void damped_solve(const T (&A)[kMaxP][kMaxP + 1], const T (&b)[kMaxP],
                                             T l, int lane, int P, int marquardt, T* x) {
  T a[kMaxP], bv = T(0);
#pragma unroll
  for (int c = 0; c < kMaxP; ++c) a[c] = T(1);
  if (lane < P) {
    const T jj = A[lane][lane];
    const T d = marquardt ? (jj < damp_floor<T>() ? damp_floor<T>() : jj) : T(1);
#pragma unroll
    for (int c = 0; c < kMaxP; ++c) {
      if (c < P) a[c] = add_rn(A[lane][c], mul_rn(l, c == lane ? d : T(0)));
    }
    bv = b[lane];
  }
  solve_rows<(kP > 0 ? kP : kMaxP)>(a, bv, lane, P, x);
}

// f(std::integral_constant<int, K>) for a row's K (0: the run-time K).
template <class F>
int dispatch(int K, F&& f) {
  switch (K) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return f(std::integral_constant<int, 0>{});
  }
}

}  // namespace
