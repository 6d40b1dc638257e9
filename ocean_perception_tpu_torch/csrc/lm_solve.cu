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
//   then neighbours (2m, 2m+1) added level by level. Its leaves are cut into
//   S = min(Np, 32) segments of K = Np / S: a thread adds a segment's K
//   leaves pairwise in registers, and the S segment sums meet pairwise in
//   the same order. A segment is an aligned power-of-two subtree, so the
//   split keeps the twin's association exactly;
// - lm_solve_small: a block of kSolveThreads a system (P <= 16), in four
//   phases between block barriers. (1) The block stages J and r in shared
//   memory, coalesced (16-byte loads where J is aligned, a thread's loads in
//   flight together), transposed: a row a column of J, then r, a leaf a
//   word, one word skipped after each segment and one after each row, so
//   that neither the copy's stores nor the segments' loads fall on one bank.
//   (2) The normal equations are the upper triangle of [J r]^T [J r]
//   without its corner r.r: P(P+1)/2 + P entries (i, j), row by row. The
//   warps take contiguous runs of them; lane s sums the products of columns
//   i and j over segment s, keeping column i's leaves in registers along a
//   run, and stores the segment sum. (3) A thread an entry adds its S
//   segment sums and writes JtJ[i][j] (both halves) or b[i] = -Jtr[i].
//   (4) Warp 0 solves: lane l holds row l of A = JtJ + lam * damp,
//   damp = diag(max(diag JtJ, 1e-12)) (Marquardt) or I, and b[l], in
//   registers. Elimination step k takes the pivot by a warp reduction (the
//   first row of largest |A[i][k]|, i >= k, a NaN above any number:
//   torch.argmax's order), swaps rows k and p and hands every lane the pivot
//   row by one shuffle a register, and each lane below k eliminates its row:
//   f = A[l][k] / A[k][k], then A[l][c] - f * A[k][c] for each c > k and b.
//   Back substitution: lane i divides, a shuffle hands x_i to the lanes
//   above, which update their b. P = 12 (the Sea-thru fits) and P = 3
//   (trilateration) are compiled with P known, every step unrolled over its
//   live columns; any other P runs the same steps as a loop. Twin:
//   ops/lm.py::lm_step_plain;
// - lm_row_sum: a warp a row, lane l the segment l, the segment sums
//   meeting through shuffles. Twin: tree_sum_plain.
//
// Every product, quotient and sum is pinned with __fmul_rn, __fdiv_rn,
// __fadd_rn or __fsub_rn, so nvcc cannot contract one into an FMA: kernel
// and twin agree bit for bit, and a system's bits depend neither on M nor
// on which thread computes them.
//
// Both kernels are templates on the scalar type: the float build is the
// Sea-thru fits' (opt_lm_solve_small, opt_lm_row_sum), the double build the
// same code with the double intrinsics (__dmul_rn, ...) for the float64
// fits (vio/trilateration.py; opt_lm_solve_small_f64, opt_lm_row_sum_f64).
//
// What bounds lm_solve_small: neither bytes (each J read once, 12 KB a
// system at N = 256) nor operations (P(P+1)/2 + P dot products of N
// terms), but its chain of dependent steps: the loads, the trees, then P
// pivot reductions, each before an elimination (a quotient, a product and a
// difference), and P back-substitution steps. A fit's call is 1 to 12
// systems, a block each on its own SM, so the design shortens that chain:
// the trees are spread over the block's warps (not 90 trees one after
// another on one warp), the pivot is one reduction instead of a lane's scan,
// and the elimination and back substitution keep the matrix in registers,
// with shuffles instead of shared memory and barriers between the steps
// (PERF.md, section 6, has the phases' cycles on the H100). K is a template
// constant up to 64 (Np <= 2048); a longer row takes the same tree with a
// segment's leaves summed through a stack in local memory, reading J from
// device memory when the staging would not fit in 48 KB of shared memory
// beside the segment sums.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxP = 16;
constexpr int kSolveThreads = 256;  // a system's block of lm_solve_small
constexpr int kSolveWarps = kSolveThreads / 32;
constexpr int kSegStride = 33;      // words an entry's segment sums: S <= 32, and one apart
constexpr int kLoads = 4;           // staging loads in flight a thread
constexpr int kRowWarps = 4;        // rows a block of lm_row_sum
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
  for (int off = 1; off < lanes; off *= 2) v = add_rn(v, __shfl_down_sync(kFull, v, off));
  return __shfl_sync(kFull, v, 0);
}

struct Layout {
  int N, Np, lanes, K;
  __host__ __device__ Layout(int n) : N(n), Np(1) {
    while (Np < N) Np <<= 1;
    lanes = Np < 32 ? Np : 32;
    K = Np / lanes;
  }
  // Words a staged row of lm_solve_small: a leaf a word, one skipped after
  // each segment of K.
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

template <class T, int K, int kP>
__global__ void __launch_bounds__(kSolveThreads)
lm_solve_small_kernel(const T* __restrict__ J, const T* __restrict__ r,
                      const T* __restrict__ lam, T* __restrict__ delta, int N, int P,
                      int marquardt, int staged) {
  // The entries' segment sums, then (staged) the P + 1 staged rows: J's
  // columns, then r.
  extern __shared__ __align__(16) unsigned char shared_bytes[];
  __shared__ T A[kMaxP][kMaxP + 1];
  __shared__ T b[kMaxP];
  if constexpr (kP > 0) P = kP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long m = blockIdx.x;
  const T* Jm = J + m * N * P;
  const T* rm = r + m * N;
  const T l = warp == 0 ? lam[m] : T(0);  // loaded now, used by warp 0's solve
  const Layout lay(N);
  const int S = lay.lanes, k_any = lay.K, shift = __ffs(lay.K) - 1;
  const int row = lay.row_words() + 1;
  const int n_entries = (P + 1) * (P + 2) / 2 - 1;
  T* seg = reinterpret_cast<T*>(shared_bytes);
  T* rows = seg + n_entries * kSegStride;
  // A leaf's word in a staged row, n + n / K (K a power of two); one more
  // word after each row.
  const auto word = [&](int n) { return n + (n >> shift); };

  // (1) Staging. A thread's loads are issued kLoads at a time before their
  // stores, and r's first leaves before J's, so that their trips overlap.
  if (staged) {
    using Vec = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
    constexpr int V = sizeof(Vec) / sizeof(T);
    const int total = N * P;
    T r_first[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int n = tid + u * kSolveThreads;
      r_first[u] = n < N ? rm[n] : T(0);
    }
    int head = 0;
    if ((reinterpret_cast<unsigned long long>(Jm) & 15) == 0) {
      const int n_vec = total / V;
      for (int q0 = tid; q0 < n_vec; q0 += kLoads * kSolveThreads) {
        Vec v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int q = q0 + u * kSolveThreads;
          if (q < n_vec) v[u] = reinterpret_cast<const Vec*>(Jm)[q];
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int q = q0 + u * kSolveThreads;
          if (q >= n_vec) break;
          int n = q * V / P, c = q * V - n * P;
#pragma unroll
          for (int w = 0; w < V; ++w) {
            rows[c * row + word(n)] = elem(v[u], w);
            if (++c == P) {
              c = 0;
              ++n;
            }
          }
        }
      }
      head = n_vec * V;
    }
    for (int idx = head + tid; idx < total; idx += kSolveThreads) {
      const int n = idx / P, c = idx - n * P;
      rows[c * row + word(n)] = Jm[idx];
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int n = tid + u * kSolveThreads;
      if (n < N) rows[P * row + word(n)] = r_first[u];
    }
    for (int n = tid + kLoads * kSolveThreads; n < N; n += kSolveThreads) {
      rows[P * row + word(n)] = rm[n];
    }
    for (int n = N + tid; n < lay.Np; n += kSolveThreads) {
      for (int c = 0; c <= P; ++c) rows[c * row + word(n)] = T(0);
    }
    __syncthreads();
  }
  // Column c (P: r) at leaf n from device memory, 0 past N.
  const auto col = [&](int c, int n) -> T {
    if (n >= N) return T(0);
    return c < P ? Jm[(long long)n * P + c] : rm[n];
  };

  // (2) The segment sums, a run of entries a warp, lane s segment s.
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
  __syncthreads();

  // (3) A thread an entry: its S segment sums by the pairwise tree.
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
  __syncthreads();
  if (warp != 0) return;

  // (4) A = JtJ + lam * damp, lane l row l (the off-diagonal terms add
  // lam * 0 as the twin's full damping matrix does); the lanes past P hold
  // ones.
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
  solve_rows<(kP > 0 ? kP : kMaxP)>(a, bv, lane, P, delta + m * P);
}

template <class T, int K>
__global__ void __launch_bounds__(kRowWarps * 32)
lm_row_sum_kernel(const T* __restrict__ x, T* __restrict__ out, int M, int N) {
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (m >= M) return;  // the whole warp: m is the warp's
  const T* xm = x + m * N;
  const Layout lay(N);
  const T s = warp_tree<T, K>([&](int n) { return n < N ? xm[n] : T(0); }, lane, lay.lanes,
                              lay.K);
  if (lane == 0) out[m] = s;
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

template <class T>
int solve_small(const void* J, const void* r, const void* lam, void* delta, int M, int N, int P,
                int marquardt, void* stream) {
  if (P < 1 || P > kMaxP || N < 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const Layout lay(N);
  const size_t seg_bytes = sizeof(T) * ((P + 1) * (P + 2) / 2 - 1) * kSegStride;
  const size_t staged_bytes = sizeof(T) * (P + 1) * (lay.row_words() + 1);
  const int staged = seg_bytes + staged_bytes + sizeof(T) * kMaxP * (kMaxP + 2) <=
                     (size_t)kSharedLimit;
  return dispatch(lay.K, [&](auto k) {
    const auto launch = [&](auto p) {
      lm_solve_small_kernel<T, decltype(k)::value, decltype(p)::value>
          <<<M, kSolveThreads, seg_bytes + (staged ? staged_bytes : 0), (cudaStream_t)stream>>>(
              (const T*)J, (const T*)r, (const T*)lam, (T*)delta, N, P, marquardt, staged);
      return (int)cudaGetLastError();
    };
    // P unrolled for the systems the port solves: 12 (Sea-thru), 3 (trilateration).
    switch (P) {
      case 3: return launch(std::integral_constant<int, 3>{});
      case 12: return launch(std::integral_constant<int, 12>{});
      default: return launch(std::integral_constant<int, 0>{});
    }
  });
}

template <class T>
int row_sum(const void* x, void* out, int M, int N, void* stream) {
  if (N < 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return dispatch(Layout(N).K, [&](auto k) {
    lm_row_sum_kernel<T, decltype(k)::value>
        <<<(M + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, (cudaStream_t)stream>>>(
            (const T*)x, (T*)out, M, N);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int opt_lm_solve_small(const void* J, const void* r, const void* lam, void* delta,
                                  int M, int N, int P, int marquardt, void* stream) {
  return solve_small<float>(J, r, lam, delta, M, N, P, marquardt, stream);
}

extern "C" int opt_lm_solve_small_f64(const void* J, const void* r, const void* lam, void* delta,
                                      int M, int N, int P, int marquardt, void* stream) {
  return solve_small<double>(J, r, lam, delta, M, N, P, marquardt, stream);
}

extern "C" int opt_lm_row_sum(const void* x, void* out, int M, int N, void* stream) {
  return row_sum<float>(x, out, M, N, stream);
}

extern "C" int opt_lm_row_sum_f64(const void* x, void* out, int M, int N, void* stream) {
  return row_sum<double>(x, out, M, N, stream);
}
