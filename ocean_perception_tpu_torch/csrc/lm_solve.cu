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
// every system's arithmetic is fixed, whatever the batch (lm_solve.cuh: the
// pairwise trees, the normal equations' phases and the pivoting solve).
// On the card the Sea-thru fits run whole in sea_thru_fit.cu, which shares
// that code; these two kernels serve the fits' loop (ops/lm.py::lm_solve,
// the fits' plain version) and trilateration's fits.
//
// - lm_solve_small: a block of kSolveThreads a system (P <= 16), in four
//   phases between block barriers. (1) The block stages J and r in shared
//   memory, coalesced (16-byte loads where J is aligned, a thread's loads in
//   flight together), transposed: a row a column of J, then r, a leaf a
//   word, one word skipped after each segment and one after each row. (2)
//   normal_segments, (3) normal_entries, (4) damped_solve (lm_solve.cuh).
//   P = 12 (the Sea-thru fits) and P = 3 (trilateration) are compiled with P
//   known. Twin: ops/lm.py::lm_step_plain;
// - lm_row_sum: a warp a row, lane l the segment l, the segment sums
//   meeting through shuffles. Twin: tree_sum_plain.
//
// Both kernels are templates on the scalar type: the float build
// (opt_lm_solve_small, opt_lm_row_sum) and the double build, the same code
// with the double intrinsics (__dmul_rn, ...) for the float64 fits
// (vio/trilateration.py; opt_lm_solve_small_f64, opt_lm_row_sum_f64).
//
// What bounds lm_solve_small: neither bytes (each J read once, 12 KB a
// system at N = 256) nor operations (P(P+1)/2 + P dot products of N
// terms), but its chain of dependent steps: the loads, the trees, then P
// pivot reductions, each before an elimination (a quotient, a product and a
// difference), and P back-substitution steps. A call is 1 to 12 systems, a
// block each on its own SM, so the design shortens that chain: the trees
// are spread over the block's warps (not 90 trees one after another on one
// warp), the pivot is one reduction instead of a lane's scan, and the
// elimination and back substitution keep the matrix in registers, with
// shuffles instead of shared memory and barriers between the steps
// (PERF.md, section 6, has the phases' cycles on the H100). K is a template
// constant up to 64 (Np <= 2048); a longer row takes the same tree with a
// segment's leaves summed through a stack in local memory, reading J from
// device memory when the staging would not fit in 48 KB of shared memory
// beside the segment sums.

#include "lm_solve.cuh"

namespace {

constexpr int kLoads = 4;           // staging loads in flight a thread
constexpr int kRowWarps = 4;        // rows a block of lm_row_sum

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
  const int n_entries = normal_entries_of(P);
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

  // (2) The segment sums, (3) the entries, (4) warp 0's solve.
  normal_segments<T, K>(rows, row, shift, staged, col, seg, P, S, k_any, warp, lane);
  __syncthreads();
  normal_entries<T>(seg, P, S, tid, A, b);
  __syncthreads();
  if (warp != 0) return;
  damped_solve<kP>(A, b, l, lane, P, marquardt, delta + m * P);
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

template <class T>
int solve_small(const void* J, const void* r, const void* lam, void* delta, int M, int N, int P,
                int marquardt, void* stream) {
  if (P < 1 || P > kMaxP || N < 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const Layout lay(N);
  const size_t seg_bytes = sizeof(T) * normal_entries_of(P) * kSegStride;
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
