// One Sea-thru Levenberg-Marquardt fit a block, every iteration in one
// launch, for Hopper (sm_90a).
//
// No TPU kernel comes before it: the JAX package runs the fits' LM as XLA's
// lax.fori_loop (ocean_perception_tpu/ops/lm.py:48-106, driven by
// imaging/backscatter.py and imaging/attenuation.py). The port's plain
// version (ops/lm.py::lm_solve with the fits' residual_jac and error_fn)
// runs max_iters Python iterations of some 80 small launches each, two of
// them lm_solve_small and lm_row_sum: about 2,500 kernels an enhanced frame,
// each a launch's cost for microseconds of work. Here one block of
// kSolveThreads runs one fit from its start to its result:
//
// - setup: the block stages the fit's N samples in shared memory (the
//   colour triple, z and the valid flag as a 0/1 weight; the attenuation
//   model stages log(max(E, 1e-3))), counts the valid ones, takes the start
//   (the attenuation model projects it), then builds the normal equations
//   at the start. lambda0 is lambda0_scale times their largest diagonal
//   entry (the tree sums of the squared Jacobian columns, as lm_solve takes
//   them), and the start's error is summed;
// - each iteration: (1) on the first one and after an accepted step, a
//   thread a sample writes the sample's weighted residual and Jacobian row
//   straight into the staged rows of [J r] (lm_solve.cuh), and the block
//   forms the normal equations from them (normal_segments,
//   normal_entries); after a rejected step x, and with it J, r and the
//   normal equations, are unchanged, so they are kept; (2) warp 0 solves
//   the damped system (damped_solve), zeroes a step that is not finite
//   everywhere, takes x + step_size * delta and projects it; (3) a thread a
//   sample writes the error leaf at x_new, warp 0 sums the leaves by the
//   pairwise tree (lm_row_sum's association) and divides by max(n_valid,
//   1); (4) warp 0 accepts or rejects, updates lambda and clamps it, and
//   counts the accepted steps. x, lambda, the error and the count stay in
//   warp 0's registers for the whole loop;
// - the block writes x, the error, lambda and the accepted steps.
//
// The kernel is held bit for bit to the plain version on the card, so every
// expression is rounded as PyTorch's CUDA kernels round it: each product,
// quotient and sum is its own __fmul_rn, __fdiv_rn, __fadd_rn or __fsub_rn
// (nvcc would otherwise contract a * b + c), in Python's association, left
// to right; 1.0 / t is an IEEE quotient (t.reciprocal() * 1.0); expf and
// logf are CUDA's accurate ones (no --use_fast_math); torch.clamp,
// clamp_min and clamp_max keep a NaN, which fminf and fmaxf alone would
// drop; lambda / lambda_down is lambda times the float reciprocal of
// lambda_down, which the caller passes, as PyTorch divides a CUDA tensor by
// a Python scalar.
//
// What bounds it: neither bytes (a fit reads its samples once, 5 KB at
// N = 256) nor operations (~10^6 an attenuation fit, 0.015 us at 67
// TFLOP/s) but its chain: max_iters solves of lm_solve_small's chain, one
// after another, each with an error pass, a tree and a handful of block
// barriers around it, and the normal equations after each accepted step.
// The fits of a call (a camera's backscatter fit, or one start of a
// camera's attenuation multi-start) are blocks on their own SMs, side by
// side. The design keeps the loop on chip: the samples, the staged rows and
// the system never leave shared memory, nothing is launched between the
// iterations, and a rejected step costs only the solve and the error pass.

#include "lm_solve.cuh"

namespace {

constexpr int kP = 12;  // parameters of both models: 4 per colour channel

// torch.clamp_min(v, lo) and torch.clamp_max(v, hi) on the card: a NaN
// stays.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// channel_sq: the squared residuals of the three channels, left to right.
__device__ __forceinline__ float channel_sq(const float (&rc)[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(rc[0], rc[0]), __fmul_rn(rc[1], rc[1])),
                   __fmul_rn(rc[2], rc[2]));
}

// The Cauchy weight 1.0 / (1.0 + r * r) * w_valid.
__device__ __forceinline__ float cauchy_weight(float r, float wv) {
  return __fmul_rn(__fdiv_rn(1.0f, __fadd_rn(__fmul_rn(r, r), 1.0f)), wv);
}

// The backscatter model, X = [B, beta_B, J', beta_D'], a colour channel a
// column of each (imaging/backscatter.py, fit_backscatter and
// _residual_terms): r_c = rgb - (B (1 - exp(-beta_B z)) + J' exp(-beta_D' z)).
struct Backscatter {
  __device__ static float stage(float rgb) { return rgb; }
  __device__ static float start(int, float v) { return v; }
  __device__ static float project(int, float v) { return clamp_min(v, 0.0f); }

  __device__ static void terms(const float (&X)[kP], float z, const float (&rgb)[3],
                               float (&rc)[3], float (&e_b)[3], float (&atten)[3],
                               float (&e_d)[3]) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      e_b[ch] = expf(__fmul_rn(-X[3 + ch], z));
      atten[ch] = __fsub_rn(1.0f, e_b[ch]);
      e_d[ch] = expf(__fmul_rn(-X[9 + ch], z));
      const float model = __fadd_rn(__fmul_rn(X[ch], atten[ch]), __fmul_rn(X[6 + ch], e_d[ch]));
      rc[ch] = __fsub_rn(rgb[ch], model);
    }
  }

  // The weighted residual w r and Jacobian row w J of a sample.
  __device__ static float residual(const float (&X)[kP], float z, const float (&rgb)[3],
                                   float wv, float (&J)[kP]) {
    float rc[3], e_b[3], atten[3], e_d[3];
    terms(X, z, rgb, rc, e_b, atten, e_d);
    const float r = channel_sq(rc);
    const float w = cauchy_weight(r, wv);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float m2 = __fmul_rn(rc[ch], -2.0f);
      J[ch] = __fmul_rn(w, __fmul_rn(m2, atten[ch]));
      J[3 + ch] = __fmul_rn(w, __fmul_rn(__fmul_rn(__fmul_rn(m2, X[ch]), z), e_b[ch]));
      J[6 + ch] = __fmul_rn(w, __fmul_rn(m2, e_d[ch]));
      J[9 + ch] = __fmul_rn(
          w, __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(rc[ch], 2.0f), X[6 + ch]), z), e_d[ch]));
    }
    return __fmul_rn(w, r);
  }

  // The error leaf: channel_sq(r_c) * w_valid.
  __device__ static float error(const float (&X)[kP], float z, const float (&rgb)[3], float wv) {
    float rc[3], e_b[3], atten[3], e_d[3];
    terms(X, z, rgb, rc, e_b, atten, e_d);
    return __fmul_rn(channel_sq(rc), wv);
  }
};

// The attenuation model, X = [a, b, c, d] (imaging/attenuation.py,
// fit_beta): beta = a exp(b z) + c exp(d z), r_c = z + log(E) / max(beta,
// 1e-3), in the range domain; the start and each step are projected to
// a, c >= 0 and b, d <= 0 (_clamp_beta).
struct Attenuation {
  // 1e-3 as PyTorch casts the Python float to the tensor's float.
  __device__ static float beta_floor() { return static_cast<float>(1e-3); }
  __device__ static float stage(float E) { return logf(clamp_min(E, beta_floor())); }
  __device__ static float project(int c, float v) {
    return (c / 3) % 2 == 0 ? clamp_min(v, 0.0f) : clamp_max(v, 0.0f);
  }
  __device__ static float start(int c, float v) { return project(c, v); }

  __device__ static void terms(const float (&X)[kP], float z, const float (&log_e)[3],
                               float (&rc)[3], float (&e_b)[3], float (&e_d)[3],
                               float (&beta)[3]) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      e_b[ch] = expf(__fmul_rn(X[3 + ch], z));
      e_d[ch] = expf(__fmul_rn(X[9 + ch], z));
      beta[ch] = __fadd_rn(__fmul_rn(X[ch], e_b[ch]), __fmul_rn(X[6 + ch], e_d[ch]));
      const float beta_inv = __fdiv_rn(1.0f, clamp_min(beta[ch], beta_floor()));
      rc[ch] = __fsub_rn(z, __fmul_rn(-log_e[ch], beta_inv));
    }
  }

  __device__ static float residual(const float (&X)[kP], float z, const float (&log_e)[3],
                                   float wv, float (&J)[kP]) {
    float rc[3], e_b[3], e_d[3], beta[3];
    terms(X, z, log_e, rc, e_b, e_d, beta);
    const float r = channel_sq(rc);
    const float w = cauchy_weight(r, wv);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float beta2 = clamp_min(__fmul_rn(beta[ch], beta[ch]), beta_floor());
      const float beta2_inv = __fdiv_rn(1.0f, beta2);
      const float outer = __fmul_rn(__fmul_rn(__fmul_rn(rc[ch], -2.0f), log_e[ch]), beta2_inv);
      const float outer_z = __fmul_rn(outer, z);
      J[ch] = __fmul_rn(w, __fmul_rn(outer, e_b[ch]));
      J[3 + ch] = __fmul_rn(w, __fmul_rn(__fmul_rn(outer_z, X[ch]), e_b[ch]));
      J[6 + ch] = __fmul_rn(w, __fmul_rn(outer, e_d[ch]));
      J[9 + ch] = __fmul_rn(w, __fmul_rn(__fmul_rn(outer_z, X[6 + ch]), e_d[ch]));
    }
    return __fmul_rn(w, r);
  }

  __device__ static float error(const float (&X)[kP], float z, const float (&log_e)[3],
                                float wv) {
    float rc[3], e_b[3], e_d[3], beta[3];
    terms(X, z, log_e, rc, e_b, e_d, beta);
    return __fmul_rn(channel_sq(rc), wv);
  }
};

struct FitArgs {
  const float* colour;         // (cameras, N, 3): rgb, or the illuminant E
  const float* z;              // (cameras, N)
  const unsigned char* valid;  // (cameras, N), bool
  const float* x0;             // (G, 12), every camera's, or (cameras, G, 12)
  float* x;                    // (cameras, G, 12)
  float* error;                // (cameras, G)
  float* lambda;               // (cameras, G)
  int* n_accepted;             // (cameras, G)
  int N, G, x0_per_camera, max_iters, marquardt;
  float lambda0_scale, lambda_up, lambda_down_inv, step_size, min_lambda, max_lambda;
};

// Words of a block's dynamic shared memory: the entries' segment sums, the
// P + 1 staged rows, the error leaves (a staged row's layout) and the
// staged samples (3 colour channels, z, the valid weight).
__host__ __device__ inline int fit_shared_words(const Layout& lay) {
  return normal_entries_of(kP) * kSegStride + (kP + 2) * (lay.row_words() + 1) + 5 * lay.Np;
}

// Fit blockIdx.x = camera * G + start.
template <int K, class Model>
__global__ void __launch_bounds__(kSolveThreads) sea_thru_fit_kernel(const FitArgs a) {
  extern __shared__ __align__(16) unsigned char shared_bytes[];
  __shared__ float A[kMaxP][kMaxP + 1];
  __shared__ float b[kMaxP];
  __shared__ float xs[kP], x_new[kP], delta[kMaxP];
  __shared__ int accepted;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long m = blockIdx.x, cam = m / a.G;
  const int N = a.N;
  const Layout lay(N);
  const int S = lay.lanes, Np = lay.Np, shift = __ffs(K) - 1, row = lay.row_words() + 1;
  float* seg = reinterpret_cast<float*>(shared_bytes);
  float* rows = seg + normal_entries_of(kP) * kSegStride;
  float* leaves = rows + (kP + 1) * row;
  float* colour = leaves + row;  // channel ch of sample n at ch * Np + n
  float* zs = colour + 3 * Np;
  float* wv = zs + Np;
  const auto word = [&](int n) { return n + (n >> shift); };

  // Setup: the samples, their valid count, the zero leaves past N, the start.
  int count = 0;
  for (int n0 = 0; n0 < N; n0 += kSolveThreads) {
    const int n = n0 + tid;
    bool valid = false;
    if (n < N) {
      const long long s = cam * N + n;
      valid = a.valid[s] != 0;
      wv[n] = valid ? 1.0f : 0.0f;
      zs[n] = a.z[s];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) colour[ch * Np + n] = Model::stage(a.colour[3 * s + ch]);
    }
    count += __syncthreads_count(valid);
  }
  for (int n = N + tid; n < Np; n += kSolveThreads) {
    for (int c = 0; c <= kP; ++c) rows[c * row + word(n)] = 0.0f;
    leaves[word(n)] = 0.0f;
  }
  if (tid < kP) {
    xs[tid] = Model::start(tid, a.x0[(a.x0_per_camera ? m : m % a.G) * kP + tid]);
  }
  // clamp_min(n_valid, 1.0); the count is exact in float.
  const float n_valid = fmaxf(static_cast<float>(count), 1.0f);
  __syncthreads();

  const auto sample = [&](int n, float (&c)[3]) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[ch] = colour[ch * Np + n];
  };
  // The normal equations at xs into A and b.
  const auto normal_equations = [&]() {
    float X[kP];
#pragma unroll
    for (int c = 0; c < kP; ++c) X[c] = xs[c];
    for (int n = tid; n < N; n += kSolveThreads) {
      float c3[3], J[kP];
      sample(n, c3);
      const float r = Model::residual(X, zs[n], c3, wv[n], J);
#pragma unroll
      for (int c = 0; c < kP; ++c) rows[c * row + word(n)] = J[c];
      rows[kP * row + word(n)] = r;
    }
    __syncthreads();
    normal_segments<float, K>(rows, row, shift, 1, [](int, int) { return 0.0f; }, seg, kP, S, K,
                              warp, lane);
    __syncthreads();
    normal_entries<float>(seg, kP, S, tid, A, b);
    __syncthreads();
  };
  // The error at X (shared), in warp 0: the leaves' tree over max(n_valid, 1).
  const auto error_at = [&](const float* Xs) -> float {
    float X[kP];
#pragma unroll
    for (int c = 0; c < kP; ++c) X[c] = Xs[c];
    for (int n = tid; n < N; n += kSolveThreads) {
      float c3[3];
      sample(n, c3);
      leaves[word(n)] = Model::error(X, zs[n], c3, wv[n]);
    }
    __syncthreads();
    if (warp != 0) return 0.0f;
    float s = 0.0f;
    if (lane < S) s = lane_tree<float, K>([&](int k) { return leaves[lane * (K + 1) + k]; });
    return __fdiv_rn(segment_tree(s, S), n_valid);
  };

  normal_equations();
  float x = 0.0f, lam = 0.0f;
  int n_acc = 0;
  if (warp == 0) {
    // amax over the diagonal, a NaN winning, times lambda0_scale.
    float top = A[0][0];
#pragma unroll
    for (int c = 1; c < kP; ++c) top = (isnan(top) || top > A[c][c]) ? top : A[c][c];
    lam = __fmul_rn(top, a.lambda0_scale);
    x = lane < kP ? xs[lane] : 0.0f;
  }
  float err = error_at(xs);

  for (int it = 0; it < a.max_iters; ++it) {
    if (it > 0 && accepted) normal_equations();
    if (warp == 0) {
      damped_solve<kP>(A, b, lam, lane, kP, a.marquardt, delta);
      __syncwarp();
      float d = lane < kP ? delta[lane] : 0.0f;
      if (!__all_sync(kFull, lane >= kP || isfinite(d))) d = 0.0f;
      if (lane < kP) x_new[lane] = Model::project(lane, __fadd_rn(x, __fmul_rn(d, a.step_size)));
    }
    __syncthreads();
    const float err_new = error_at(x_new);
    if (warp == 0) {
      const bool better = err_new < err;
      if (better) {
        if (lane < kP) {
          x = x_new[lane];
          xs[lane] = x;
        }
        err = err_new;
      }
      lam = better ? __fmul_rn(lam, a.lambda_down_inv) : __fmul_rn(lam, a.lambda_up);
      lam = isnan(lam) ? lam : fminf(fmaxf(lam, a.min_lambda), a.max_lambda);
      n_acc += better;
      if (lane == 0) accepted = better;
    }
    __syncthreads();
  }

  if (warp == 0) {
    if (lane < kP) a.x[m * kP + lane] = x;
    if (lane == 0) {
      a.error[m] = err;
      a.lambda[m] = lam;
      a.n_accepted[m] = n_acc;
    }
  }
}

template <class Model>
int launch(const FitArgs& a, int fits, cudaStream_t stream) {
  const Layout lay(a.N);
  const size_t bytes = sizeof(float) * fit_shared_words(lay);
  return dispatch(lay.K, [&](auto k) {
    constexpr int K = decltype(k)::value;
    if constexpr (K == 0) {
      return (int)cudaErrorInvalidValue;
    } else {
      const auto kernel = sea_thru_fit_kernel<K, Model>;
      if (bytes > (size_t)kSharedLimit) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
      }
      kernel<<<fits, kSolveThreads, bytes, stream>>>(a);
      return (int)cudaGetLastError();
    }
  });
}

}  // namespace

// model 0: backscatter, 1: attenuation. N in [1, 2048] (K <= 64).
extern "C" int opt_sea_thru_fit(int model, const void* colour, const void* z, const void* valid,
                                const void* x0, void* x, void* error, void* lambda,
                                void* n_accepted, int cameras, int G, int N, int x0_per_camera,
                                int max_iters, int marquardt, float lambda0_scale, float lambda_up,
                                float lambda_down_inv, float step_size, float min_lambda,
                                float max_lambda, void* stream) {
  if (model < 0 || model > 1 || cameras < 0 || G < 1 || N < 1 || N > 2048 || max_iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (cameras == 0) return 0;
  const FitArgs a{(const float*)colour, (const float*)z, (const unsigned char*)valid,
                  (const float*)x0, (float*)x, (float*)error, (float*)lambda, (int*)n_accepted,
                  N, G, x0_per_camera, max_iters, marquardt, lambda0_scale, lambda_up,
                  lambda_down_inv, step_size, min_lambda, max_lambda};
  const cudaStream_t s = (cudaStream_t)stream;
  return model == 0 ? launch<Backscatter>(a, cameras * G, s)
                    : launch<Attenuation>(a, cameras * G, s);
}
