// Cost-volume build straight into the two strip layouts, for Hopper (sm_90a).
//
// Replaces: ocean_perception_tpu/ops/pallas/volume_build.py::
// pallas_build_volumes (body _build_kernel). It computes the X-stencil cost
// of cost_volume.cu (the same shared stage and arithmetic, cost_terms.cuh, so
// every value equals cost_volume's bit for bit, in bf16 and in float32) and
// writes it in the layouts the strip-volume PatchMatch reads:
//   V_row[i, c, d, h] = C[h, c*chunk_x + i, d]   (chunk_x, chunks_x, D, H)
//   V_col[i, c, d, w] = C[c*chunk_y + i, w, d]   (chunk_y, chunks_y, D, W)
// The TPU kernel's shears by rolls, d-bit masks, reversed transposes and
// 8-row aligned groups were Mosaic workarounds; none is needed here.
//
// Bound: bytes. The four (H, W) float32 inputs are read once (3.7 MB at
// 360x640) and the two layouts written once (2 x 29.5 MB in bf16 at
// 360x640x64): 62.7 MB, about 18.7 us at 3.35 TB/s.
// Design: a block owns a tile of kTY x kTX pixels and kDZ disparities. It
// stages the tile's image rows with their halo once (CostTile), then for
// each group of kDG disparities computes the e-terms of the tile and its
// halo once into shared memory (1.2 e-terms per output at 16 x 32), sums the
// stencils from there into a shared tile of costs, and stores both layouts
// from that tile as 16-byte vectors: a thread writes 8 consecutive x of a
// V_col row, and 8 consecutive y of a V_row row (the tile read down a
// column, which transposes it). Rows whose length breaks 16-byte alignment
// (W or H not a multiple of 8) take scalar stores. A batch of B stereo
// pairs is one launch: (B, H, W) images and both layouts with a leading B,
// the camera beside the disparity blocks in gridDim.z. A one-camera launch
// takes the kernel built without the camera (kBatch false): the camera's
// decode and pointer offsets cost the batched build 3% of its device time
// in bf16 and 17% in float32 at one camera, in turns on an H100 (PERF.md).

#include "cost_terms.cuh"

namespace {

constexpr int kTY = 16;  // pixel rows a tile: two V_row vectors a column
constexpr int kTX = 32;  // pixel columns a tile: four V_col vectors a row
constexpr int kDG = 8;   // disparities a stage
constexpr int kDZ = 16;  // disparities a block
constexpr int kRows = kTY + 2, kCols = kTX + 2;
// Floats between two rows of the cost tile: 36 = 4 mod 32, so the 8 lanes
// of a quarter-warp (2 rows x 4 chunks of 8 x) read 8 disjoint bank
// quadruples with their 16-byte loads.
constexpr int kCP = kTX + 4;
constexpr int kThreads = 256, kWarps = kThreads / 32;
static_assert(kTX == 32, "a lane per tile column");

constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kDG * kRows * kCols + kDG * kTY * kCP +
                          2 * kRows * kCols + 2 * kRows * (kTX + kDZ + 1));
}

template <typename T, bool kBatch>
__global__ void __launch_bounds__(kThreads)
build_volumes_kernel(const float* __restrict__ iml, const float* __restrict__ imr,
                     const float* __restrict__ gl, const float* __restrict__ gr,
                     T* __restrict__ V_row, T* __restrict__ V_col, int H, int W, int D,
                     float alpha, float beta, int chunks_x, int chunk_x, int chunks_y,
                     int chunk_y, int vec_row, int vec_col) {
  extern __shared__ __align__(16) float smem[];
  float* e_s = smem;                       // [kDG][kRows][kCols] e-terms, x fastest
  float* c_s = e_s + kDG * kRows * kCols;  // [kDG][kTY][kCP] costs, x fastest
  float* img = c_s + kDG * kTY * kCP;      // the CostTile images
  const int d_blocks = (D + kDZ - 1) / kDZ, cam = kBatch ? blockIdx.z / d_blocks : 0;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int dz_lo = (kBatch ? blockIdx.z % d_blocks : blockIdx.z) * kDZ;
  const int dz_hi = min(dz_lo + kDZ, D);
  if (kBatch) {  // this camera's images and layouts
    const long long pixels = (long long)H * W;
    iml += cam * pixels;
    imr += cam * pixels;
    gl += cam * pixels;
    gr += cam * pixels;
    V_row += cam * pixels * D;
    V_col += cam * pixels * D;
  }
  // Strip rows of the tile's pixels: (i * chunks + c) of V_col for each y,
  // of V_row for each x.
  __shared__ int col_strip_row[kTY], row_strip_row[kTX];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  CostTile t;
  t.stage(img, iml, imr, gl, gr, H, W, y0, x0, kTY, kTX, dz_lo, dz_hi);
  if (tid < kTY) {
    const int y = y0 + tid;
    col_strip_row[tid] = (y % chunk_y) * chunks_y + y / chunk_y;
  } else if (tid < kTY + kTX) {
    const int x = x0 + tid - kTY;
    row_strip_row[tid - kTY] = (x % chunk_x) * chunks_x + x / chunk_x;
  }
  __syncthreads();
  const int r_lane = t.r_index(0, lane);  // R(y, x) of staged column `lane`, row 0

  for (int d_lo = dz_lo; d_lo < dz_hi; d_lo += kDG) {
    const int dn = min(kDG, dz_hi - d_lo);
    // e-terms of the tile and its halo: a warp per staged row and
    // disparity, lanes along x, then the two halo columns right of the
    // tile. The last group's sums have read e_s: its stores follow the
    // barrier after them.
    for (int row = warp; row < dn * kRows; row += kWarps) {
      const int dd = row / kRows, rr = row - dd * kRows;
      const int i = rr * kCols + lane, k = rr * t.rw + r_lane - (d_lo + dd);
      e_s[row * kCols + lane] = e_value(t.l[i], t.r[k], t.gl[i], t.gr[k], alpha, beta);
    }
    for (int k = tid; k < dn * kRows * 2; k += kThreads) {
      const int row = k >> 1, c = kTX + (k & 1);
      const int dd = row / kRows, rr = row - dd * kRows;
      e_s[row * kCols + c] = t.e(rr, c, d_lo + dd, alpha, beta);
    }
    __syncthreads();
    // Stencil sums into the cost tile; the last group's stores have read it
    // (they precede the barrier above).
    for (int k = tid; k < dn * kTY * kTX; k += kThreads) {
      const int row = k / kTX, lx = k - row * kTX;
      const int dd = row / kTY, ly = row - dd * kTY;
      const float* e = e_s + (dd * kRows + ly) * kCols + lx;
      c_s[row * kCP + lx] = stencil_sum(e[kCols + 1], e[0], e[2], e[2 * kCols], e[2 * kCols + 2]);
    }
    __syncthreads();
    // V_col: a thread writes 8 consecutive x of the row (y, d).
    for (int k = tid; k < dn * kTY * (kTX / 8); k += kThreads) {
      const int row = k / (kTX / 8), x = x0 + 8 * (k - row * (kTX / 8));
      const int dd = row / kTY, y = y0 + row - dd * kTY;
      if (y >= H || x >= W) continue;
      T* o = V_col + ((long long)col_strip_row[y - y0] * D + d_lo + dd) * W + x;
      const float* s = c_s + row * kCP + (x - x0);
      if (vec_col) {
        float v[8];
        *reinterpret_cast<float4*>(v) = reinterpret_cast<const float4*>(s)[0];
        *reinterpret_cast<float4*>(v + 4) = reinterpret_cast<const float4*>(s)[1];
        store8(o, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (x + j < W) store(o, j, s[j]);
      }
    }
    // V_row: a thread writes 8 consecutive y of the row (x, d), read down a
    // column of the cost tile (lanes along x: conflict-free).
    for (int k = tid; k < dn * kTX * (kTY / 8); k += kThreads) {
      const int row = k / kTX, lx = k - row * kTX;
      const int dd = row / (kTY / 8), h = row - dd * (kTY / 8);
      const int x = x0 + lx, y = y0 + 8 * h;
      if (y >= H || x >= W) continue;
      T* o = V_row + ((long long)row_strip_row[lx] * D + d_lo + dd) * H + y;
      const float* s = c_s + (dd * kTY + 8 * h) * kCP + lx;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = s[j * kCP];
      if (vec_row) {
        store8(o, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (y + j < H) store(o, j, v[j]);
      }
    }
  }
}

template <typename T>
int launch(const void* iml, const void* imr, const void* gl, const void* gr, void* V_row,
           void* V_col, int B, int H, int W, int D, float alpha, float beta, int chunks_x,
           int chunks_y, cudaStream_t s) {
  static bool shared_set[2][64] = {};
  const auto kernel = B > 1 ? build_volumes_kernel<T, true> : build_volumes_kernel<T, false>;
  const cudaError_t attr = allow_shared(kernel, (int)smem_bytes(), shared_set[B > 1]);
  if (attr != cudaSuccess) return (int)attr;
  // A row of either layout takes 16-byte stores when its length is a
  // multiple of 8 elements and the layout starts 16-byte aligned (so then
  // does each camera's).
  const int vec_row = H % 8 == 0 && reinterpret_cast<uintptr_t>(V_row) % 16 == 0;
  const int vec_col = W % 8 == 0 && reinterpret_cast<uintptr_t>(V_col) % 16 == 0;
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, B * ((D + kDZ - 1) / kDZ));
  kernel<<<grid, kThreads, smem_bytes(), s>>>(
      (const float*)iml, (const float*)imr, (const float*)gl, (const float*)gr, (T*)V_row,
      (T*)V_col, H, W, D, alpha, beta, chunks_x, W / chunks_x, chunks_y, H / chunks_y, vec_row,
      vec_col);
  return (int)cudaGetLastError();
}

}  // namespace

// B stereo pairs, (B, H, W) float32 images, into V_row (B, W / chunks_x,
// chunks_x, D, H) and V_col (B, H / chunks_y, chunks_y, D, W).
extern "C" int opt_build_volumes(const void* iml, const void* imr, const void* gl,
                                 const void* gr, void* V_row, void* V_col, int B, int H, int W,
                                 int D, float alpha, float beta, int chunks_x, int chunks_y,
                                 int out_bf16, void* stream) {
  if ((long long)B * H * W * D == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return out_bf16 ? launch<__nv_bfloat16>(iml, imr, gl, gr, V_row, V_col, B, H, W, D, alpha,
                                          beta, chunks_x, chunks_y, s)
                  : launch<float>(iml, imr, gl, gr, V_row, V_col, B, H, W, D, alpha, beta,
                                  chunks_x, chunks_y, s);
}
