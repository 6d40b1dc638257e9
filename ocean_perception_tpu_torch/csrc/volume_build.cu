// Cost-volume build straight into the two strip layouts, for Hopper (sm_90a).
//
// Replaces: ocean_perception_tpu/ops/pallas/volume_build.py::
// pallas_build_volumes (body _build_kernel). It computes the X-stencil cost
// of cost_volume.cu (the same e_term and stencil_sum, cost_terms.cuh, so
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
// Design: a block owns a 32x32 pixel tile and 16 disparities. For each d it
// stages the tile's e-terms with their one-pixel halo in shared memory
// (1.13 e-terms per output), sums the stencil with lanes along x and stores
// V_col (a warp writes 32 consecutive x), keeps the sums in a shared tile,
// then stores V_row with lanes along y (a warp writes 32 consecutive y).
// Both stores are coalesced; the images are re-read from L1/L2.

#include "cost_terms.cuh"

namespace {

constexpr int TILE = 32;  // pixels per tile side; one lane per pixel of a row
constexpr int ROWS = 8;   // warps per block
constexpr int DB = 16;    // disparities per block

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

template <typename T>
__global__ void __launch_bounds__(TILE * ROWS)
build_volumes_kernel(const float* __restrict__ iml, const float* __restrict__ imr,
                     const float* __restrict__ gl, const float* __restrict__ gr,
                     T* __restrict__ V_row, T* __restrict__ V_col, int H, int W, int D,
                     float alpha, float beta, int chunks_x, int chunk_x, int chunks_y,
                     int chunk_y) {
  __shared__ float e_s[TILE + 2][TILE + 3];  // e-terms of rows y0-1 .. y0+32
  __shared__ float c_s[TILE][TILE + 1];      // costs, [local y][local x]
  const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const int d_end = min((int)(blockIdx.z + 1) * DB, D);
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int d = blockIdx.z * DB; d < d_end; ++d) {
    // e-terms of the tile and its halo; edge-clamped pixels repeat the edge.
    for (int k = ty * TILE + tx; k < (TILE + 2) * (TILE + 2); k += TILE * ROWS) {
      const int r = k / (TILE + 2), c = k % (TILE + 2);
      const int y = clampi(y0 - 1 + r, 0, H - 1), x = clampi(x0 - 1 + c, 0, W - 1);
      e_s[r][c] = e_term(iml, imr, gl, gr, W, y, x, d, alpha, beta);
    }
    __syncthreads();
    // Stencil sums, lanes along x: V_col stores are contiguous.
    for (int k = 0; k < TILE / ROWS; ++k) {
      const int ly = ty + ROWS * k, y = y0 + ly, x = x0 + tx;
      const float v = stencil_sum(e_s[ly + 1][tx + 1], e_s[ly][tx], e_s[ly][tx + 2],
                                  e_s[ly + 2][tx], e_s[ly + 2][tx + 2]);
      c_s[ly][tx] = v;
      if (y < H && x < W) {
        const int i = y % chunk_y, c = y / chunk_y;
        store(V_col, ((long long)(i * chunks_y + c) * D + d) * W + x, v);
      }
    }
    __syncthreads();
    // Lanes along y: V_row stores are contiguous.
    for (int k = 0; k < TILE / ROWS; ++k) {
      const int lx = ty + ROWS * k, x = x0 + lx, y = y0 + tx;
      if (y < H && x < W) {
        const int i = x % chunk_x, c = x / chunk_x;
        store(V_row, ((long long)(i * chunks_x + c) * D + d) * H + y, c_s[tx][lx]);
      }
    }
    // The next d's e-terms overwrite e_s only after this d's sums were read
    // (the barrier above); its sums overwrite c_s only after its own barrier.
  }
}

}  // namespace

extern "C" int opt_build_volumes(const void* iml, const void* imr, const void* gl,
                                 const void* gr, void* V_row, void* V_col, int H, int W, int D,
                                 float alpha, float beta, int chunks_x, int chunks_y,
                                 int out_bf16, void* stream) {
  if ((long long)H * W * D == 0) return 0;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, (D + DB - 1) / DB);
  const dim3 block(TILE, ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  const int chunk_x = W / chunks_x, chunk_y = H / chunks_y;
  if (out_bf16) {
    build_volumes_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const float*)iml, (const float*)imr, (const float*)gl, (const float*)gr,
        (__nv_bfloat16*)V_row, (__nv_bfloat16*)V_col, H, W, D, alpha, beta, chunks_x, chunk_x,
        chunks_y, chunk_y);
  } else {
    build_volumes_kernel<float><<<grid, block, 0, s>>>(
        (const float*)iml, (const float*)imr, (const float*)gl, (const float*)gr,
        (float*)V_row, (float*)V_col, H, W, D, alpha, beta, chunks_x, chunk_x, chunks_y,
        chunk_y);
  }
  return (int)cudaGetLastError();
}
