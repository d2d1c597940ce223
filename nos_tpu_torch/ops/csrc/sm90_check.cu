// A card check of sm90.cuh's forms in isolation, for the tests
// (tests/test_torch_cuda.py); no model path launches it. One warpgroup:
//   D1 = A B^T        the SS m64n64k16 form, A and B [64 x 128] bf16
//                     K-major, loaded by TMA in two 64-column boxes;
//   D2 = bf16(D1) B   the RS m64n128k16 transpose-B form reading the same
//                     B tile MN-major: a 64-row tile, so its 64-column
//                     boxes are 64 * 128 bytes apart (the LBO);
//   X  = x[off : off + 64]  the 1-D f32 tensor map read as flash_bwd.cu
//                     reads a row of statistics that starts at any
//                     element: a box of 68 from the 16-byte aligned
//                     element at or below `off`, indexed from the shift;
//                     zeros past the end.
// The same layouts and descriptors as flash_bwd.cu's dK/dV products
// (S^T = K Q^T, then dV += P^T dO).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsm90_check.so sm90_check.cu

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int ROWS = 64;
constexpr int COLS = 128;
constexpr int TILE_BYTES = ROWS * COLS * 2;
constexpr int BOX_BYTES = ROWS * 128;  // one 64-column box of a 64-row tile
constexpr int X_BOX = ROWS + 4;
constexpr int SMEM_BYTES = 1024 + 2 * TILE_BYTES + X_BOX * 4 + 8;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(128, 1)
forms_kernel(const __grid_constant__ CUtensorMap tm_a,
             const __grid_constant__ CUtensorMap tm_b,
             const __grid_constant__ CUtensorMap tm_x, float* d1, float* d2,
             float* x_out, int x_off) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = smem_raw + ((1024u - (sm90::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* b_s = a_s + TILE_BYTES;
  float* x_s = reinterpret_cast<float*>(b_s + TILE_BYTES);
  uint64_t* bar = reinterpret_cast<uint64_t*>(x_s + X_BOX);
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(bar, 2 * TILE_BYTES + X_BOX * 4);
    for (int c = 0; c < COLS / 64; ++c) {
      sm90::tma_load_4d(a_s + c * BOX_BYTES, &tm_a, bar, c * 64, 0, 0, 0);
      sm90::tma_load_4d(b_s + c * BOX_BYTES, &tm_b, bar, c * 64, 0, 0, 0);
    }
    sm90::tma_load_1d(x_s, &tm_x, bar, x_off & ~3);
  }
  sm90::mbar_wait(bar, 0);

  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const uint32_t a_base = sm90::smem_addr(a_s);
  const uint32_t b_base = sm90::smem_addr(b_s);

  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  sm90::fence_regs(s);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < COLS / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    sm90::wgmma_ss_m64n64k16(s, sm90::make_desc_sw128(a_base + off, 16, 1024),
                             sm90::make_desc_sw128(b_base + off, 16, 1024), kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);

  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  sm90::fence_regs(o);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    sm90::wgmma_rs_m64n128k16_tb(
        o, pa[kk], sm90::make_desc_sw128(b_base + kk * 16 * 128, BOX_BYTES, 1024), 1);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      d1[row * 64 + 8 * j + 2 * t] = s[4 * j + 2 * r];
      d1[row * 64 + 8 * j + 2 * t + 1] = s[4 * j + 2 * r + 1];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      d2[row * COLS + 8 * j + 2 * t] = o[4 * j + 2 * r];
      d2[row * COLS + 8 * j + 2 * t + 1] = o[4 * j + 2 * r + 1];
    }
  }
  if (tid < ROWS) x_out[tid] = x_s[(x_off & 3) + tid];
}

}  // namespace

// a, b: [64, 128] bf16 contiguous, 16-byte aligned; x: n_x f32, 16-byte
// aligned; d1 [64, 64], d2 [64, 128], x_out [64] f32. Returns a cudaError_t.
extern "C" int nos_sm90_forms_check(const void* a, const void* b, const void* x,
                                    long long n_x, void* d1, void* d2, void* x_out,
                                    int x_off, void* stream) {
  CUtensorMap tm_a, tm_b, tm_x;
  if (!sm90::make_tmap_bf16_4d(&tm_a, a, COLS, 1, ROWS, 1, COLS, COLS, ROWS * COLS, ROWS) ||
      !sm90::make_tmap_bf16_4d(&tm_b, b, COLS, 1, ROWS, 1, COLS, COLS, ROWS * COLS, ROWS) ||
      !sm90::make_tmap_f32_1d(&tm_x, x, n_x, X_BOX)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      forms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  forms_kernel<<<1, 128, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tm_a, tm_b, tm_x, static_cast<float*>(d1), static_cast<float*>(d2),
      static_cast<float*>(x_out), x_off);
  return static_cast<int>(cudaGetLastError());
}
