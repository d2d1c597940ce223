// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces nos_tpu/ops/flash_attention.py:_fwd_kernel (launched there by
// _fwd_pallas). Same function: O = softmax(Q K^T / sqrt(hd)) V per
// (batch, query head), with GQA (query head h reads kv head h / group,
// K/V never expanded), a causal mask and an optional sliding window
// (q - k < window) applied at GLOBAL positions q_off + i / kv_off + j, so
// the block-partials entry point uses the same kernel; the row
// log-sum-exp is returned beside O, and a row with no visible key gives
// O = 0 and LSE = -inf.
//
// What bounds it on an H100: at prefill lengths it is compute-bound.
// Causal attention does about 2 * B * Hq * S^2 * hd multiply-adds-as-two
// operations (QK^T and PV, half the square each), against 989 TFLOP/s of
// dense bf16 tensor-core peak; the bytes (Q, K, V, O once each) are a few
// MB, far below the 295 operations per byte where memory would bind.
//
// What the design does about it: both products run on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulation), the S x S score
// matrix never leaves registers, and key tiles that the causal / window
// band cannot reach are never loaded or multiplied (the kv loop is
// bounded per query tile). It is the simple first version: one block of
// four warps per (query tile of 64 rows, head, batch), each warp owning
// 16 query rows; K/V tiles of 64 keys are staged through shared memory
// with plain 16-byte loads, one tile at a time. wgmma, TMA and a
// multi-stage pipeline are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu
// Bound from Python with ctypes (nos_tpu_torch/ops/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;       // query rows per block (16 per warp)
constexpr int BN = 64;       // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;       // bf16 of row padding: conflict-free fragment loads

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_two(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `rows` rows of HD bf16 (row stride `ld_src` elements) into shared
// memory rows of HD + PAD, zero-filling rows at or past `valid`.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ld_src, int rows,
                                          int valid) {
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      val = *reinterpret_cast<const uint4*>(src + r * ld_src + c);
    }
    *reinterpret_cast<uint4*>(dst + r * (HD + PAD) + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int Hq, int group,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh,
                 int q_off, int kv_off, int causal, int window, float scale) {
  constexpr int LD = HD + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BM * LD;
  bf16* Vs = Ks + BN * LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;

  load_tile<HD>(Qs, qb + q0 * q_ss, q_ss, BM, Sq - q0);
  __syncthreads();

  // This warp's 16 query rows as mma A fragments, kept in registers.
  uint32_t qf[HD / 16][4];
  {
    const bf16* base = Qs + (warp * 16) * LD;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qf[kk][0] = ld_pair(base + g * LD + kk * 16 + t * 2);
      qf[kk][1] = ld_pair(base + (g + 8) * LD + kk * 16 + t * 2);
      qf[kk][2] = ld_pair(base + g * LD + kk * 16 + t * 2 + 8);
      qf[kk][3] = ld_pair(base + (g + 8) * LD + kk * 16 + t * 2 + 8);
    }
  }

  // Key range [n_lo, n_hi) any row of this tile can see: the causal
  // frontier of its last real row and the window edge of its first.
  const int row_a = warp * 16 + g;  // tile-local rows owned by this thread
  const int row_b = row_a + 8;
  const int q_last = min(q0 + BM, Sq) - 1;
  int n_lo = 0;
  int n_hi = Skv;
  if (causal) {
    n_hi = min(Skv, q_off + q_last - kv_off + 1);
    if (window > 0) n_lo = max(0, q_off + q0 - window + 1 - kv_off);
  }
  n_lo = (n_lo / BN) * BN;

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  }
  const int qpos_a = q_off + q0 + row_a;
  const int qpos_b = q_off + q0 + row_b;

  for (int n0 = n_lo; n0 < n_hi; n0 += BN) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<HD>(Ks, kb + n0 * k_ss, k_ss, BN, Skv - n0);
    load_tile<HD>(Vs, vb + n0 * v_ss, v_ss, BN, Skv - n0);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n8 tiles.
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* krow = Ks + (j * 8 + g) * LD + t * 2;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        mma_bf16_16816(s[j], qf[kk], ld_pair(krow + kk * 16),
                       ld_pair(krow + kk * 16 + 8));
      }
    }

    // Scale, mask (ragged edge, causal, window), row max.
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + t * 2 + (e & 1);
        const int qpos = (e < 2) ? qpos_a : qpos_b;
        const int kpos = kv_off + col;
        bool ok = col < Skv;
        if (causal) {
          ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && (qpos - kpos) < window;
        }
        const float x = ok ? s[j][e] * scale : -INFINITY;
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float corr[2];
    float safe_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m_run[r], mt[r]);
      safe_m[r] = (m_new == -INFINITY) ? 0.f : m_new;
      corr[r] = (m_run[r] == -INFINITY) ? 0.f : expf(m_run[r] - safe_m[r]);
      m_run[r] = m_new;
    }

    // P = exp(S - m), row sums in f32; P rounds to bf16 only for PV.
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - safe_m[e >> 1]);
        s[j][e] = p;
        ls[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
      l_run[r] = l_run[r] * corr[r] + ls[r];
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      acc[d][0] *= corr[0];
      acc[d][1] *= corr[0];
      acc[d][2] *= corr[1];
      acc[d][3] *= corr[1];
    }

    // O += P V: the S accumulator layout is the A fragment layout.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vrow = Vs + (kk * 16 + t * 2) * LD + g;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const bf16* p = vrow + d * 8;
        mma_bf16_16816(acc[d], pa, pack_two(p, p + LD),
                       pack_two(p + 8 * LD, p + 9 * LD));
      }
    }
  }

  // Normalise and store; rows with no visible key: O = 0, LSE = -inf.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + (r == 0 ? row_a : row_b);
    if (row >= Sq) continue;
    const bool has_mass = l_run[r] > 0.f;
    const float l = has_mass ? l_run[r] : 1.f;
    bf16* orow = o + b * o_sb + row * o_ss + h * o_sh;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const float x0 = has_mass ? acc[d][2 * r] / l : 0.f;
      const float x1 = has_mass ? acc[d][2 * r + 1] / l : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + t * 2) =
          __floats2bfloat162_rn(x0, x1);
    }
    if (t == 0) {
      lse[(static_cast<long long>(b) * Hq + h) * Sq + row] =
          has_mass ? m_run[r] + logf(l) : -INFINITY;
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Skv, int Hq, int group,
                   const long long* st, int q_off, int kv_off, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(BM + 2 * BN) * (HD + PAD) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BM - 1) / BM, Hq, B);
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Sq, Skv, Hq, group, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], q_off,
      kv_off, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, Sq, Hq, HD], k/v [B, Skv, Hkv, HD] bf16 with unit stride on the
// last dim and 16-byte aligned rows; o like q; lse [B, Hq, Sq] f32
// contiguous. `strides` holds (b, s, h) element strides of q, k, v, o in
// that order. window <= 0 means no window. Returns a cudaError_t.
extern "C" int nos_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int Sq, int Skv,
                                  int Hq, int Hkv, int head_dim,
                                  const long long* strides, int q_off,
                                  int kv_off, int causal, int window,
                                  float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, o, lse, B, Sq, Skv, Hq,
                                         group, strides, q_off, kv_off,
                                         causal, window, scale, s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, o, lse, B, Sq, Skv, Hq,
                                          group, strides, q_off, kv_off,
                                          causal, window, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
