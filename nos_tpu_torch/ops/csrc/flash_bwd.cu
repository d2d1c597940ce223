// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel, bf16 in, f32 accumulation.
//
// Replaces nos_tpu/ops/flash_attention.py:_dq_kernel and _dkv_kernel (both
// launched by _bwd_pallas, sharing the block math of _bwd_p_ds). Given the
// forward's row log-sum-exp `lse` and delta = rowsum(dO * O) (computed
// outside, as the reference's _delta is), each kernel recomputes the
// probabilities P = exp(Q K^T * scale - lse) tile by tile, with the causal
// and window masks at GLOBAL positions q_off + i / kv_off + j (so ring
// attention's per-block gradients run the same kernels), and a row whose
// lse is -inf (no visible key) contributes exactly zero. Then
//   dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dQ = dS K,    dK = dS^T Q,    dV = P^T dO,
// with P and dS rounded to bf16 before their second products and every
// sum kept in f32, as _bwd_p_ds does. GQA: query head h reads kv head
// h / group; the dK/dV kernel sums the group's query heads inside the
// block (one f32 accumulator per kv head), so each dK/dV element has one
// owner: no atomics, a deterministic result, and a single cast at the end,
// the reference's one rounding point (f32 group sum, then the cast).
//
// What bounds them on an H100: the tensor cores. Per visible (query, key)
// pair dQ does three products of depth head_dim (S, dP, dQ: 6 * hd
// operations) and dK/dV four (S, dP, dV, dK: 8 * hd); at training lengths
// that is hundreds of operations per byte of Q, K, V, dO, far above the
// 295 operations per byte where memory would bind.
//
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulation); P and dS never
// leave registers (an accumulator's register layout is the A operand of
// the next product, as in flash_fwd.cu); tiles outside the causal /
// window band are never loaded. dQ: one block of four warps per
// (64-row query tile, query head, batch), 16 rows a warp, streaming the
// 64-key K/V tiles of its band; Q and dO stay in shared memory and are
// read as fragments per tile (registers go to the dQ accumulator, S and
// dP). dK/dV: one block per (64-key tile, kv head, batch), 16 keys a
// warp, streaming every query head of the group and the 64-row Q/dO
// tiles of its band; it computes the TRANSPOSED scores S^T = K Q^T, so
// P^T and dS^T come out in the accumulator layout that the A operand of
// dV += P^T dO and dK += dS^T Q needs, and lse / delta (per column here)
// are staged in shared memory per Q tile. This is the simple first
// version: one stage, mma.sync, shared-memory operand gathers; wgmma, TMA
// and a pipelined ring of tiles are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_bwd.so flash_bwd.cu
// Bound from Python with ctypes (nos_tpu_torch/ops/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;       // query rows per tile
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

__device__ __forceinline__ void store_pair(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

// A fragment of columns [kk*16, kk*16 + 16) of the 16 rows starting at
// `rows` in a row-major shared tile of row length `ld`.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* rows, int ld,
                                       int kk, int g, int t) {
  const bf16* p = rows + kk * 16 + t * 2;
  a[0] = ld_pair(p + g * ld);
  a[1] = ld_pair(p + (g + 8) * ld);
  a[2] = ld_pair(p + g * ld + 8);
  a[3] = ld_pair(p + (g + 8) * ld + 8);
}

// acc[j] (16 x 8 each, j < 8) += A (16 x HD) . X^T, X a row-major shared
// tile [64][HD]: the "X as B, reduced along its rows' elements" pattern
// (S = Q K^T in the forward).
template <int HD>
__device__ __forceinline__ void mma_abt(float acc[8][4], const bf16* a_rows,
                                        const bf16* x, int g, int t) {
  constexpr int LD = HD + PAD;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    load_a(a, a_rows, LD, kk, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* xr = x + (j * 8 + g) * LD + kk * 16 + t * 2;
      mma_bf16_16816(acc[j], a, ld_pair(xr), ld_pair(xr + 8));
    }
  }
}

// acc[d] (16 x 8 each, d < HD/8) += A (16 x 64, held as the f32
// accumulator `p` and rounded to bf16 here) . X, X a row-major shared
// tile [64][HD] reduced along its rows (O += P V in the forward).
template <int HD>
__device__ __forceinline__ void mma_pb(float acc[HD / 8][4], const float p[8][4],
                                       const bf16* x, int g, int t) {
  constexpr int LD = HD + PAD;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_f32(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_f32(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const bf16* xr = x + (kk * 16 + t * 2) * LD + g;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const bf16* q = xr + d * 8;
      mma_bf16_16816(acc[d], pa, pack_two(q, q + LD),
                     pack_two(q + 8 * LD, q + 9 * LD));
    }
  }
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

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal,
                                        int window) {
  if (!causal) return true;
  return kpos <= qpos && (window <= 0 || qpos - kpos < window);
}

// Element strides (batch, sequence, head) of one [B, S, H, HD] tensor.
struct Strides {
  long long b, s, h;
};

// ------------------------------------------------------------------- dQ

template <int HD, typename OutT>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dO,
                const float* __restrict__ lse, const float* __restrict__ delta,
                OutT* __restrict__ dq, int Sq, int Skv, int Hq, int group,
                Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
                int q_off, int kv_off, int causal, int window, float scale) {
  constexpr int LD = HD + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BM * LD;
  bf16* Ks = dOs + BM * LD;
  bf16* Vs = Ks + BN * LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;

  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  load_tile<HD>(Qs, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, BM, Sq - q0);
  load_tile<HD>(dOs, dO + b * dos.b + h * dos.h + q0 * dos.s, dos.s, BM,
                Sq - q0);

  // This thread's two rows: their global positions and row statistics.
  // A row past Sq takes lse = -inf, so it contributes nothing.
  const int row_a = warp * 16 + g;
  int qpos[2];
  float lse_r[2];
  float dlt_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_a + 8 * r;
    qpos[r] = q_off + row;
    const long long at = (static_cast<long long>(b) * Hq + h) * Sq + row;
    lse_r[r] = row < Sq ? lse[at] : -INFINITY;
    dlt_r[r] = row < Sq ? delta[at] : 0.f;
  }
  const bool live[2] = {lse_r[0] > -INFINITY, lse_r[1] > -INFINITY};

  // Key range [n_lo, n_hi) any row of this tile can see (as the forward).
  const int q_last = min(q0 + BM, Sq) - 1;
  int n_lo = 0;
  int n_hi = Skv;
  if (causal) {
    n_hi = min(Skv, q_off + q_last - kv_off + 1);
    if (window > 0) n_lo = max(0, q_off + q0 - window + 1 - kv_off);
  }
  n_lo = (n_lo / BN) * BN;

  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  }
  const bf16* q_rows = Qs + warp * 16 * LD;
  const bf16* do_rows = dOs + warp * 16 * LD;

  for (int n0 = n_lo; n0 < n_hi; n0 += BN) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<HD>(Ks, kb + n0 * ks.s, ks.s, BN, Skv - n0);
    load_tile<HD>(Vs, vb + n0 * vs.s, vs.s, BN, Skv - n0);
    __syncthreads();

    // P = exp(Q K^T * scale - lse), zero where masked or lse = -inf.
    float p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
    mma_abt<HD>(p, q_rows, Ks, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = n0 + j * 8 + t * 2 + (e & 1);
        const bool ok = live[r] && col < Skv &&
                        visible(qpos[r], kv_off + col, causal, window);
        p[j][e] = ok ? expf(p[j][e] * scale - lse_r[r]) : 0.f;
      }
    }

    // dP = dO V^T, then dS = P * (dP - delta) * scale in its place.
    float ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
    mma_abt<HD>(ds, do_rows, Vs, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[j][e] = p[j][e] * (ds[j][e] - dlt_r[e >> 1]) * scale;
      }
    }

    // dQ += dS K (dS rounded to bf16 as the A operand).
    mma_pb<HD>(acc, ds, Ks, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_a + 8 * r;
    if (row >= Sq) continue;
    OutT* orow = dq + b * dqs.b + row * dqs.s + h * dqs.h;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      store_pair(orow + d * 8 + t * 2, acc[d][2 * r], acc[d][2 * r + 1]);
    }
  }
}

// ----------------------------------------------------------------- dK/dV

template <int HD, typename OutT>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dO,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, OutT* __restrict__ dk,
                 OutT* __restrict__ dv, int Sq, int Skv, int Hq, int group,
                 Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
                 Strides dvs, int q_off, int kv_off, int causal, int window,
                 float scale) {
  constexpr int LD = HD + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BN * LD;
  bf16* Qs = Vs + BN * LD;
  bf16* dOs = Qs + BM * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + BM * LD);
  float* dlt_s = lse_s + BM;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;

  load_tile<HD>(Ks, k + b * ks.b + hk * ks.h + n0 * ks.s, ks.s, BN, Skv - n0);
  load_tile<HD>(Vs, v + b * vs.b + hk * vs.h + n0 * vs.s, vs.s, BN, Skv - n0);

  // This thread's two keys (rows of S^T): positions and validity.
  const int key_a = n0 + warp * 16 + g;
  int kpos[2];
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kpos[r] = kv_off + key_a + 8 * r;
    key_ok[r] = key_a + 8 * r < Skv;
  }

  // Query rows [m_lo, m_hi) that can see some key of this tile: from the
  // causal frontier of the tile's first key to the window edge of its
  // last (tile-aligned at the low end).
  int m_lo = 0;
  int m_hi = Sq;
  if (causal) {
    m_lo = max(0, kv_off + n0 - q_off);
    if (window > 0) {
      const int k_last = min(n0 + BN, Skv) - 1;
      m_hi = min(Sq, kv_off + k_last + window - q_off);
    }
  }
  m_lo = (m_lo / BM) * BM;

  float dk_acc[HD / 8][4];
  float dv_acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    dk_acc[d][0] = dk_acc[d][1] = dk_acc[d][2] = dk_acc[d][3] = 0.f;
    dv_acc[d][0] = dv_acc[d][1] = dv_acc[d][2] = dv_acc[d][3] = 0.f;
  }
  const bf16* k_rows = Ks + warp * 16 * LD;
  const bf16* v_rows = Vs + warp * 16 * LD;

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* dob = dO + b * dos.b + h * dos.h;
    const long long stat0 = (static_cast<long long>(b) * Hq + h) * Sq;
    for (int m0 = m_lo; m0 < m_hi; m0 += BM) {
      __syncthreads();  // the previous Q / dO tile is no longer read
      load_tile<HD>(Qs, qb + m0 * qs.s, qs.s, BM, Sq - m0);
      load_tile<HD>(dOs, dob + m0 * dos.s, dos.s, BM, Sq - m0);
      for (int i = threadIdx.x; i < BM; i += THREADS) {
        const int row = m0 + i;
        lse_s[i] = row < Sq ? lse[stat0 + row] : -INFINITY;
        dlt_s[i] = row < Sq ? delta[stat0 + row] : 0.f;
      }
      __syncthreads();

      // P^T = exp(K Q^T * scale - lse[col]), zero where masked, where
      // the key is past Skv, or where the row's lse is -inf.
      float p[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
      mma_abt<HD>(p, k_rows, Qs, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = j * 8 + t * 2 + (e & 1);
          const float l = lse_s[col];
          const bool ok = key_ok[r] && l > -INFINITY &&
                          visible(q_off + m0 + col, kpos[r], causal, window);
          p[j][e] = ok ? expf(p[j][e] * scale - l) : 0.f;
        }
      }

      // dV += P^T dO
      mma_pb<HD>(dv_acc, p, dOs, g, t);

      // dP^T = V dO^T, then dS^T = P^T * (dP^T - delta[col]) * scale.
      float ds[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
      mma_abt<HD>(ds, v_rows, dOs, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + t * 2 + (e & 1);
          ds[j][e] = p[j][e] * (ds[j][e] - dlt_s[col]) * scale;
        }
      }

      // dK += dS^T Q
      mma_pb<HD>(dk_acc, ds, Qs, g, t);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!key_ok[r]) continue;
    const int key = key_a + 8 * r;
    OutT* krow = dk + b * dks.b + key * dks.s + hk * dks.h;
    OutT* vrow = dv + b * dvs.b + key * dvs.s + hk * dvs.h;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      store_pair(krow + d * 8 + t * 2, dk_acc[d][2 * r], dk_acc[d][2 * r + 1]);
      store_pair(vrow + d * 8 + t * 2, dv_acc[d][2 * r], dv_acc[d][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------ launchers

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <int HD, typename OutT>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dO, const void* lse, const void* delta,
                      void* dq, int B, int Sq, int Skv, int Hq, int group,
                      const long long* st, int q_off, int kv_off, int causal,
                      int window, float scale, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(2 * BM + 2 * BN) * (HD + PAD) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<HD, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BM - 1) / BM, Hq, B);
  flash_dq_kernel<HD, OutT><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<OutT*>(dq), Sq, Skv, Hq, group, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), q_off, kv_off, causal, window, scale);
  return cudaGetLastError();
}

template <int HD, typename OutT>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dO, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int Sq, int Skv, int Hq,
                       int Hkv, const long long* st, int q_off, int kv_off,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(2 * BM + 2 * BN) * (HD + PAD) * sizeof(bf16) +
      2 * BM * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<HD, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Skv + BN - 1) / BN, Hkv, B);
  flash_dkv_kernel<HD, OutT><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<OutT*>(dk), static_cast<OutT*>(dv), Sq, Skv, Hq, Hq / Hkv,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), q_off, kv_off,
      causal, window, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Skv, int Hq, int Hkv) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0;
}

}  // namespace

// Shared contract of both launchers. q, dO [B, Sq, Hq, HD] and k, v
// [B, Skv, Hkv, HD] bf16 with unit stride on the last dim and 16-byte
// aligned rows; lse, delta [B, Hq, Sq] f32 contiguous; outputs in f32
// when out_f32 != 0, else bf16, with unit stride on the last dim.
// `strides` holds (b, s, h) element strides, in argument order: q, k, v,
// dO, then the outputs. window <= 0 means no window. Each returns a
// cudaError_t.

// dq [B, Sq, Hq, HD]; strides of q, k, v, dO, dq (15 values).
extern "C" int nos_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dO, const void* lse,
                                const void* delta, void* dq, int B, int Sq,
                                int Skv, int Hq, int Hkv, int head_dim,
                                const long long* strides, int q_off,
                                int kv_off, int causal, int window,
                                float scale, int out_f32, void* stream) {
  if (bad_shape(B, Sq, Skv, Hq, Hkv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NOS_DQ(HD, T)                                                        \
  launch_dq<HD, T>(q, k, v, dO, lse, delta, dq, B, Sq, Skv, Hq, group,       \
                   strides, q_off, kv_off, causal, window, scale, s)
  switch (head_dim) {
    case 64:
      return static_cast<int>(out_f32 ? NOS_DQ(64, float) : NOS_DQ(64, bf16));
    case 128:
      return static_cast<int>(out_f32 ? NOS_DQ(128, float) : NOS_DQ(128, bf16));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NOS_DQ
}

// dk, dv [B, Skv, Hkv, HD]; strides of q, k, v, dO, dk, dv (18 values).
extern "C" int nos_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dO, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int B, int Sq, int Skv, int Hq, int Hkv,
                                 int head_dim, const long long* strides,
                                 int q_off, int kv_off, int causal,
                                 int window, float scale, int out_f32,
                                 void* stream) {
  if (bad_shape(B, Sq, Skv, Hq, Hkv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NOS_DKV(HD, T)                                                       \
  launch_dkv<HD, T>(q, k, v, dO, lse, delta, dk, dv, B, Sq, Skv, Hq, Hkv,    \
                    strides, q_off, kv_off, causal, window, scale, s)
  switch (head_dim) {
    case 64:
      return static_cast<int>(out_f32 ? NOS_DKV(64, float) : NOS_DKV(64, bf16));
    case 128:
      return static_cast<int>(out_f32 ? NOS_DKV(128, float)
                                      : NOS_DKV(128, bf16));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NOS_DKV
}
