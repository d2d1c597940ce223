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
// What the design does about it (the building blocks are in sm90.cuh):
// - Both kernels are three warpgroups. Warpgroup 0 is the producer: it
//   gives up registers (setmaxnreg.dec) and one thread issues TMA loads
//   of the resident tiles and of a ring of streamed tiles, each stage
//   guarded by a full and an empty mbarrier; it runs up to the ring's
//   depth ahead. Warpgroups 1 and 2 are consumers (setmaxnreg.inc) of 64
//   rows each; both read every stage and release it (one arrival per
//   warp) once the products reading it have retired.
// - Every product is wgmma: the score-like products (S, dP) in the SS
//   form with both operands K-major in 128-byte-swizzled shared memory,
//   the gradient products (dQ, dK, dV) in the RS form: P or dS comes from
//   an accumulator in registers (its layout is the A fragment's), rounded
//   to bf16, and the streamed tile is read MN-major (transpose-B).
// - dK/dV: one block per (128 keys, kv head, batch); each consumer's 64
//   keys of K and V stay resident. The ring streams (query head of the
//   GQA group, 64-row query tile) pairs: the Q and dO tiles and their 64
//   lse and delta values (a 1-D f32 tensor map; a box must start 16-byte
//   aligned, so it starts at the aligned element at or below the tile's
//   first row and is 4 wider). The consumer computes the TRANSPOSED scores
//   S^T = K Q^T and dP^T = V dO^T (SS, N = 64), so P^T and dS^T come out
//   in the A-operand layout of dV += P^T dO and dK += dS^T Q, which read
//   the same swizzled dO and Q tiles MN-major; lse and delta are per
//   column there. Key tiles run in ascending order, heaviest first under
//   a causal mask.
// - dQ: one block per (128 query rows, query head, batch); Q and dO stay
//   resident, the ring streams K/V tiles of 128 keys. S = Q K^T and
//   dP = dO V^T (SS, N = 128), then dQ += dS K (RS, K read MN-major);
//   each thread keeps its two rows' lse and delta in registers. Causal
//   grids start the query tiles with the most visible keys first.
// - hd 256 (Gemma). dK/dV: a consumer cannot hold f32 dK and dV for its
//   64 keys (128 + 128 floats a thread, against 240 registers), so the
//   block owns 64 keys and splits the work by output: warpgroup 1
//   computes S^T, P^T and dV += P^T dO, warpgroup 2 dP^T, dS^T and
//   dK += dS^T Q, two products each per tile. P^T crosses in f32 (the
//   reference's dS uses the unrounded p) through a 16 KB shared buffer in
//   the accumulator's own register order, thread for thread, guarded by
//   two named barriers (ready, free). K and V take 64 KB, two 64-row
//   Q / dO stages 128 KB. dQ: Q and dO stay resident (128 KB), so the
//   ring streams 32-key K/V tiles, three stages (96 KB); S and dP are
//   m64n32k16, dQ += dS K one m64n256k16 per 16 keys. Every product
//   keeps its hd 64/128 operand layouts; outputs are single-owner.
// - exp2 with scale * log2(e) folded into one FMA per score; a -inf lse
//   becomes a -inf exponent bias, so its row contributes exact zeros.
// - Tiles outside the causal / window band are never loaded; a
//   consumer's 64-row slice that no visible pair reaches skips its
//   products; a slice wholly inside the band and below Sq / Skv takes no
//   mask arithmetic. TMA zero-fills rows past Sq and keys past Skv, and
//   the masks (or the -inf bias of a row past Sq) exclude them.
// - Outputs are written from registers once per block, bf16 or f32 (the
//   ring path's f32 per-block gradients).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_bwd.so flash_bwd.cu
// Bound from Python with ctypes (nos_tpu_torch/ops/flash_attention.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WG_ROWS = 64;  // rows a consumer warpgroup owns (the M of one wgmma)
constexpr int WG_THREADS = 128;
constexpr int THREADS = 3 * WG_THREADS;  // producer + two consumers
constexpr int CONSUMER_WARPS = 8;        // arrivals that release a stage
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 24 * 128 + 240 * 256 = 168 * 384
constexpr int CHUNK = 64;           // bf16 in a 128-byte swizzled row (one TMA box)
constexpr int ROW_BYTES = 128;
constexpr float LOG2E = 1.4426950408889634f;

// dK/dV: 64-row query tiles streamed past a block of keys: 128 keys, 64
// per consumer; at hd 256 64 keys, both consumers on all of them (one
// owns dV, the other dK).
constexpr int Q_TILE = 64;
constexpr int P_READY = 1;  // named barriers of the hd-256 P^T hand-over
constexpr int P_FREE = 2;

template <int HD>
struct DkvTiles {
  static constexpr bool SPLIT_ROLES = HD == 256;
  static constexpr int KV_BLOCK = SPLIT_ROLES ? 64 : 128;
  static constexpr int STAGES = SPLIT_ROLES ? 2 : 4;
  static constexpr int CHUNKS = HD / CHUNK;
  static constexpr int KV_BYTES = KV_BLOCK * HD * 2;  // K or V
  static constexpr int Q_BYTES = Q_TILE * HD * 2;     // a Q or dO tile
  // lse, then delta, per stage: a box of 68 from the 16-byte aligned
  // element at or below the tile's first row (sm90::make_tmap_f32_1d),
  // each in a slot of 96 (TMA writes to 128-byte aligned shared memory)
  static constexpr int STAT_BOX = Q_TILE + 4;
  static constexpr int STAT_SLOT = 96;
  static constexpr int STAT_FLOATS = 2 * STAT_SLOT;
  static constexpr int STAGE_TX = 2 * Q_BYTES + 2 * STAT_BOX * 4;
  // the P^T hand-over: a 64 x 64 f32 tile
  static constexpr int P_BYTES = SPLIT_ROLES ? Q_TILE * Q_TILE * 4 : 0;
  // 1024 bytes of slack to align the swizzle atoms, then the barriers
  static constexpr int SMEM_BYTES = 1024 + 2 * KV_BYTES + STAGES * 2 * Q_BYTES +
                                    STAGES * STAT_FLOATS * 4 + P_BYTES +
                                    (2 * STAGES + 1) * 8;
};

// dQ: 128 query rows per block (64 per consumer), K/V tiles streamed.
constexpr int DQ_ROWS = 128;

template <int HD>
struct DqTiles {
  static constexpr int BN = HD == 256 ? 32 : 128;  // keys per K/V tile
  static constexpr int STAGES = HD == 256 ? 3 : HD == 128 ? 2 : 4;
  static constexpr int CHUNKS = HD / CHUNK;
  static constexpr int Q_BYTES = DQ_ROWS * HD * 2;  // Q or dO
  static constexpr int KV_BYTES = BN * HD * 2;      // one K or one V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SMEM_BYTES =
      1024 + 2 * Q_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[k][i])::"memory");
  }
}

// The exponent bias of a row: -lse in log2 units, -inf for a row with no
// visible key (lse = -inf), so exp2(s * scale_log2 + bias) is exactly 0.
__device__ __forceinline__ float row_bias(float lse) {
  return lse == -INFINITY ? -INFINITY : -lse * LOG2E;
}

__device__ __forceinline__ void store_pair(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

// Element strides (batch, sequence, head) of one [B, S, H, HD] tensor.
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (sm90::smem_addr(p) & 1023u)) & 1023u);
}

// A consumer warp is done with a stage once its products have retired.
__device__ __forceinline__ void release(uint64_t* empty_bar, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(empty_bar);
}

// Issue D = A B^T over head_dim: A a 64-row slice of a tile whose 64-wide
// head_dim boxes are A_ROWS * 128 bytes apart, B an N-row tile (boxes
// N * 128 bytes apart), both K-major. hd / 16 k-steps of 32 bytes, four
// per box.
template <int HD, int N, int A_ROWS>
__device__ __forceinline__ void issue_abt(float (&d)[N / 2], uint32_t a_base,
                                          uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da = sm90::make_desc_sw128(
        a_base + (kk / 4) * A_ROWS * ROW_BYTES + (kk % 4) * 32, 16, 1024);
    const uint64_t db =
        sm90::make_desc_sw128(b_base + (kk / 4) * N * ROW_BYTES + (kk % 4) * 32, 16, 1024);
    if constexpr (N == 128) {
      sm90::wgmma_ss_m64n128k16(d, da, db, kk > 0);
    } else if constexpr (N == 64) {
      sm90::wgmma_ss_m64n64k16(d, da, db, kk > 0);
    } else {
      sm90::wgmma_ss_m64n32k16(d, da, db, kk > 0);
    }
  }
  sm90::wgmma_commit();
}

// Issue D += A X: A (64 x 16 * KSTEPS) as bf16 A fragments in registers,
// X an X_ROWS x HD tile read MN-major: 16 rows (2048 bytes) per k-step,
// its 64-wide head_dim boxes X_ROWS * 128 bytes apart.
template <int HD, int KSTEPS, int X_ROWS>
__device__ __forceinline__ void issue_ax(float (&d)[HD / 2], const uint32_t (&a)[KSTEPS][4],
                                         uint32_t x_base) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint64_t dx =
        sm90::make_desc_sw128(x_base + kk * 16 * ROW_BYTES, X_ROWS * ROW_BYTES, 1024);
    if constexpr (HD == 256) {
      sm90::wgmma_rs_m64n256k16_tb(d, a[kk], dx, 1);
    } else if constexpr (HD == 128) {
      sm90::wgmma_rs_m64n128k16_tb(d, a[kk], dx, 1);
    } else {
      sm90::wgmma_rs_m64n64k16_tb(d, a[kk], dx, 1);
    }
  }
  sm90::wgmma_commit();
}

// An N-column accumulator as A fragments: columns 16kk .. 16kk + 15 are
// the m16n8k16 A fragment of k-step kk, rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_a(const float (&s)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// ----------------------------------------------------------------- dK/dV

// The hd-256 consumers of one dK/dV block: both warpgroups on the same
// 64 keys, cw 0 owning dV (S^T, P^T, dV += P^T dO), cw 1 owning dK (dP^T,
// dS^T, dK += dS^T Q). cw 0 hands P^T over in f32 through p_s, element e
// of thread t at p_s[e * 128 + t] (conflict-free: a warp reads 32
// consecutive floats), on the named barriers P_READY (written) and P_FREE
// (read, so the next tile may overwrite it); cw 1 arrives on P_FREE once
// before the first tile and cw 0 syncs on it once after the last, so both
// barriers end with every phase complete. Both warpgroups see the same
// tiles as empty (`none` depends only on the keys and the tile), so they
// meet at every barrier.
template <int HD, typename OutT>
__device__ __forceinline__ void dkv_split_consumer(
    uint8_t* k_s, uint8_t* v_s, uint8_t* qd_s, const float* stat_s, float* p_s,
    uint64_t* full, uint64_t* empty, uint64_t* kv_full, OutT* __restrict__ dk,
    OutT* __restrict__ dv, Strides dks, Strides dvs, int n0, int m_lo, int n_m, int total,
    int b, int hk, int Sq, int Skv, int Hq, int group, int q_off, int kv_off, int causal,
    int window, float scale, float scale_log2, int cw) {
  using T = DkvTiles<HD>;
  constexpr int KV_BLOCK = T::KV_BLOCK;
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kr_a = warp * 16 + g;  // this thread's keys: n0 + kr_a and 8 below
  const int kmin = kv_off + n0;
  const int kmax = kv_off + min(n0 + KV_BLOCK, Skv) - 1;
  // cw 0 multiplies K (S^T = K Q^T), cw 1 V (dP^T = V dO^T)
  const uint32_t a_base = sm90::smem_addr(cw == 0 ? k_s : v_s);

  float acc[HD / 2];  // dV (cw 0) or dK (cw 1)
  zero(acc);
  if (cw == 1) sm90::named_barrier_arrive(P_FREE, 2 * WG_THREADS);
  if (total > 0) sm90::mbar_wait(kv_full, 0);

  int gi = 0;
  int mt = 0;
  for (int i = 0; i < total; ++i) {
    const int st = i % T::STAGES;
    const int m0 = m_lo + mt * Q_TILE;
    const int shift = ((b * Hq + hk * group + gi) * Sq) & 3;
    if (++mt == n_m) {
      mt = 0;
      ++gi;
    }
    sm90::mbar_wait(&full[st], (i / T::STAGES) & 1);
    const int qmin = q_off + m0;
    const int qmax = q_off + min(m0 + Q_TILE, Sq) - 1;
    const bool none =
        n0 >= Skv || (causal && (kmin > qmax || (window > 0 && qmin - kmax >= window)));
    if (!none) {
      const bool inside =
          m0 + Q_TILE <= Sq && n0 + KV_BLOCK <= Skv &&
          (!causal || (kv_off + n0 + KV_BLOCK - 1 <= qmin &&
                       (window <= 0 || qmin + Q_TILE - 1 - kmin < window)));
      const uint32_t q_addr = sm90::smem_addr(qd_s + st * 2 * T::Q_BYTES);
      const uint32_t do_addr = q_addr + T::Q_BYTES;
      const float* lse_s = stat_s + st * T::STAT_FLOATS + shift;
      const float* dlt_s = lse_s + T::STAT_SLOT;

      float s[Q_TILE / 2];  // cw 0: S^T, then P^T; cw 1: dP^T, then dS^T
      sm90::fence_regs(s);
      sm90::wgmma_fence();
      issue_abt<HD, Q_TILE, KV_BLOCK>(s, a_base, cw == 0 ? q_addr : do_addr);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      uint32_t a[Q_TILE / 16][4];
      if (cw == 0) {
        // P^T = 2^(S^T * scale * log2e - lse[col] * log2e)
#pragma unroll
        for (int j = 0; j < Q_TILE / 8; ++j) {
          const int c0 = 8 * j + 2 * t;
          const float bias[2] = {row_bias(lse_s[c0]), row_bias(lse_s[c0 + 1])};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = 4 * j + e;
            float p = fast_exp2(fmaf(s[idx], scale_log2, bias[e & 1]));
            if (!inside) {
              const int col = m0 + c0 + (e & 1);
              const int key = n0 + kr_a + ((e < 2) ? 0 : 8);
              const int qpos = q_off + col;
              const int kpos = kv_off + key;
              bool ok = col < Sq && key < Skv;
              if (causal) {
                ok = ok && kpos <= qpos;
                if (window > 0) ok = ok && qpos - kpos < window;
              }
              if (!ok) p = 0.f;
            }
            s[idx] = p;
          }
        }
        sm90::named_barrier_sync(P_FREE, 2 * WG_THREADS);
#pragma unroll
        for (int e = 0; e < Q_TILE / 2; ++e) p_s[e * WG_THREADS + tid] = s[e];
        sm90::named_barrier_arrive(P_READY, 2 * WG_THREADS);
      } else {
        // dS^T = P^T * (dP^T - delta[col]) * scale
        sm90::named_barrier_sync(P_READY, 2 * WG_THREADS);
#pragma unroll
        for (int j = 0; j < Q_TILE / 8; ++j) {
          const float d[2] = {dlt_s[8 * j + 2 * t], dlt_s[8 * j + 2 * t + 1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = 4 * j + e;
            s[idx] = p_s[idx * WG_THREADS + tid] * (s[idx] - d[e & 1]) * scale;
          }
        }
        sm90::named_barrier_arrive(P_FREE, 2 * WG_THREADS);
      }
      pack_a<Q_TILE>(s, a);
      fence_frags(a);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
      // dV += P^T dO (cw 0) or dK += dS^T Q (cw 1)
      issue_ax<HD, Q_TILE / 16, Q_TILE>(acc, a, cw == 0 ? do_addr : q_addr);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      fence_frags(a);
    }
    release(&empty[st], lane);
  }
  if (cw == 0) sm90::named_barrier_sync(P_FREE, 2 * WG_THREADS);

  OutT* out = cw == 0 ? dv : dk;
  const Strides os = cw == 0 ? dvs : dks;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = n0 + kr_a + 8 * r;
    if (key >= Skv) continue;
    OutT* orow = out + b * os.b + key * os.s + hk * os.h;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      store_pair(orow + 8 * j + 2 * t, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}


template <int HD, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_lse,
                 const __grid_constant__ CUtensorMap tm_dlt, OutT* __restrict__ dk,
                 OutT* __restrict__ dv, Strides dks, Strides dvs, int Sq, int Skv,
                 int Hq, int group, int q_off, int kv_off, int causal, int window,
                 float scale, float scale_log2) {
  using T = DkvTiles<HD>;
  constexpr int KV_BLOCK = T::KV_BLOCK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align_1024(smem_raw);
  uint8_t* v_s = k_s + T::KV_BYTES;
  uint8_t* qd_s = v_s + T::KV_BYTES;  // stage s: Q at s * 2 * Q_BYTES, dO after it
  float* stat_s = reinterpret_cast<float*>(qd_s + T::STAGES * 2 * T::Q_BYTES);
  float* p_s = stat_s + T::STAGES * T::STAT_FLOATS;  // hd 256: P^T, [e][thread]
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(p_s) + T::P_BYTES);
  uint64_t* empty = full + T::STAGES;
  uint64_t* kv_full = empty + T::STAGES;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int n0 = blockIdx.z * KV_BLOCK;

  // Query rows [m_lo, m_hi) that can see some key of this block: from the
  // causal frontier of its first key to the window edge of its last
  // (tile-aligned at the low end). The ring walks the GQA group's heads,
  // and each head's query tiles, in that order.
  int m_lo = 0;
  int m_hi = Sq;
  if (causal) {
    m_lo = max(0, kv_off + n0 - q_off);
    if (window > 0) {
      const int k_last = min(n0 + KV_BLOCK, Skv) - 1;
      m_hi = min(Sq, kv_off + k_last + window - q_off);
    }
  }
  m_lo = (m_lo / Q_TILE) * Q_TILE;
  const int n_m = m_hi > m_lo ? (m_hi - m_lo + Q_TILE - 1) / Q_TILE : 0;
  const int total = group * n_m;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    sm90::mbar_init(kv_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ------------------------------------------------------- producer
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && total > 0) {
      sm90::prefetch_tensormap(&tm_q);
      sm90::prefetch_tensormap(&tm_do);
      sm90::prefetch_tensormap(&tm_lse);
      sm90::prefetch_tensormap(&tm_dlt);
      sm90::mbar_arrive_expect_tx(kv_full, 2 * T::KV_BYTES);
#pragma unroll
      for (int c = 0; c < T::CHUNKS; ++c) {
        sm90::tma_load_4d(k_s + c * KV_BLOCK * ROW_BYTES, &tm_k, kv_full, c * CHUNK, hk,
                          n0, b);
        sm90::tma_load_4d(v_s + c * KV_BLOCK * ROW_BYTES, &tm_v, kv_full, c * CHUNK, hk,
                          n0, b);
      }
      int gi = 0;
      int mt = 0;
      for (int i = 0; i < total; ++i) {
        const int st = i % T::STAGES;
        if (i >= T::STAGES) sm90::mbar_wait(&empty[st], ((i / T::STAGES) - 1) & 1);
        const int h = hk * group + gi;
        const int m0 = m_lo + mt * Q_TILE;
        uint8_t* q_dst = qd_s + st * 2 * T::Q_BYTES;
        uint8_t* do_dst = q_dst + T::Q_BYTES;
        float* lse_dst = stat_s + st * T::STAT_FLOATS;
        sm90::mbar_arrive_expect_tx(&full[st], T::STAGE_TX);
#pragma unroll
        for (int c = 0; c < T::CHUNKS; ++c) {
          sm90::tma_load_4d(q_dst + c * Q_TILE * ROW_BYTES, &tm_q, &full[st], c * CHUNK, h,
                            m0, b);
          sm90::tma_load_4d(do_dst + c * Q_TILE * ROW_BYTES, &tm_do, &full[st], c * CHUNK,
                            h, m0, b);
        }
        const int stat0 = ((b * Hq + h) * Sq + m0) & ~3;
        sm90::tma_load_1d(lse_dst, &tm_lse, &full[st], stat0);
        sm90::tma_load_1d(lse_dst + T::STAT_SLOT, &tm_dlt, &full[st], stat0);
        if (++mt == n_m) {
          mt = 0;
          ++gi;
        }
      }
    }
  } else if constexpr (T::SPLIT_ROLES) {
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    dkv_split_consumer<HD, OutT>(k_s, v_s, qd_s, stat_s, p_s, full, empty, kv_full, dk, dv,
                                 dks, dvs, n0, m_lo, n_m, total, b, hk, Sq, Skv, Hq, group,
                                 q_off, kv_off, causal, window, scale, scale_log2, wg - 1);
  } else {
    // ------------------------------------------------------ consumers
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;  // owns keys n0 + cw * 64 .. + 63 of the block
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // fragment row group
    const int t = lane % 4;  // thread within the group
    const int nc = n0 + cw * WG_ROWS;  // this warpgroup's first key
    const int kr_a = warp * 16 + g;    // this thread's keys: nc + kr_a and 8 below
    const int kmin = kv_off + nc;
    const int kmax = kv_off + min(nc + WG_ROWS, Skv) - 1;
    const uint32_t k_base = sm90::smem_addr(k_s) + cw * WG_ROWS * ROW_BYTES;
    const uint32_t v_base = sm90::smem_addr(v_s) + cw * WG_ROWS * ROW_BYTES;

    float dk_acc[HD / 2];
    float dv_acc[HD / 2];
    zero(dk_acc);
    zero(dv_acc);
    if (total > 0) sm90::mbar_wait(kv_full, 0);

    int gi = 0;
    int mt = 0;
    for (int i = 0; i < total; ++i) {
      const int st = i % T::STAGES;
      const int m0 = m_lo + mt * Q_TILE;
      // the tile's statistics start this far into the stage's boxes
      const int shift = ((b * Hq + hk * group + gi) * Sq) & 3;
      if (++mt == n_m) {
        mt = 0;
        ++gi;
      }
      sm90::mbar_wait(&full[st], (i / T::STAGES) & 1);
      const int qmin = q_off + m0;
      const int qmax = q_off + min(m0 + Q_TILE, Sq) - 1;
      // No visible pair between this warpgroup's keys and the tile's rows.
      const bool none =
          nc >= Skv || (causal && (kmin > qmax || (window > 0 && qmin - kmax >= window)));
      if (!none) {
        const bool inside =
            m0 + Q_TILE <= Sq && nc + WG_ROWS <= Skv &&
            (!causal || (kv_off + nc + WG_ROWS - 1 <= qmin &&
                         (window <= 0 || qmin + Q_TILE - 1 - kmin < window)));
        const uint32_t q_addr = sm90::smem_addr(qd_s + st * 2 * T::Q_BYTES);
        const uint32_t do_addr = q_addr + T::Q_BYTES;
        const float* lse_s = stat_s + st * T::STAT_FLOATS + shift;
        const float* dlt_s = lse_s + T::STAT_SLOT;

        float s[Q_TILE / 2];   // S^T, then P^T
        float dp[Q_TILE / 2];  // dP^T, then dS^T
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        sm90::wgmma_fence();
        issue_abt<HD, Q_TILE, KV_BLOCK>(s, k_base, q_addr);   // S^T = K Q^T
        issue_abt<HD, Q_TILE, KV_BLOCK>(dp, v_base, do_addr); // dP^T = V dO^T
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);

        // P^T = 2^(S^T * scale * log2e - lse[col] * log2e): row r of the
        // fragment is a key, column c a query row of the tile.
#pragma unroll
        for (int j = 0; j < Q_TILE / 8; ++j) {
          const int c0 = 8 * j + 2 * t;
          const float bias[2] = {row_bias(lse_s[c0]), row_bias(lse_s[c0 + 1])};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = 4 * j + e;
            float p = fast_exp2(fmaf(s[idx], scale_log2, bias[e & 1]));
            if (!inside) {
              const int col = m0 + c0 + (e & 1);
              const int key = nc + kr_a + ((e < 2) ? 0 : 8);
              const int qpos = q_off + col;
              const int kpos = kv_off + key;
              bool ok = col < Sq && key < Skv;
              if (causal) {
                ok = ok && kpos <= qpos;
                if (window > 0) ok = ok && qpos - kpos < window;
              }
              if (!ok) p = 0.f;
            }
            s[idx] = p;
          }
        }
        uint32_t pa[Q_TILE / 16][4];
        pack_a<Q_TILE>(s, pa);
        fence_frags(pa);
        sm90::fence_regs(dv_acc);
        sm90::wgmma_fence();
        issue_ax<HD, Q_TILE / 16, Q_TILE>(dv_acc, pa, do_addr);  // dV += P^T dO
        sm90::wgmma_wait<1>();  // dP^T has retired; dV may still run
        sm90::fence_regs(dp);

        // dS^T = P^T * (dP^T - delta[col]) * scale
#pragma unroll
        for (int j = 0; j < Q_TILE / 8; ++j) {
          const float d[2] = {dlt_s[8 * j + 2 * t], dlt_s[8 * j + 2 * t + 1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = 4 * j + e;
            dp[idx] = s[idx] * (dp[idx] - d[e & 1]) * scale;
          }
        }
        uint32_t da[Q_TILE / 16][4];
        pack_a<Q_TILE>(dp, da);
        fence_frags(da);
        sm90::fence_regs(dk_acc);
        sm90::wgmma_fence();
        issue_ax<HD, Q_TILE / 16, Q_TILE>(dk_acc, da, q_addr);  // dK += dS^T Q
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dk_acc);
        sm90::fence_regs(dv_acc);
        fence_frags(pa);
        fence_frags(da);
      }
      release(&empty[st], lane);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = nc + kr_a + 8 * r;
      if (key >= Skv) continue;
      OutT* krow = dk + b * dks.b + key * dks.s + hk * dks.h;
      OutT* vrow = dv + b * dvs.b + key * dvs.s + hk * dvs.h;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        store_pair(krow + 8 * j + 2 * t, dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
        store_pair(vrow + 8 * j + 2 * t, dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------- dQ

template <int HD, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                const float* __restrict__ delta, OutT* __restrict__ dq, Strides dqs,
                int Sq, int Skv, int Hq, int group, int q_off, int kv_off, int causal,
                int window, float scale, float scale_log2) {
  using T = DqTiles<HD>;
  constexpr int BN = T::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* do_s = q_s + T::Q_BYTES;
  uint8_t* kv_s = do_s + T::Q_BYTES;  // stage s: K at s * STAGE_BYTES, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + T::STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + T::STAGES;
  uint64_t* q_full = empty + T::STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q_tile = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = q_tile * DQ_ROWS;
  const int hk = h / group;

  // Key range [n_lo, n_hi) any row of this tile can see: the causal
  // frontier of its last real row and the window edge of its first.
  const int q_last = min(q0 + DQ_ROWS, Sq) - 1;
  int n_lo = 0;
  int n_hi = Skv;
  if (causal) {
    n_hi = min(Skv, q_off + q_last - kv_off + 1);
    if (window > 0) n_lo = max(0, q_off + q0 - window + 1 - kv_off);
  }
  n_lo = (n_lo / BN) * BN;
  const int n_tiles = n_hi > n_lo ? (n_hi - n_lo + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    sm90::mbar_init(q_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ------------------------------------------------------- producer
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      sm90::prefetch_tensormap(&tm_k);
      sm90::prefetch_tensormap(&tm_v);
      sm90::mbar_arrive_expect_tx(q_full, 2 * T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::CHUNKS; ++c) {
        sm90::tma_load_4d(q_s + c * DQ_ROWS * ROW_BYTES, &tm_q, q_full, c * CHUNK, h, q0, b);
        sm90::tma_load_4d(do_s + c * DQ_ROWS * ROW_BYTES, &tm_do, q_full, c * CHUNK, h, q0,
                          b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % T::STAGES;
        if (i >= T::STAGES) sm90::mbar_wait(&empty[st], ((i / T::STAGES) - 1) & 1);
        uint8_t* k_dst = kv_s + st * T::STAGE_BYTES;
        uint8_t* v_dst = k_dst + T::KV_BYTES;
        const int n0 = n_lo + i * BN;
        sm90::mbar_arrive_expect_tx(&full[st], T::STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < T::CHUNKS; ++c) {
          sm90::tma_load_4d(k_dst + c * BN * ROW_BYTES, &tm_k, &full[st], c * CHUNK, hk, n0,
                            b);
          sm90::tma_load_4d(v_dst + c * BN * ROW_BYTES, &tm_v, &full[st], c * CHUNK, hk, n0,
                            b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;  // owns rows cw * 64 .. cw * 64 + 63 of the tile
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int row0 = q0 + cw * WG_ROWS;  // first query row of this warpgroup
    const int r_a = warp * 16 + g;       // this thread's rows: r_a and r_a + 8
    const int qpos0 = q_off + row0;
    const int qpos_a = qpos0 + r_a;
    const int qmax = q_off + min(row0 + WG_ROWS, Sq) - 1;
    const uint32_t q_base = sm90::smem_addr(q_s) + cw * WG_ROWS * ROW_BYTES;
    const uint32_t do_base = sm90::smem_addr(do_s) + cw * WG_ROWS * ROW_BYTES;
    const uint32_t kv_base = sm90::smem_addr(kv_s);

    // This thread's rows' statistics; a row past Sq takes a -inf bias,
    // so it contributes nothing (its Q and dO rows arrive as zeros).
    float bias[2];
    float dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r_a + 8 * r;
      const long long at = (static_cast<long long>(b) * Hq + h) * Sq + row;
      bias[r] = row < Sq ? row_bias(lse[at]) : -INFINITY;
      dlt[r] = row < Sq ? delta[at] : 0.f;
    }

    float dq_acc[HD / 2];
    zero(dq_acc);
    if (n_tiles > 0) sm90::mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % T::STAGES;
      const int n0 = n_lo + i * BN;
      sm90::mbar_wait(&full[st], (i / T::STAGES) & 1);
      const int kmin = kv_off + n0;
      const int kmax = kv_off + min(n0 + BN, Skv) - 1;
      const bool none =
          row0 >= Sq || (causal && (kmin > qmax || (window > 0 && qpos0 - kmax >= window)));
      if (!none) {
        const bool inside =
            n0 + BN <= Skv &&
            (!causal || (kv_off + n0 + BN - 1 <= qpos0 &&
                         (window <= 0 || qpos0 + WG_ROWS - 1 - kmin < window)));
        const uint32_t k_addr = kv_base + st * T::STAGE_BYTES;
        const uint32_t v_addr = k_addr + T::KV_BYTES;

        float s[BN / 2];   // S, then P
        float dp[BN / 2];  // dP, then dS
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        sm90::wgmma_fence();
        issue_abt<HD, BN, DQ_ROWS>(s, q_base, k_addr);    // S = Q K^T
        issue_abt<HD, BN, DQ_ROWS>(dp, do_base, v_addr);  // dP = dO V^T
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);

        // P = 2^(S * scale * log2e - lse * log2e)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = 4 * j + e;
            float p = fast_exp2(fmaf(s[idx], scale_log2, bias[e >> 1]));
            if (!inside) {
              const int col = n0 + 8 * j + 2 * t + (e & 1);
              const int qpos = qpos_a + ((e < 2) ? 0 : 8);
              const int kpos = kv_off + col;
              bool ok = col < Skv;
              if (causal) {
                ok = ok && kpos <= qpos;
                if (window > 0) ok = ok && qpos - kpos < window;
              }
              if (!ok) p = 0.f;
            }
            s[idx] = p;
          }
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dp);

        // dS = P * (dP - delta) * scale, as A fragments of dQ += dS K
#pragma unroll
        for (int idx = 0; idx < BN / 2; ++idx) {
          dp[idx] = s[idx] * (dp[idx] - dlt[(idx >> 1) & 1]) * scale;
        }
        uint32_t da[BN / 16][4];
        pack_a<BN>(dp, da);
        fence_frags(da);
        sm90::fence_regs(dq_acc);
        sm90::wgmma_fence();
        issue_ax<HD, BN / 16, BN>(dq_acc, da, k_addr);  // dQ += dS K
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq_acc);
        fence_frags(da);
      }
      release(&empty[st], lane);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r_a + 8 * r;
      if (row >= Sq) continue;
      OutT* orow = dq + b * dqs.b + row * dqs.s + h * dqs.h;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        store_pair(orow + 8 * j + 2 * t, dq_acc[4 * j + 2 * r], dq_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ launchers

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// A bf16 [B, S, H, HD] operand's tensor map from its (b, s, h) strides.
template <int HD>
bool operand_map(CUtensorMap* map, const void* base, int h, int s, int b,
                 const long long* st, int i, int box_rows) {
  return sm90::make_tmap_bf16_4d(map, base, HD, h, s, b, st[3 * i + 2], st[3 * i + 1],
                                 st[3 * i], box_rows);
}

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD, typename OutT>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dO,
                      const void* lse, const void* delta, void* dq, int B, int Sq,
                      int Skv, int Hq, int Hkv, const long long* st, int q_off,
                      int kv_off, int causal, int window, float scale,
                      cudaStream_t stream) {
  using T = DqTiles<HD>;
  const int n_qtiles = (Sq + DQ_ROWS - 1) / DQ_ROWS;
  if (n_qtiles > 65535 || B > 65535) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!operand_map<HD>(&tm_q, q, Hq, Sq, B, st, 0, DQ_ROWS) ||
      !operand_map<HD>(&tm_k, k, Hkv, Skv, B, st, 1, T::BN) ||
      !operand_map<HD>(&tm_v, v, Hkv, Skv, B, st, 2, T::BN) ||
      !operand_map<HD>(&tm_do, dO, Hq, Sq, B, st, 3, DQ_ROWS)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = opt_in_smem(flash_dq_kernel<HD, OutT>, T::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, n_qtiles);
  flash_dq_kernel<HD, OutT><<<grid, THREADS, T::SMEM_BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<OutT*>(dq), strides_at(st, 4), Sq, Skv,
      Hq, Hq / Hkv, q_off, kv_off, causal, window, scale, scale * LOG2E);
  return cudaGetLastError();
}

template <int HD, typename OutT>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dO,
                       const void* lse, const void* delta, void* dk, void* dv, int B,
                       int Sq, int Skv, int Hq, int Hkv, const long long* st, int q_off,
                       int kv_off, int causal, int window, float scale,
                       cudaStream_t stream) {
  using T = DkvTiles<HD>;
  constexpr int KV_BLOCK = T::KV_BLOCK;
  const int n_ktiles = (Skv + KV_BLOCK - 1) / KV_BLOCK;
  const long long n_stats = static_cast<long long>(B) * Hq * Sq;
  if (n_ktiles > 65535 || B > 65535 || n_stats > INT32_MAX) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_lse, tm_dlt;
  if (!operand_map<HD>(&tm_q, q, Hq, Sq, B, st, 0, Q_TILE) ||
      !operand_map<HD>(&tm_k, k, Hkv, Skv, B, st, 1, KV_BLOCK) ||
      !operand_map<HD>(&tm_v, v, Hkv, Skv, B, st, 2, KV_BLOCK) ||
      !operand_map<HD>(&tm_do, dO, Hq, Sq, B, st, 3, Q_TILE) ||
      !sm90::make_tmap_f32_1d(&tm_lse, lse, n_stats, T::STAT_BOX) ||
      !sm90::make_tmap_f32_1d(&tm_dlt, delta, n_stats, T::STAT_BOX)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = opt_in_smem(flash_dkv_kernel<HD, OutT>, T::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B, n_ktiles);
  flash_dkv_kernel<HD, OutT><<<grid, THREADS, T::SMEM_BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_lse, tm_dlt, static_cast<OutT*>(dk),
      static_cast<OutT*>(dv), strides_at(st, 4), strides_at(st, 5), Sq, Skv, Hq, Hq / Hkv,
      q_off, kv_off, causal, window, scale, scale * LOG2E);
  return cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Skv, int Hq, int Hkv) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0;
}

}  // namespace

// Shared contract of both launchers. q, dO [B, Sq, Hq, HD] and k, v
// [B, Skv, Hkv, HD] bf16 with unit stride on the last dim, 16-byte
// aligned bases and (b, s, h) strides in multiples of 8 elements (the TMA
// maps read them as they are); lse, delta [B, Hq, Sq] f32 contiguous with
// 16-byte aligned bases; outputs in f32 when out_f32 != 0, else bf16,
// with unit stride on the last dim. `strides` holds (b, s, h) element
// strides, in argument order: q, k, v, dO, then the outputs. window <= 0
// means no window. Each returns a cudaError_t.

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NOS_DQ(HD, T)                                                        \
  launch_dq<HD, T>(q, k, v, dO, lse, delta, dq, B, Sq, Skv, Hq, Hkv,         \
                   strides, q_off, kv_off, causal, window, scale, s)
  switch (head_dim) {
    case 64:
      return static_cast<int>(out_f32 ? NOS_DQ(64, float) : NOS_DQ(64, bf16));
    case 128:
      return static_cast<int>(out_f32 ? NOS_DQ(128, float) : NOS_DQ(128, bf16));
    case 256:
      return static_cast<int>(out_f32 ? NOS_DQ(256, float) : NOS_DQ(256, bf16));
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
    case 256:
      return static_cast<int>(out_f32 ? NOS_DKV(256, float)
                                      : NOS_DKV(256, bf16));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NOS_DKV
}
